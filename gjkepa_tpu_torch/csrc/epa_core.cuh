// The EPA capacity cascade for one lane, templated on its support map.
//
// Ports _epa_phase_fast (gjkepa_tpu/ops/fused.py:456-749) and _epa_cascade
// (:837-873).  Plain PyTorch version: epa_phase and run_cascade in
// gjkepa_tpu_torch/ops/fused_epa.py.  K10 (epa_hull_shape.cu) instantiates
// it with the hull-vs-shape support.  K2 (epa_hulls.cu), K7 (epa_shapes.cu)
// and K13 (epa_hulls_big.cu) run epa_warp.cuh's epa_tier_warp instead: the
// same arithmetic (plane_of, write_face) with each face scan split across a
// warp, the polytope in shared memory where it fits.
//
// A lane runs the tiers (F, K) in sequence from the GJK simplex, each later
// tier only if the previous one stopped for capacity.  Polytope state, per
// face: 9 corner coordinates, 3 vertex ids, the plane (n, d) and an alive
// word: 17 words, 14 KB a lane at F=208, too much for registers.  It lives
// in a global scratch buffer laid out [field][face][lane] (lane-minor), so a
// warp's accesses to one face of one field coalesce.  Per-lane compaction of
// the visible faces (at most K), the horizon match among their 3K edges by
// undirected vertex key, and the assignment of horizon edges to free face
// slots are sequential loops in the thread, in the order the JAX kernel's
// one-hot contractions and prefix counts define: new faces take free slots
// in ascending index, horizon edges come edge-major (the 3 edges, then the K
// compact slots).  That order decides which face the argmin finds first on
// ties.
#pragma once

#include "lane_geom.cuh"

namespace gjkepa {

constexpr int kKMax = 16;
constexpr int kMaxTiers = 4;
constexpr int kMaxId = 256;  // vertex ids < 4 + epa_max_iters < 256
constexpr float kBig = 3.4e38f;

enum Field { AX, AY, AZ, BX, BY, BZ, CX, CY, CZ, I0, I1, I2, NX, NY, NZ, DD, ALIVE, kFields };

// alive word: 0 dead, 1 alive, 2 alive and visible from the current probe
constexpr float kDead = 0.0f, kAlive = 1.0f, kVisible = 2.0f;

struct Tiers {
  int n;
  int faces[kMaxTiers];
  int kvis[kMaxTiers];
};

struct EpaParams {
  float eps;      // eps_coincide
  float epz;      // eps_zero
  int max_iters;  // epa_max_iters
};

// One lane's view of the [field][face][lane] scratch buffer.
struct Faces {
  float* base;
  size_t field_stride;  // f_max * B
  int B;
  __device__ __forceinline__ float& at(int field, int f) const {
    return base[field * field_stride + (size_t)f * B];
  }
};

struct Plane {
  float nx, ny, nz, d;
};

// Unit outward normal (vs `interior`) and origin distance; d = kBig when
// the triangle is degenerate.  Same operation order as _plane_of.
__device__ __forceinline__ Plane plane_of(P3 a, P3 b, P3 c, P3 interior, float epz) {
  float e1x = b.x - a.x, e1y = b.y - a.y, e1z = b.z - a.z;
  float e2x = c.x - a.x, e2y = c.y - a.y, e2z = c.z - a.z;
  float nx = e1y * e2z - e1z * e2y;
  float ny = e1z * e2x - e1x * e2z;
  float nz = e1x * e2y - e1y * e2x;
  float nrm = sqrtf(nx * nx + ny * ny + nz * nz);
  bool ok = nrm > epz;
  float inv = 1.0f / (ok ? nrm : 1.0f);
  nx = nx * inv;
  ny = ny * inv;
  nz = nz * inv;
  bool out = (nx * (a.x - interior.x) + ny * (a.y - interior.y) + nz * (a.z - interior.z)) >= 0.0f;
  float sgn = out ? 1.0f : -1.0f;
  nx = nx * sgn;
  ny = ny * sgn;
  nz = nz * sgn;
  Plane p;
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  p.d = ok ? nx * a.x + ny * a.y + nz * a.z : kBig;
  return p;
}

template <class FaceSet>
__device__ __forceinline__ void write_face(const FaceSet& fs, int f, P3 a, P3 b, P3 c, int i0,
                                           int i1, int i2, P3 interior, float epz) {
  Plane p = plane_of(a, b, c, interior, epz);
  fs.at(AX, f) = a.x;
  fs.at(AY, f) = a.y;
  fs.at(AZ, f) = a.z;
  fs.at(BX, f) = b.x;
  fs.at(BY, f) = b.y;
  fs.at(BZ, f) = b.z;
  fs.at(CX, f) = c.x;
  fs.at(CY, f) = c.y;
  fs.at(CZ, f) = c.z;
  fs.at(I0, f) = (float)i0;
  fs.at(I1, f) = (float)i1;
  fs.at(I2, f) = (float)i2;
  fs.at(NX, f) = p.nx;
  fs.at(NY, f) = p.ny;
  fs.at(NZ, f) = p.nz;
  fs.at(DD, f) = p.d;
  fs.at(ALIVE, f) = kAlive;
}

struct TierOut {
  float depth;
  P3 normal;
  int iters;
  int status;
};

// One tier of compact-visible EPA (_epa_phase_fast) for one lane.
template <class Support, class FaceSet>
__device__ TierOut epa_tier(const Support& support, const P3* s, P3 interior, int F, int K,
                            const FaceSet& fs, const EpaParams& prm) {
  const float eps = prm.eps, epz = prm.epz;
  // seed: the 4 simplex faces (ref :279-293)
  const int seed[4][3] = {{0, 1, 2}, {0, 2, 3}, {0, 1, 3}, {1, 2, 3}};
  for (int f = 0; f < 4; ++f) {
    write_face(fs, f, s[seed[f][0]], s[seed[f][1]], s[seed[f][2]], seed[f][0], seed[f][1],
               seed[f][2], interior, epz);
  }
  for (int f = 4; f < F; ++f) fs.at(ALIVE, f) = kDead;

  TierOut out;
  out.depth = 0.0f;
  out.normal = mk(0.0f, 0.0f, 0.0f);
  out.iters = 0;
  out.status = kHitEpaCap;
  int nv = 4;
  float scor[kKMax][9];  // compact visible faces: corner coordinates
  int sid[kKMax][3];     //                        corner vertex ids
  int hor[3 * kKMax];    // horizon edges as e * K + k, edge-major

  while (out.iters < prm.max_iters) {
    // -- min face (first minimum over alive faces) / probe direction --------
    float d_min = fs.at(ALIVE, 0) != kDead ? fs.at(DD, 0) : kBig;
    int kmin = 0;
    for (int f = 1; f < F; ++f) {
      float dv = fs.at(ALIVE, f) != kDead ? fs.at(DD, f) : kBig;
      if (dv < d_min) {
        d_min = dv;
        kmin = f;
      }
    }
    const bool all_deg = d_min >= kBig * 0.5f;
    if (all_deg) d_min = 0.0f;
    P3 dir = all_deg ? mk(0.0f, 0.0f, 0.0f)
                     : mk(fs.at(NX, kmin), fs.at(NY, kmin), fs.at(NZ, kmin));

    P3 w = support(dir);
    float gain = dot(w, dir) - d_min;
    bool dup = false;
    for (int f = 0; f < F && !dup; ++f) {
      if (fs.at(ALIVE, f) == kDead) continue;
      for (int c = 0; c < 3; ++c) {
        P3 q = mk(fs.at(AX + 3 * c, f), fs.at(AY + 3 * c, f), fs.at(AZ + 3 * c, f));
        if (coincide(q, w, eps)) dup = true;
      }
    }
    ++out.iters;
    out.depth = d_min;
    out.normal = dir;
    if (gain < eps || dup) {
      out.status = kHit;
      return out;
    }

    // -- visible set; compact the first K visible faces ---------------------
    int nvis = 0;
    for (int f = 0; f < F; ++f) {
      if (fs.at(ALIVE, f) == kDead) continue;
      float dd = fs.at(DD, f);
      bool star = f == kmin;
      bool beyond = (fs.at(NX, f) * w.x + fs.at(NY, f) * w.y + fs.at(NZ, f) * w.z) > dd + epz;
      bool vis = ((beyond || star) && dd < kBig * 0.5f) || star;
      if (!vis) continue;
      fs.at(ALIVE, f) = kVisible;
      if (nvis < K) {
        for (int j = 0; j < 9; ++j) scor[nvis][j] = fs.at(AX + j, f);
        for (int j = 0; j < 3; ++j) sid[nvis][j] = (int)fs.at(I0 + j, f);
      }
      ++nvis;
    }
    if (nvis > K) {
      out.status = kHitEpaCapacity;
      return out;
    }

    // -- horizon: edges whose undirected key is unique among the 3*nvis -----
    int n_new = 0;
    for (int e = 0; e < 3; ++e) {
      for (int k = 0; k < nvis; ++k) {
        int u = sid[k][e], v = sid[k][(e + 1) % 3];
        int key = min(u, v) * kMaxId + max(u, v);
        int cnt = 0;
        for (int e2 = 0; e2 < 3; ++e2) {
          for (int k2 = 0; k2 < nvis; ++k2) {
            int u2 = sid[k2][e2], v2 = sid[k2][(e2 + 1) % 3];
            cnt += (min(u2, v2) * kMaxId + max(u2, v2)) == key;
          }
        }
        if (cnt == 1) hor[n_new++] = e * K + k;
      }
    }
    int n_free = 0;
    for (int f = 0; f < F; ++f) n_free += fs.at(ALIVE, f) != kAlive;
    if (n_new > n_free) {
      out.status = kHitEpaCapacity;
      return out;
    }
    if (n_new == 0 || all_deg) {
      out.status = kHitEpaDegenerate;
      return out;
    }

    // -- r-th free face (ascending index) <- r-th horizon edge --------------
    int r = 0;
    for (int f = 0; f < F; ++f) {
      if (fs.at(ALIVE, f) == kAlive) continue;
      if (r < n_new) {
        int e = hor[r] / K, k = hor[r] % K;
        int a = e, b = (e + 1) % 3;
        P3 pa = mk(scor[k][3 * a], scor[k][3 * a + 1], scor[k][3 * a + 2]);
        P3 pb = mk(scor[k][3 * b], scor[k][3 * b + 1], scor[k][3 * b + 2]);
        write_face(fs, f, pa, pb, w, sid[k][a], sid[k][b], nv, interior, epz);
        ++r;
      } else {
        fs.at(ALIVE, f) = kDead;  // visible and not reused
      }
    }
    ++nv;
  }
  return out;  // iteration cap: HIT_EPA_CAP
}

template <class Support, class FaceSet>
__device__ __forceinline__ TierOut epa_cascade(const Support& support, const P3* s,
                                               const Tiers& tiers, const FaceSet& fs,
                                               const EpaParams& prm) {
  const P3 interior = mean4(s);
  TierOut r = epa_tier(support, s, interior, tiers.faces[0], tiers.kvis[0], fs, prm);
  for (int t = 1; t < tiers.n && r.status == kHitEpaCapacity; ++t) {
    r = epa_tier(support, s, interior, tiers.faces[t], tiers.kvis[t], fs, prm);
  }
  return r;
}

// Host side: the tier ladder, checked.  Returns 0, or cudaErrorInvalidValue
// for a ladder the kernels do not hold.
inline int make_tiers(int n_tiers, const int* tier_faces, const int* tier_kvis, int f_max,
                      int epa_max_iters, Tiers* tiers) {
  if (n_tiers < 1 || n_tiers > kMaxTiers) return (int)cudaErrorInvalidValue;
  tiers->n = n_tiers;
  for (int t = 0; t < kMaxTiers; ++t) {
    tiers->faces[t] = t < n_tiers ? tier_faces[t] : 0;
    tiers->kvis[t] = t < n_tiers ? tier_kvis[t] : 0;
    if (t < n_tiers && (tiers->kvis[t] < 1 || tiers->kvis[t] > kKMax || tiers->faces[t] < 4 ||
                        tiers->faces[t] > f_max)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (4 + epa_max_iters >= kMaxId) return (int)cudaErrorInvalidValue;
  return 0;
}

inline EpaParams make_epa_params(float eps_coincide, float eps_zero, int epa_max_iters) {
  EpaParams prm;
  prm.eps = eps_coincide;
  prm.epz = eps_zero;
  prm.max_iters = epa_max_iters;
  return prm;
}

}  // namespace gjkepa
