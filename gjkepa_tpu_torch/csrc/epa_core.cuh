// The EPA tier's shared pieces: the tier ladder, the parameters, the face
// fields and the plane of a face.
//
// Ports the pieces of _epa_phase_fast (gjkepa_tpu/ops/fused.py:456-749) and
// _epa_cascade (:837-873) that every EPA kernel shares.  Plain PyTorch
// version: epa_phase and run_cascade in gjkepa_tpu_torch/ops/fused_epa.py.
// The tier itself is epa_warp.cuh's epa_tier_warp, one warp a pair with
// each face scan split across its 32 threads: K2 (epa_hulls.cu) and K13
// (epa_hulls_big.cu) over hull supports, K7 (epa_shapes.cu) and K10
// (epa_hull_shape.cu) through epa_polish_warp.cuh.
//
// Polytope state, per face: 9 corner coordinates, 3 vertex ids, the plane
// (n, d) and an alive word: 17 words (Field), 14 KB a pair at F=208.
// Horizon edges come edge-major (the 3 edges, then the K compact slots) and
// new faces take free slots in ascending index, the order the JAX kernel's
// one-hot contractions and prefix counts define: that order decides which
// face the first minimum finds on ties.
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
