// The GJK phase for one pair, templated on its support map.
//
// Ports _gjk_phase (gjkepa_tpu/ops/fused.py:262-453): the staged v1-v4 init
// over the first 8 direction-table rows and the always-tetra iterate loop,
// with the simplex in registers.  Plain PyTorch version: gjk_phase in
// gjkepa_tpu_torch/ops/fused_gjk.py.  K1 (gjk_hulls.cu) instantiates it with
// the hull support, K6b (gjk_shapes.cu) with the analytic-shape support (K6a
// runs a copy split over a quad of threads, gjk_quad.cuh);
// a support functor is `P3 operator()(P3 d) const`, the support point of the
// Minkowski difference A - B along d.
#pragma once

#include "lane_geom.cuh"

namespace gjkepa {

constexpr int kInitDirs = 8;
constexpr int kRunning = -1;

// The init directions travel by value in a kernel's parameter space, which
// the card keeps in constant memory.
struct InitDirs {
  float v[kInitDirs][3];
};

struct GjkParams {
  float eps;       // eps_coincide
  float epz;       // eps_zero
  float eps_sq;    // float32(eps_coincide**2), rounded once on the host
  float bp_tol;    // broadphase_tol
  int max_iters;   // gjk_max_iters
};

struct GjkOut {
  P3 s[4];      // final simplex (zeros on inactive lanes)
  int status;
  int iters;
  float sep;    // separation lower bound, 0 on hits and inactive lanes
};

__device__ __forceinline__ float sep_upd(float sep, P3 d, P3 w) {
  return fmaxf(sep, -dot(w, d));
}

template <class Support>
__device__ __forceinline__ GjkOut gjk_phase(const Support& support, bool active,
                                            const InitDirs& dirs, const GjkParams& prm) {
  const float eps = prm.eps, epz = prm.epz;
  const P3 zero = mk(0.0f, 0.0f, 0.0f);
  GjkOut out;
  for (int i = 0; i < 4; ++i) out.s[i] = zero;
  out.status = kMissBroadphase;
  out.iters = 0;
  out.sep = 0.0f;
  if (!active) return out;

  P3* s = out.s;
  float sep;
  // --- v1/v2 retry over the first kInitDirs table rows (ref :82-112) -----
  P3 d0 = mk(dirs.v[0][0], dirs.v[0][1], dirs.v[0][2]);
  P3 s1 = support(d0);
  P3 s2 = support(neg(d0));
  sep = sep_upd(sep_upd(0.0f, d0, s1), neg(d0), s2);
  for (int i = 1; i < kInitDirs && coincide(s1, s2, eps); ++i) {
    P3 d = mk(dirs.v[i][0], dirs.v[i][1], dirs.v[i][2]);
    s1 = support(d);
    s2 = support(neg(d));
    sep = sep_upd(sep_upd(sep, d, s1), neg(d), s2);
  }
  bool init_failed = coincide(s1, s2, eps);

  // --- v3 (ref :115-127) + origin-on-segment fix (fused.py:320-337) -------
  P3 d3 = vec_pl(zero, s1, s2, epz);
  P3 seg = sub(s2, s1);
  float segsq = dot(seg, seg);
  float t3 = -dot(s1, seg) / fmaxf(segsq, epz);
  P3 rej = mk(s1.x + t3 * seg.x, s1.y + t3 * seg.y, s1.z + t3 * seg.z);
  bool on_line = dot(rej, rej) <= prm.eps_sq * (1.0f + segsq);
  P3 alt = utz(cross(seg, d0), epz);
  if (!(dot(alt, alt) > 0.0f)) {
    alt = utz(cross(seg, mk(dirs.v[1][0], dirs.v[1][1], dirs.v[1][2])), epz);
  }
  if (!(dot(d3, d3) > 0.0f && !on_line)) d3 = alt;
  P3 s3 = support(d3);
  sep = sep_upd(sep, d3, s3);
  bool v3_degenerate = coincide(s3, s1, eps) || coincide(s3, s2, eps);

  // --- v4 + early-EPA checks (ref :130-170) -------------------------------
  P3 d4 = utz(cross(sub(s2, s1), sub(s3, s2)), epz);
  P3 vo = neg(s3);
  bool on_plane = fabsf(dot(vo, d4)) < eps;
  bool early_hit = on_plane && is_inside_tri(s1, s2, s3, zero, epz);
  P3 d4f = dot(vo, d4) < 0.0f ? neg(d4) : d4;
  P3 s4 = support(d4f);
  sep = sep_upd(sep, d4f, s4);
  bool v4_coplanar = fabsf(dist_pf_sign(s4, s1, s2, s3, epz)) < eps;
  if (early_hit) {
    // fresh support along the unflipped normal; the opposite side when
    // that one is coplanar (fused.py:353-363)
    P3 s4e = support(d4);
    bool cop = fabsf(dist_pf_sign(s4e, s1, s2, s3, epz)) < eps;
    s4 = cop ? support(neg(d4)) : s4e;
  }
  s[0] = s1;
  s[1] = s2;
  s[2] = s3;
  s[3] = s4;
  bool in_tetra = point_in_simplex(zero, s, eps, epz);

  int status = kRunning;
  if (in_tetra) status = kHit;
  if (v4_coplanar) status = kMissInit;
  if (early_hit) status = kHit;
  if (v3_degenerate) status = kMissInit;
  if (init_failed) status = kMissInit;

  // --- iterate loop (ref :178-236) ----------------------------------------
  int it = 0;
  P3 l1[4] = {zero, zero, zero, zero};
  P3 l2[4] = {zero, zero, zero, zero};
  while (status == kRunning && it < prm.max_iters) {
    P3 m = mean4(s);
    P3 normals[4];
    float scores[4];
    for (int i = 0; i < 4; ++i) {
      P3 a = s[face_idx(i, 0)], bb = s[face_idx(i, 1)], c = s[face_idx(i, 2)];
      P3 n = utz(cross(sub(a, bb), sub(bb, c)), epz);
      if (dot(n, sub(a, m)) < 0.0f) n = neg(n);
      normals[i] = n;
      scores[i] = -dot(n, a);
    }
    // MAXLOC (first max) as a strict-> chain
    int k = 0;
    float best = scores[0];
    for (int i = 1; i < 4; ++i) {
      if (scores[i] > best) {
        best = scores[i];
        k = i;
      }
    }
    P3 d = normals[k];
    P3 w = support(d);
    sep = sep_upd(sep, d, w);
    P3 ns[4] = {s[face_idx(k, 0)], s[face_idx(k, 1)], s[face_idx(k, 2)], w};

    bool flat_tri = norm(cross(sub(ns[1], ns[0]), sub(ns[2], ns[1]))) < eps;
    bool coplanar4 = fabsf(dist_pf_sign(ns[3], ns[0], ns[1], ns[2], epz)) < eps;
    bool contains = point_in_simplex(zero, ns, eps, epz);
    bool stalled = true;
    for (int i = 0; i < 4; ++i) {
      stalled = stalled && (coincide(ns[i], l1[i], eps) || coincide(ns[i], l2[i], eps));
    }
    if (stalled) status = kMissGjk;
    if (contains) status = kHit;
    if (coplanar4) status = kMissGjk;
    if (flat_tri) status = kMissGjk;
    for (int i = 0; i < 4; ++i) {
      l2[i] = l1[i];
      l1[i] = s[i];
      s[i] = ns[i];
    }
    ++it;
  }
  if (status == kRunning) status = kMissGjk;
  out.status = status;
  out.iters = it;
  out.sep = status == kHit ? 0.0f : fmaxf(sep, 0.0f);
  return out;
}

// Host side: copy the first kInitDirs rows of a row-major (N, 3) table.
inline InitDirs make_init_dirs(const float* table) {
  InitDirs dirs;
  for (int i = 0; i < kInitDirs; ++i) {
    for (int k = 0; k < 3; ++k) dirs.v[i][k] = table[3 * i + k];
  }
  return dirs;
}

inline GjkParams make_gjk_params(float eps_coincide, float eps_zero, float eps_sq,
                                 float broadphase_tol, int gjk_max_iters) {
  GjkParams prm;
  prm.eps = eps_coincide;
  prm.epz = eps_zero;
  prm.eps_sq = eps_sq;
  prm.bp_tol = broadphase_tol;
  prm.max_iters = gjk_max_iters;
  return prm;
}

}  // namespace gjkepa
