// The GJK phase for one pair run by a quad of threads: the iteration's
// four faces split one a lane.
//
// Ports _gjk_phase (gjkepa_tpu/ops/fused.py:262-453), as gjk_core.cuh's
// gjk_phase does on one thread; every lane of the quad runs a copy of that
// init (quad_init) on the same values.  Plain PyTorch version: gjk_phase in
// gjkepa_tpu_torch/ops/fused_gjk.py; tests/test_torch_gjk_team.py holds a
// lane-by-lane transliteration of this split to it.  K6a (gjk_shapes.cu)
// instantiates it with the analytic-shape support.
//
// The four lanes of a quad (team_mask<4>, csrc/hull_stream.cuh) hold the
// same simplex in registers; lane f owns face f of the always-tetra table.
// One iteration:
//   - lane f orients its face's normal against the simplex mean and scores
//     it; the four scores reach every lane by shuffles, and every lane runs
//     the serial strict-> chain over them in face order, so the first
//     maximum wins and a NaN score 0 wins where the serial chain lets it;
//   - the chosen normal comes from its lane; every lane probes the support
//     along it (the same direction on every lane, as TeamHullSupport needs);
//   - the containment test of the new simplex (point_in_simplex) splits
//     over the same lanes: lane f builds face f (cross, norm, utz), tests
//     dist > 0 and, only near the plane, the triangle; on_face is
//     __any_sync over the quad and all_pos __all_sync, both order-free;
//   - the stall test, vertex f against the last two simplices' vertex f,
//     is __all_sync, so lane f keeps only its own vertex of those two.
// The status is the same on every lane, so the loop exits as one.
//
// Reuse.  The containment test's raw normal of face f, utz(cross(a - b,
// b - c)), is the next iteration's face-f normal before its orientation
// (the same expression on the same vertices), and mean4 of the new simplex
// is the next iteration's mean: each lane keeps both.  Only the unflipped
// normal carries over: the two orientation tests differ (vertex f against
// the face's first vertex).  flat_tri's cross, (ns1 - ns0) x (ns2 - ns1),
// is face 2's with both factors negated: every nonzero component is the
// same float and a zero one may differ only in sign, so its norm is face
// 2's norm, and coplanar4's plane normal (uninml, lane_geom.cuh) is face
// 2's cross times the same reciprocal; uninml keeps its own test (a
// component above eps_zero).  Lane 2 decides both and passes them on.  The
// kernels build with --fmad=false, so each reused value is the one the
// plain version computes.
//
// Every array is indexed by compile-time constants only (a face known at
// run time picks its vertices by selects), so the simplex stays in
// registers.
#pragma once

#include "gjk_core.cuh"
#include "hull_stream.cuh"

namespace gjkepa {

constexpr int kQuad = 4;

// Vertex `slot` of face f of the always-tetra table (face_idx).
__device__ __forceinline__ P3 face_v0(const P3 (&s)[4], int f) { return f == 3 ? s[1] : s[0]; }
__device__ __forceinline__ P3 face_v1(const P3 (&s)[4], int f) {
  return (f == 0 || f == 3) ? s[2] : s[1];
}
__device__ __forceinline__ P3 face_v2(const P3 (&s)[4], int f) { return f == 2 ? s[2] : s[3]; }

// s[f].
__device__ __forceinline__ P3 simplex_vertex(const P3 (&s)[4], int f) {
  return f == 0 ? s[0] : (f == 1 ? s[1] : (f == 2 ? s[2] : s[3]));
}

// Lane f's face f of a simplex: its cross product, the norm and the
// reciprocal of the norm, and the raw (unoriented) utz normal.
struct QuadFace {
  P3 cr, raw;
  float n, r;
};

// point_in_simplex(origin, s) split over the quad, m = mean4(s) (the same
// value on every lane); *face gets this lane's face.
__device__ __forceinline__ bool quad_contains(const P3 (&s)[4], P3 m, int f, unsigned mask,
                                              float eps, float epz, QuadFace* face) {
  const P3 zero = mk(0.0f, 0.0f, 0.0f);
  const P3 a = face_v0(s, f), b = face_v1(s, f), c = face_v2(s, f);
  face->cr = cross(sub(a, b), sub(b, c));
  face->n = norm(face->cr);
  face->r = 1.0f / face->n;
  // utz: the reciprocal where the norm is not small (the same division)
  face->raw = scale(face->cr, face->n < epz ? 0.0f : face->r);
  const P3 v = simplex_vertex(s, f);
  const P3 nml = dot(face->raw, sub(v, m)) < 0.0f ? neg(face->raw) : face->raw;
  const float dist = dot(sub(v, zero), nml);
  const bool on_face = fabsf(dist) < eps && is_inside_tri(a, b, c, zero, epz);
  return __any_sync(mask, on_face) || __all_sync(mask, dist > 0.0f);
}

// gjk_phase's v1-v4 init (ref :82-170), the same operations in the same
// order on every lane, into s and *sep_out, then the containment test of
// its simplex split over the quad (*m its mean, *face this lane's face);
// returns the status after the init.  A copy, so that the serial
// gjk_phase keeps its own build.
template <class Support>
__device__ __forceinline__ int quad_init(const Support& support, const InitDirs& dirs,
                                         const GjkParams& prm, unsigned mask, int f,
                                         P3 (&s)[4], float* sep_out, P3* m, QuadFace* face) {
  const float eps = prm.eps, epz = prm.epz;
  const P3 zero = mk(0.0f, 0.0f, 0.0f);
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
  *sep_out = sep;
  *m = mean4(s);
  bool in_tetra = quad_contains(s, *m, f, mask, eps, epz, face);

  int status = kRunning;
  if (in_tetra) status = kHit;
  if (v4_coplanar) status = kMissInit;
  if (early_hit) status = kHit;
  if (v3_degenerate) status = kMissInit;
  if (init_failed) status = kMissInit;
  return status;
}

// gjk_phase for the pair of the calling quad: every lane returns the same
// GjkOut.  All four lanes must call it with the same arguments.
template <class Support>
__device__ __forceinline__ GjkOut gjk_phase_quad(const Support& support, bool active,
                                                 const InitDirs& dirs, const GjkParams& prm) {
  const float eps = prm.eps, epz = prm.epz;
  const P3 zero = mk(0.0f, 0.0f, 0.0f);
  GjkOut out;
  for (int i = 0; i < 4; ++i) out.s[i] = zero;
  out.status = kMissBroadphase;
  out.iters = 0;
  out.sep = 0.0f;
  if (!active) return out;

  const unsigned mask = team_mask<kQuad>();
  const int f = threadIdx.x & (kQuad - 1);
  P3 s[4], m;
  float sep;
  QuadFace face;
  int status = quad_init(support, dirs, prm, mask, f, s, &sep, &m, &face);

  // --- iterate loop (ref :178-236) ----------------------------------------
  int it = 0;
  P3 l1 = zero, l2 = zero;  // vertex f of the last two simplices
  while (status == kRunning && it < prm.max_iters) {
    const P3 a = face_v0(s, f);
    const P3 nrm = dot(face.raw, sub(a, m)) < 0.0f ? neg(face.raw) : face.raw;
    const float score = -dot(nrm, a);
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = __shfl_sync(mask, score, j, kQuad);
    // MAXLOC (first max) as a strict-> chain
    int k = 0;
    float best = sc[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      if (sc[j] > best) {
        best = sc[j];
        k = j;
      }
    }
    const P3 d = mk(__shfl_sync(mask, nrm.x, k, kQuad), __shfl_sync(mask, nrm.y, k, kQuad),
                    __shfl_sync(mask, nrm.z, k, kQuad));
    const P3 w = support(d);
    sep = sep_upd(sep, d, w);
    const P3 ns[4] = {face_v0(s, k), face_v1(s, k), face_v2(s, k), w};

    const P3 mn = mean4(ns);
    const bool contains = quad_contains(ns, mn, f, mask, eps, epz, &face);
    // flat_tri and coplanar4 from face 2 of the new simplex, on lane 2
    const bool ok = fabsf(face.cr.x) > epz || fabsf(face.cr.y) > epz || fabsf(face.cr.z) > epz;
    const P3 unit = scale(face.cr, ok ? face.r : 0.0f);
    const int flags = (face.n < eps ? 1 : 0) |
                      (fabsf(dot(sub(ns[3], ns[0]), unit)) < eps ? 2 : 0);
    const int face2 = __shfl_sync(mask, flags, 2, kQuad);
    const P3 v = simplex_vertex(ns, f);
    const bool stalled = __all_sync(mask, coincide(v, l1, eps) || coincide(v, l2, eps));
    if (stalled) status = kMissGjk;
    if (contains) status = kHit;
    if (face2 & 2) status = kMissGjk;  // coplanar4
    if (face2 & 1) status = kMissGjk;  // flat_tri
    l2 = l1;
    l1 = simplex_vertex(s, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = ns[i];
    m = mn;
    ++it;
  }
  if (status == kRunning) status = kMissGjk;
#pragma unroll
  for (int i = 0; i < 4; ++i) out.s[i] = s[i];
  out.status = status;
  out.iters = it;
  out.sep = status == kHit ? 0.0f : fmaxf(sep, 0.0f);
  return out;
}

}  // namespace gjkepa
