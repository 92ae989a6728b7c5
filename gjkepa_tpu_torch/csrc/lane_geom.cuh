// Per-thread geometry shared by every kernel of the port (csrc/*.cu).
//
// Scalar twin of gjkepa_tpu_torch/ops/lane_geom.py, which ports the
// lane-vectorised geometry of gjkepa_tpu/ops/fused.py:69-235.  Every
// expression keeps the operation order of the Python versions: the kernels
// are built with --fmad=false, so each product and sum rounds on its own as
// in the plain PyTorch version, and the discrete verdicts (hit, status,
// iteration counts) agree with it bit for bit on well-conditioned lanes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gjkepa {

// Status codes (gjkepa_tpu_torch/types.py).
constexpr int kMissBroadphase = 0;
constexpr int kMissInit = 1;
constexpr int kMissGjk = 2;
constexpr int kHit = 3;
constexpr int kHitEpaCap = 4;
constexpr int kHitEpaDegenerate = 5;
constexpr int kHitEpaCapacity = 6;

struct P3 {
  float x, y, z;
};

__device__ __forceinline__ P3 mk(float x, float y, float z) {
  P3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

__device__ __forceinline__ P3 add(P3 a, P3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ P3 sub(P3 a, P3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ P3 neg(P3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ P3 scale(P3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(P3 a, P3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ P3 cross(P3 a, P3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float norm(P3 a) { return sqrtf(dot(a, a)); }

// utzvec: zero vector if norm < eps (ref :1343-1352).
__device__ __forceinline__ P3 utz(P3 a, float eps) {
  float n = norm(a);
  bool small = n < eps;
  float s = small ? 0.0f : 1.0f / (small ? 1.0f : n);
  return scale(a, s);
}

// ALL(|a-b| < eps): the reference's vertex-coincidence test.
__device__ __forceinline__ bool coincide(P3 a, P3 b, float eps) {
  return fabsf(a.x - b.x) < eps && fabsf(a.y - b.y) < eps && fabsf(a.z - b.z) < eps;
}

__device__ __forceinline__ P3 mean4(const P3* s) {
  return mk((s[0].x + s[1].x + s[2].x + s[3].x) * 0.25f,
            (s[0].y + s[1].y + s[2].y + s[3].y) * 0.25f,
            (s[0].z + s[1].z + s[2].z + s[3].z) * 0.25f);
}

// UNINML (ref :1382-1394): plane unit normal, zero when degenerate.
__device__ __forceinline__ P3 uninml(P3 a, P3 b, P3 c, float eps_zero) {
  P3 cr = cross(sub(b, a), sub(c, b));
  bool ok = fabsf(cr.x) > eps_zero || fabsf(cr.y) > eps_zero || fabsf(cr.z) > eps_zero;
  float n = norm(cr);
  float s = ok ? 1.0f / (ok ? n : 1.0f) : 0.0f;
  return scale(cr, s);
}

__device__ __forceinline__ float dist_pf_sign(P3 p, P3 a, P3 b, P3 c, float eps_zero) {
  return dot(sub(p, a), uninml(a, b, c, eps_zero));
}

// z-component of (B-A) x (P-A) for one polygon edge.
__device__ __forceinline__ float tri_edge_cross(float ax, float ay, float bx, float by,
                                                float px, float py) {
  return (bx - ax) * (py - ay) - (by - ay) * (px - ax);
}

// IS_INSIDE_PF for a triangle (ref :1271-1337): XOY crosses clamped at
// eps_zero, the all-nonpositive fall-through to XOZ, sign flip vs the first.
__device__ __forceinline__ bool is_inside_tri(P3 a, P3 b, P3 c, P3 p, float eps_zero) {
  float c0 = tri_edge_cross(a.x, a.y, b.x, b.y, p.x, p.y);
  float c1 = tri_edge_cross(b.x, b.y, c.x, c.y, p.x, p.y);
  float c2 = tri_edge_cross(c.x, c.y, a.x, a.y, p.x, p.y);
  if (fabsf(c0) < eps_zero) c0 = 0.0f;
  if (fabsf(c1) < eps_zero) c1 = 0.0f;
  if (fabsf(c2) < eps_zero) c2 = 0.0f;
  bool use_xz = !(c0 > 1e-15f || c1 > 1e-15f || c2 > 1e-15f);
  if (use_xz) {
    c0 = tri_edge_cross(a.x, a.z, b.x, b.z, p.x, p.z);
    c1 = tri_edge_cross(b.x, b.z, c.x, c.z, p.x, p.z);
    c2 = tri_edge_cross(c.x, c.z, a.x, a.z, p.x, p.z);
  }
  bool outside = (c0 * c1 < 0.0f) || (c0 * c2 < 0.0f);
  return !outside;
}

// The always-tetra face table (ref :1093-1118, :1227-1229).
// Faces ((0, 2, 3), (0, 1, 3), (0, 1, 2), (1, 2, 3)).
__device__ __forceinline__ int face_idx(int face, int slot) {
  if (face == 3) return slot + 1;
  if (slot == 0) return 0;
  if (slot == 2) return face == 2 ? 2 : 3;
  return face == 0 ? 2 : 1;
}

// isPointInSimplex (ref :1217-1265): strictly inside the four oriented face
// planes, or on a face plane and inside that face's triangle.
__device__ __forceinline__ bool point_in_simplex(P3 p, const P3* s, float eps_coincide,
                                                 float eps_zero) {
  P3 m = mean4(s);
  bool all_pos = true;
  bool on_face = false;
  for (int i = 0; i < 4; ++i) {
    P3 a = s[face_idx(i, 0)], b = s[face_idx(i, 1)], c = s[face_idx(i, 2)];
    P3 nml = utz(cross(sub(a, b), sub(b, c)), eps_zero);
    if (dot(nml, sub(s[i], m)) < 0.0f) nml = neg(nml);
    float dist = dot(sub(s[i], p), nml);
    if (fabsf(dist) < eps_coincide && is_inside_tri(a, b, c, p, eps_zero)) on_face = true;
    all_pos = all_pos && dist > 0.0f;
  }
  return on_face || all_pos;
}

// VEC_PL (ref :1423-1440): unit vector from p toward its foot on line ab.
__device__ __forceinline__ P3 vec_pl(P3 p, P3 a, P3 b, float eps_zero) {
  P3 ab = sub(b, a);
  float n = norm(ab);
  float safe = n < eps_zero ? 1.0f : n;
  float t = dot(sub(p, a), ab) / safe;
  P3 foot = add(a, scale(ab, t / safe));
  return utz(sub(foot, p), eps_zero);
}

__device__ __forceinline__ P3 vertex(const float* __restrict__ v, int i) {
  return mk(v[3 * i], v[3 * i + 1], v[3 * i + 2]);
}

}  // namespace gjkepa
