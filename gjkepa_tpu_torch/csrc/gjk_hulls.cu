// K1: broadphase + GJK over hull pairs, one thread per pair.
//
// Replaces the TPU kernel _gjk_kernel_hulls (gjkepa_tpu/ops/fused.py:1099,
// with _hull_broadphase :876, _make_hull_support :237 and _gjk_phase
// :262-453).  Plain PyTorch version: gjk_hulls_plain in
// gjkepa_tpu_torch/ops/fused_gjk.py.
//
// Each thread reads its two hulls from (B, N, 3) row-major global memory,
// runs the bounding-sphere broadphase, the staged v1-v4 init over the first
// 8 direction-table rows and the always-tetra GJK loop with the simplex in
// registers, and writes hit, status, iterations, the separation lower bound
// and the 4x3 simplex.
//
// What bounds it: every support probe scans both hulls, 24*N bytes per pair,
// and neighbouring threads read addresses 12*N bytes apart, so a warp's loads
// do not coalesce; iteration counts differ between pairs, so warps diverge.
// The kernel is bandwidth- and divergence-bound.  Coalescing the vertex
// reads across a warp (or a warp per pair sharing the argmax) is later work;
// this first form is the plain per-pair loop, kept simple and exact.
#include "lane_geom.cuh"

namespace gjkepa {
namespace {

constexpr int kInitDirs = 8;
constexpr int kRunning = -1;
constexpr int kThreads = 128;

// The init directions travel by value in the kernel's parameter space,
// which the card keeps in constant memory.
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

__device__ __forceinline__ float sep_upd(float sep, P3 d, P3 w) {
  return fmaxf(sep, -dot(w, d));
}

// Centroid (sum / n, vertex order) and max radius of one hull.
__device__ void bounding_sphere(const float* __restrict__ v, int n, P3* c, float* r) {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int i = 0; i < n; ++i) {
    sx += v[3 * i];
    sy += v[3 * i + 1];
    sz += v[3 * i + 2];
  }
  float fn = (float)n;
  *c = mk(sx / fn, sy / fn, sz / fn);
  float rr = 0.0f;
  for (int i = 0; i < n; ++i) {
    float dx = v[3 * i] - c->x, dy = v[3 * i + 1] - c->y, dz = v[3 * i + 2] - c->z;
    rr = fmaxf(rr, sqrtf(dx * dx + dy * dy + dz * dz));
  }
  *r = rr;
}

__global__ void __launch_bounds__(kThreads)
gjk_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2, InitDirs dirs,
                 bool* __restrict__ hit_out, int* __restrict__ status_out,
                 int* __restrict__ iters_out, float* __restrict__ sep_out,
                 float* __restrict__ simplex_out, int B, int n1, int n2, GjkParams prm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* v1 = p1 + (size_t)b * n1 * 3;
  const float* v2 = p2 + (size_t)b * n2 * 3;
  const float eps = prm.eps, epz = prm.epz;
  const P3 zero = mk(0.0f, 0.0f, 0.0f);

  P3 c1, c2;
  float r1, r2;
  bounding_sphere(v1, n1, &c1, &r1);
  bounding_sphere(v2, n2, &c2, &r2);
  const bool active = norm(sub(c1, c2)) <= r1 + r2 + prm.bp_tol;

  P3 s[4] = {zero, zero, zero, zero};
  int status = kMissBroadphase;
  int it = 0;
  float sep = 0.0f;
  if (active) {
    // --- v1/v2 retry over the first kInitDirs table rows (ref :82-112) ---
    P3 d0 = mk(dirs.v[0][0], dirs.v[0][1], dirs.v[0][2]);
    P3 s1 = hull_support(v1, n1, v2, n2, d0);
    P3 s2 = hull_support(v1, n1, v2, n2, neg(d0));
    sep = sep_upd(sep_upd(0.0f, d0, s1), neg(d0), s2);
    for (int i = 1; i < kInitDirs && coincide(s1, s2, eps); ++i) {
      P3 d = mk(dirs.v[i][0], dirs.v[i][1], dirs.v[i][2]);
      s1 = hull_support(v1, n1, v2, n2, d);
      s2 = hull_support(v1, n1, v2, n2, neg(d));
      sep = sep_upd(sep_upd(sep, d, s1), neg(d), s2);
    }
    bool init_failed = coincide(s1, s2, eps);

    // --- v3 (ref :115-127) + origin-on-segment fix (fused.py:320-337) ---
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
    P3 s3 = hull_support(v1, n1, v2, n2, d3);
    sep = sep_upd(sep, d3, s3);
    bool v3_degenerate = coincide(s3, s1, eps) || coincide(s3, s2, eps);

    // --- v4 + early-EPA checks (ref :130-170) ---------------------------
    P3 d4 = utz(cross(sub(s2, s1), sub(s3, s2)), epz);
    P3 vo = neg(s3);
    bool on_plane = fabsf(dot(vo, d4)) < eps;
    bool early_hit = on_plane && is_inside_tri(s1, s2, s3, zero, epz);
    P3 d4f = dot(vo, d4) < 0.0f ? neg(d4) : d4;
    P3 s4 = hull_support(v1, n1, v2, n2, d4f);
    sep = sep_upd(sep, d4f, s4);
    bool v4_coplanar = fabsf(dist_pf_sign(s4, s1, s2, s3, epz)) < eps;
    if (early_hit) {
      // fresh support along the unflipped normal; the opposite side when
      // that one is coplanar (fused.py:353-363)
      P3 s4e = hull_support(v1, n1, v2, n2, d4);
      bool cop = fabsf(dist_pf_sign(s4e, s1, s2, s3, epz)) < eps;
      s4 = cop ? hull_support(v1, n1, v2, n2, neg(d4)) : s4e;
    }
    s[0] = s1;
    s[1] = s2;
    s[2] = s3;
    s[3] = s4;
    bool in_tetra = point_in_simplex(zero, s, eps, epz);

    status = kRunning;
    if (in_tetra) status = kHit;
    if (v4_coplanar) status = kMissInit;
    if (early_hit) status = kHit;
    if (v3_degenerate) status = kMissInit;
    if (init_failed) status = kMissInit;

    // --- iterate loop (ref :178-236) ------------------------------------
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
      P3 w = hull_support(v1, n1, v2, n2, d);
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
  }

  const bool hit = status == kHit;
  hit_out[b] = hit;
  status_out[b] = status;
  iters_out[b] = it;
  sep_out[b] = (hit || !active) ? 0.0f : fmaxf(sep, 0.0f);
  float* so = simplex_out + (size_t)b * 12;
  for (int i = 0; i < 4; ++i) {
    so[3 * i] = s[i].x;
    so[3 * i + 1] = s[i].y;
    so[3 * i + 2] = s[i].z;
  }
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch; the launch is asynchronous on `stream`.
extern "C" int gjk_hulls_launch(const void* p1, const void* p2, const void* init_dirs_host,
                                void* hit, void* status, void* iters, void* sep,
                                void* simplex, int B, int n1, int n2, float eps_coincide, float eps_zero, float eps_sq,
                                float broadphase_tol, int gjk_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  InitDirs dirs;
  const float* h = static_cast<const float*>(init_dirs_host);
  for (int i = 0; i < kInitDirs; ++i) {
    for (int k = 0; k < 3; ++k) dirs.v[i][k] = h[3 * i + k];
  }
  GjkParams prm;
  prm.eps = eps_coincide;
  prm.epz = eps_zero;
  prm.eps_sq = eps_sq;
  prm.bp_tol = broadphase_tol;
  prm.max_iters = gjk_max_iters;
  const int blocks = (B + kThreads - 1) / kThreads;
  gjk_hulls_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2), dirs,
      static_cast<bool*>(hit), static_cast<int*>(status), static_cast<int*>(iters),
      static_cast<float*>(sep), static_cast<float*>(simplex), B, n1, n2, prm);
  return (int)cudaGetLastError();
}
