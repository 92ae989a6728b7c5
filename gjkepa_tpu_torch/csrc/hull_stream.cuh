// K11: the first-max hull support scanned by a team of threads.
//
// Replaces _make_hull_support_streamed (gjkepa_tpu/ops/fused.py:1010-1070),
// the support map inside the TPU's large-hull kernels: there the hulls stay
// in HBM and every probe DMAs (3, tile, 128) vertex slabs through VMEM and
// folds them with strict > across slabs, so that the first maximum wins as
// in the reference's sequential scan (ref :1040-1057).  Plain PyTorch
// version: warp_first_max_plain in gjkepa_tpu_torch/ops/fused_streamed.py
// (the reduction rule, at any team width) and fused_gjk.hull_vertex (its
// result).
//
// What bounds it on the card: one probe reads both hulls, 12 * (n1 + n2)
// bytes, and does 5 float operations a vertex, so it is bound by bytes, and
// for large N by how many loads are in flight.  A team of T threads (T
// divides 32) shares one pair.  Where a hull has a multiple of 4 vertices
// and is 16-byte aligned (every pair of a (B, N, 3) batch then is), thread
// t of the team reads 4-vertex groups t, t + T, ... as three float4 words
// each, kGroupUnroll groups loaded before they are folded, so a team's
// loads cover 48 * T neighbouring bytes; else it reads vertices t, t + T,
// ..., kUnroll at a time.  K1 (gjk_hulls.cu) runs teams of 4-32 threads by
// the hull size, K12 (gjk_hulls_big.cu) a warp (T = 32), K13
// (epa_hulls_big.cu) W warps of one block whose warp results meet in
// shared memory (BlockHullSupport).
//
// The tie rule.  Each thread keeps the first (strict >) maximum of its own
// vertices in index order, which is the smallest index among its maxima;
// log2(T)
// xor-shuffle steps then combine two (value, index) pairs into the larger
// value and, on an equal value, the smaller index.  That order is total, so
// every thread of the team ends with the same pair: the smallest index
// among the maximal dots, which is what the serial scan and torch.argmax
// return.  A thread that owns no vertex (n < T) enters with (-inf, INT_MAX)
// and loses every comparison.  The dot keeps first_max_vertex's expression
// and operation order (built with --fmad=false), so the chosen vertex is
// the thread-per-pair one.
//
// Every thread of a team must call the support with the same direction:
// the shuffles take the team's mask.  The GJK and EPA cores are uniform in
// their inputs, so a team that runs one of them on one pair calls it in
// step; teams of one warp may run apart, and each shuffle waits only for
// its own team.
#pragma once

#include <climits>

#include "lane_geom.cuh"

namespace gjkepa {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kUnroll = 4;
constexpr int kGroupUnroll = 2;

__device__ __forceinline__ float vertex_dot(const float* __restrict__ q, P3 d) {
  return q[0] * d.x + q[1] * d.y + q[2] * d.z;
}

// The lanes of the calling thread's team of T within its warp.
template <int T>
__device__ __forceinline__ unsigned team_mask() {
  static_assert(T >= 1 && T <= kWarp && (kWarp % T) == 0, "T divides 32");
  if (T == kWarp) return kFullMask;
  return ((1u << T) - 1u) << ((threadIdx.x & (kWarp - 1)) & ~(T - 1));
}

// Whether a row-major (N, 3) hull can be read as float4 groups of 4
// vertices (48 bytes): N a multiple of 4 and the hull 16-byte aligned.
__device__ __forceinline__ bool hull_in_groups(const float* v, int n) {
  return (n & 3) == 0 && (reinterpret_cast<unsigned long long>(v) & 15) == 0;
}

// Fold the 4 vertices of group g (3 float4 words) into (best, idx) in
// vertex order with strict >; kFirst takes the group's first vertex as it
// is, as a thread's first vertex.
template <bool kNeg, bool kFirst>
__device__ __forceinline__ void fold_group(float4 a, float4 b, float4 c, P3 d, int g,
                                           float* best, int* idx) {
  const float x[4] = {a.x, a.w, b.z, c.y};
  const float y[4] = {a.y, b.x, b.w, c.z};
  const float z[4] = {a.z, b.y, c.x, c.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float dt = x[j] * d.x + y[j] * d.y + z[j] * d.z;
    if (kNeg) dt = -dt;
    if ((kFirst && j == 0) || dt > *best) {
      *best = dt;
      *idx = 4 * g + j;
    }
  }
}

// strided_first_max over 4-vertex groups t, t + kStride, ... of a hull read
// as float4 words (hull_in_groups): kGroupUnroll groups in flight.
template <bool kNeg, int kStride>
__device__ __forceinline__ void strided_first_max_groups(const float* __restrict__ v, int n,
                                                         P3 d, int t, float* best_out,
                                                         int* idx_out) {
  const float4* __restrict__ q = reinterpret_cast<const float4*>(v);
  const int groups = n >> 2;
  float best = -INFINITY;
  int idx = INT_MAX;
  int g = t;
  if (g < groups) {
    fold_group<kNeg, true>(q[3 * g], q[3 * g + 1], q[3 * g + 2], d, g, &best, &idx);
    g += kStride;
  }
  for (; g + (kGroupUnroll - 1) * kStride < groups; g += kGroupUnroll * kStride) {
    float4 w[kGroupUnroll][3];
#pragma unroll
    for (int u = 0; u < kGroupUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < 3; ++k) w[u][k] = q[3 * (g + u * kStride) + k];
    }
#pragma unroll
    for (int u = 0; u < kGroupUnroll; ++u) {
      fold_group<kNeg, false>(w[u][0], w[u][1], w[u][2], d, g + u * kStride, &best, &idx);
    }
  }
  for (; g < groups; g += kStride) {
    fold_group<kNeg, false>(q[3 * g], q[3 * g + 1], q[3 * g + 2], d, g, &best, &idx);
  }
  *best_out = best;
  *idx_out = idx;
}

// The first maximum of <v, d> (or -<v, d> when kNeg) over the vertices a
// thread owns of a row-major (N, 3) hull, (-inf, INT_MAX) when it owns
// none: 4-vertex groups t, t + kStride, ... where the hull reads as float4
// words, else vertices t, t + kStride, ....  Any split of the vertices
// among the threads ends, after the (value, index) reduction, at the same
// first maximum.
template <bool kNeg, int kStride>
__device__ __forceinline__ void strided_first_max(const float* __restrict__ v, int n, P3 d,
                                                  int t, float* best_out, int* idx_out) {
  if (hull_in_groups(v, n)) {
    strided_first_max_groups<kNeg, kStride>(v, n, d, t, best_out, idx_out);
    return;
  }
  float best = -INFINITY;
  int idx = INT_MAX;
  if (t < n) {
    best = vertex_dot(v + 3 * t, d);
    if (kNeg) best = -best;
    idx = t;
  }
  int i = t + kStride;
  for (; i + (kUnroll - 1) * kStride < n; i += kUnroll * kStride) {
    float dots[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dots[u] = vertex_dot(v + 3 * (i + u * kStride), d);
      if (kNeg) dots[u] = -dots[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (dots[u] > best) {
        best = dots[u];
        idx = i + u * kStride;
      }
    }
  }
  for (; i < n; i += kStride) {
    float dt = vertex_dot(v + 3 * i, d);
    if (kNeg) dt = -dt;
    if (dt > best) {
      best = dt;
      idx = i;
    }
  }
  *best_out = best;
  *idx_out = idx;
}

// The larger value, on an equal value the smaller index: the total order
// under which a (value, index) reduction ends at the first maximum.
__device__ __forceinline__ void keep_first_max(float ob, int oi, float* best, int* idx) {
  if (ob > *best || (ob == *best && oi < *idx)) {
    *best = ob;
    *idx = oi;
  }
}

// xor-shuffle reduction of (value, index) pairs over a team of T.
template <int T>
__device__ __forceinline__ void team_reduce_first_max(unsigned mask, float* best, int* idx) {
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(mask, *best, off, T);
    const int oi = __shfl_xor_sync(mask, *idx, off, T);
    keep_first_max(ob, oi, best, idx);
  }
}

// Index of the first vertex of a row-major (N, 3) hull maximising <v, d>
// (or -<v, d> when kNeg), the same in every thread of the calling team.
template <bool kNeg, int T>
__device__ __forceinline__ int team_first_max_vertex(const float* __restrict__ v, int n, P3 d) {
  float best;
  int idx;
  strided_first_max<kNeg, T>(v, n, d, threadIdx.x & (T - 1), &best, &idx);
  team_reduce_first_max<T>(team_mask<T>(), &best, &idx);
  return idx;
}

// The Minkowski support of two row-major (N, 3) hulls as a functor of
// gjk_core.cuh / epa_core.cuh, for a team of T threads that works on one
// pair.
template <int T>
struct TeamHullSupport {
  const float* v1;
  int n1;
  const float* v2;
  int n2;
  __device__ __forceinline__ P3 operator()(P3 d) const {
    return sub(vertex(v1, team_first_max_vertex<false, T>(v1, n1, d)),
               vertex(v2, team_first_max_vertex<true, T>(v2, n2, d)));
  }
};

using WarpHullSupport = TeamHullSupport<kWarp>;

// The bounding sphere of one row-major (N, 3) hull for a team of T: the
// centroid summed in vertex order by every thread (lane_geom.cuh
// bounding_sphere's rounding: a tree sum would move the broadphase verdict
// near its boundary), from float4 words where the hull reads as groups,
// and the radius, a max, split across the team.
template <int T>
__device__ __forceinline__ void team_bounding_sphere(const float* __restrict__ v, int n, P3* c,
                                                     float* r) {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (hull_in_groups(v, n)) {  // x0 y0 z0 x1 | y1 z1 x2 y2 | z2 x3 y3 z3, in vertex order
    const float4* __restrict__ q = reinterpret_cast<const float4*>(v);
    for (int g = 0; g < (n >> 2); ++g) {
      const float4 a = q[3 * g], b = q[3 * g + 1], e = q[3 * g + 2];
      sx += a.x; sy += a.y; sz += a.z;
      sx += a.w; sy += b.x; sz += b.y;
      sx += b.z; sy += b.w; sz += e.x;
      sx += e.y; sy += e.z; sz += e.w;
    }
  } else {
    for (int i = 0; i < n; ++i) {
      sx += v[3 * i];
      sy += v[3 * i + 1];
      sz += v[3 * i + 2];
    }
  }
  float fn = (float)n;
  *c = mk(sx / fn, sy / fn, sz / fn);
  float rr = 0.0f;
  for (int i = threadIdx.x & (T - 1); i < n; i += T) {
    float dx = v[3 * i] - c->x, dy = v[3 * i + 1] - c->y, dz = v[3 * i + 2] - c->z;
    rr = fmaxf(rr, sqrtf(dx * dx + dy * dy + dz * dz));
  }
  const unsigned mask = team_mask<T>();
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) rr = fmaxf(rr, __shfl_xor_sync(mask, rr, off, T));
  *r = rr;
}

}  // namespace gjkepa
