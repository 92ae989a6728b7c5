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
// ..., kUnroll at a time.  K1 (gjk_hulls.cu), K8 (distance_hulls.cu) and
// K9 (gjk_hull_shape.cu) run teams of 4-32 threads, K2 (epa_hulls.cu) a
// team of 16 or 32, K10 (epa_hull_shape.cu) a warp, K12 (gjk_hulls_big.cu)
// and K13 (epa_hulls_big.cu) W warps of one block whose warp results meet
// in shared memory (BlockHullSupport).
//
// The tie rule.  Each thread keeps the first (strict >) maximum of its own
// vertices in index order, which is the smallest index among its maxima;
// log2(T)
// xor-shuffle steps then combine two (value, index) pairs into the larger
// value and, on an equal value, the smaller index.  That order is total, so
// every thread of the team ends with the same pair: the smallest index
// among the maximal dots, which is what the serial scan and torch.argmax
// return.  A thread that owns no vertex (n < T) enters with (-inf, INT_MAX)
// and loses every comparison.  The dot keeps the plain version's
// expression and operation order (fused_gjk.hull_vertex; built with
// --fmad=false), so the chosen vertex is torch.argmax's.
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
  if constexpr (T == kWarp) {
    return kFullMask;
  } else {
    return ((1u << T) - 1u) << ((threadIdx.x & (kWarp - 1)) & ~(T - 1));
  }
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

// The indices of the first vertex of hull v1 maximising <v, d> and of
// hull v2 maximising -<v, d> (row-major (N, 3) hulls), the same in every
// thread of the calling team: each thread scans its part of both hulls,
// then one xor-shuffle reduction folds the two (value, index) pairs side
// by side.
template <int T>
__device__ __forceinline__ void team_first_max_ab(const float* __restrict__ v1, int n1,
                                                  const float* __restrict__ v2, int n2, P3 d,
                                                  int* i1, int* i2) {
  const int t = threadIdx.x & (T - 1);
  float b1, b2;
  strided_first_max<false, T>(v1, n1, d, t, &b1, i1);
  strided_first_max<true, T>(v2, n2, d, t, &b2, i2);
  const unsigned mask = team_mask<T>();
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(mask, b1, off, T);
    const int j1 = __shfl_xor_sync(mask, *i1, off, T);
    const float o2 = __shfl_xor_sync(mask, b2, off, T);
    const int j2 = __shfl_xor_sync(mask, *i2, off, T);
    keep_first_max(o1, j1, &b1, i1);
    keep_first_max(o2, j2, &b2, i2);
  }
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
    int i1, i2;
    team_first_max_ab<T>(v1, n1, v2, n2, d, &i1, &i2);
    return sub(vertex(v1, i1), vertex(v2, i2));
  }
};

// The probe's exchange between the W warps of a block, in shared memory.
template <int W>
struct BlockProbe {
  float dir[3];          // warp 0's direction
  int go;                // 1: probe along dir, 0: stop
  float val[2][W];       // each warp's first maximum, hull 1 and hull 2
  int idx[2][W];
};

// The named barrier 1 over the W warps of a block (barrier.sync, not
// .aligned: warps may reach it from different code).
template <int W>
__device__ __forceinline__ void block_barrier() {
  asm volatile("barrier.sync 1, %0;" ::"r"(W * kWarp) : "memory");
}

// The Minkowski support of one pair's two hulls for a block of W warps
// (K12, K13).  Warp 0 runs the GJK or EPA core and calls it; warps 1..W-1
// serve() it.  Each probe: warp 0 publishes its direction and meets the
// others at the block barrier; all W * 32 threads scan the vertices
// (strided_first_max), each warp reduces its part with the team shuffles,
// and the W warp results meet in shared memory behind a second barrier,
// folded in warp order under the same (larger value, then smaller index)
// order, so that every thread ends with the first maximum.  The hulls may
// lie in device or in shared memory.
template <int W>
struct BlockHullSupport {
  static_assert(W >= 1 && W <= 32, "1 to 32 warps a block");
  const float* v1;
  int n1;
  const float* v2;
  int n2;
  BlockProbe<W>* probe;

  // One probe along d by every thread of the block.
  __device__ __forceinline__ P3 scan(P3 d) const {
    float b1, b2;
    int i1, i2;
    strided_first_max<false, W * kWarp>(v1, n1, d, threadIdx.x, &b1, &i1);
    strided_first_max<true, W * kWarp>(v2, n2, d, threadIdx.x, &b2, &i2);
    team_reduce_first_max<kWarp>(kFullMask, &b1, &i1);
    team_reduce_first_max<kWarp>(kFullMask, &b2, &i2);
    if (W > 1) {
      const int warp = threadIdx.x / kWarp;
      if ((threadIdx.x & (kWarp - 1)) == 0) {
        probe->val[0][warp] = b1;
        probe->idx[0][warp] = i1;
        probe->val[1][warp] = b2;
        probe->idx[1][warp] = i2;
      }
      block_barrier<W>();
      b1 = probe->val[0][0];
      i1 = probe->idx[0][0];
      b2 = probe->val[1][0];
      i2 = probe->idx[1][0];
#pragma unroll
      for (int u = 1; u < W; ++u) {
        keep_first_max(probe->val[0][u], probe->idx[0][u], &b1, &i1);
        keep_first_max(probe->val[1][u], probe->idx[1][u], &b2, &i2);
      }
    }
    return sub(vertex(v1, i1), vertex(v2, i2));
  }

  // Warp 0: publish d, then probe with the block.
  __device__ __forceinline__ P3 operator()(P3 d) const {
    if (W > 1) {
      if (threadIdx.x == 0) {
        probe->dir[0] = d.x;
        probe->dir[1] = d.y;
        probe->dir[2] = d.z;
        probe->go = 1;
      }
      block_barrier<W>();
    }
    return scan(d);
  }

  // Warps 1..W-1: probe along warp 0's directions until it stops.
  __device__ void serve() const {
    for (;;) {
      block_barrier<W>();
      if (!probe->go) return;
      scan(mk(probe->dir[0], probe->dir[1], probe->dir[2]));
    }
  }

  // Warp 0, after its core: release the other warps.
  __device__ __forceinline__ void stop() const {
    if (W > 1) {
      if (threadIdx.x == 0) probe->go = 0;
      block_barrier<W>();
    }
  }
};

// The most dynamic shared memory a block may opt into on the current
// device, or -1.
inline int smem_optin_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return -1;
  }
  return limit;
}

// Launch `kernel` with `bytes` of dynamic shared memory: 0, or
// cudaErrorInvalidValue past the device's limit, or the error of opting in
// above the default 48 KB.
template <class Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  const int limit = smem_optin_limit();
  if (limit < 0 || bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// The blocks of a grid that strides over a count known only on the device:
// as many as the device holds at once, at most `need`.  Returns 0 or the
// CUDA error of asking the device.
template <class Kernel>
inline int resident_grid(Kernel kernel, int threads, size_t smem, long long need, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(need < resident ? need : resident);
  return 0;
}

// The bounding sphere of one row-major (N, 3) hull for a team of T: the
// centroid summed in vertex order by every thread (a serial scan's
// rounding: a tree sum would move the broadphase verdict
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
