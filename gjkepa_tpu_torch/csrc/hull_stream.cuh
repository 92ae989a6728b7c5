// K11: the first-max hull support scanned by a whole warp.
//
// Replaces _make_hull_support_streamed (gjkepa_tpu/ops/fused.py:1010-1070),
// the support map inside the TPU's large-hull kernels: there the hulls stay
// in HBM and every probe DMAs (3, tile, 128) vertex slabs through VMEM and
// folds them with strict > across slabs, so that the first maximum wins as
// in the reference's sequential scan (ref :1040-1057).  Plain PyTorch
// version: warp_first_max_plain in gjkepa_tpu_torch/ops/fused_streamed.py
// (the reduction rule) and fused_gjk.hull_vertex (its result).
//
// What bounds it on the card: one probe reads both hulls, 12 * (n1 + n2)
// bytes, and does 5 float operations a vertex, so it is bound by bytes, and
// for large N by how many loads are in flight.  K1's thread-per-pair scan
// (lane_geom.cuh first_max_vertex) walks 12 * N bytes in one thread, its
// neighbours 12 * N bytes away; at 256 pairs that is 256 threads on 2 SMs.
// Here the 32 threads of a warp share one pair: thread t scans vertices t,
// t + 32, ..., so a warp's loads cover 384 neighbouring bytes, kUnroll
// vertices of each thread are loaded before they are folded, and 256 pairs
// are 256 warps spread over the SMs.
//
// The tie rule.  Each thread keeps the first (strict >) maximum of its own
// vertices, which is the smallest index among its maxima; five xor-shuffle
// steps then combine two (value, index) pairs into the larger value and, on
// an equal value, the smaller index.  That order is total, so every thread
// ends with the same pair: the smallest index among the maximal dots, which
// is what the serial scan and torch.argmax return.  A thread that owns no
// vertex (n < 32) enters with (-inf, INT_MAX) and loses every comparison.
// The dot keeps first_max_vertex's expression and operation order (built
// with --fmad=false), so the chosen vertex is the thread-per-pair one.
//
// Every thread of the warp must call the support with the same direction:
// the shuffles take the full mask.  The GJK and EPA cores are uniform in
// their inputs, so a warp that runs one of them on one pair calls it in
// step.
#pragma once

#include <climits>

#include "epa_core.cuh"
#include "lane_geom.cuh"

namespace gjkepa {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kUnroll = 4;

__device__ __forceinline__ float vertex_dot(const float* __restrict__ q, P3 d) {
  return q[0] * d.x + q[1] * d.y + q[2] * d.z;
}

// Index of the first vertex of a row-major (N, 3) hull maximising <v, d>
// (or -<v, d> when kNeg), the same in every thread of the calling warp.
template <bool kNeg>
__device__ __forceinline__ int warp_first_max_vertex(const float* __restrict__ v, int n, P3 d) {
  const int t = threadIdx.x & (kWarp - 1);
  float best = -INFINITY;
  int idx = INT_MAX;
  if (t < n) {
    best = vertex_dot(v + 3 * t, d);
    if (kNeg) best = -best;
    idx = t;
  }
  int i = t + kWarp;
  for (; i + (kUnroll - 1) * kWarp < n; i += kUnroll * kWarp) {
    float dots[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dots[u] = vertex_dot(v + 3 * (i + u * kWarp), d);
      if (kNeg) dots[u] = -dots[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (dots[u] > best) {
        best = dots[u];
        idx = i + u * kWarp;
      }
    }
  }
  for (; i < n; i += kWarp) {
    float dt = vertex_dot(v + 3 * i, d);
    if (kNeg) dt = -dt;
    if (dt > best) {
      best = dt;
      idx = i;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFullMask, best, off);
    const int oi = __shfl_xor_sync(kFullMask, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  return idx;
}

// The Minkowski support of two row-major (N, 3) hulls as a functor of
// gjk_core.cuh / epa_core.cuh, for a warp that works on one pair.
struct WarpHullSupport {
  const float* v1;
  int n1;
  const float* v2;
  int n2;
  __device__ __forceinline__ P3 operator()(P3 d) const {
    return sub(vertex(v1, warp_first_max_vertex<false>(v1, n1, d)),
               vertex(v2, warp_first_max_vertex<true>(v2, n2, d)));
  }
};

// One pair's polytope scratch, shared by the 32 threads of its warp.  Every
// thread stores the same value to the same word (one transaction) and reads
// back a value it stored itself, with one exception that needs the barrier:
// a thread that ran ahead could overwrite a face that a thread behind it
// has yet to read in an earlier step.  A __syncwarp() before each group of
// stores keeps every store behind every read that precedes it.
struct WarpFaces : Faces {
  __device__ __forceinline__ void before_store() const { __syncwarp(); }
};

}  // namespace gjkepa
