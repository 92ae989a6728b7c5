// K7: the capped EPA cascade and the polish over shape hit lanes, a warp per
// hit, the polytope in shared memory.
//
// Replaces the TPU kernel _epa_cascade_kernel_shapes
// (gjkepa_tpu/ops/fused.py:2131, with _epa_cascade :837, _polish_direction
// :752 and the merge of _write_epa_out :975-1007).  Plain PyTorch version:
// epa_shapes_plain in gjkepa_tpu_torch/ops/fused_shapes.py.
//
// The kernel is epa_polish_warp.cuh's, shared with K10 (a warp per hit,
// the 48-face polytope and the warp's scratch in dynamic shared memory, a
// grid of the card's resident blocks striding over the hits without a host
// read of their count).  This file gives it the pairs' support
// (ShapePairs: the GJK hits without a closed form; the analytic shape
// support of shape_geom.cuh, which every thread evaluates on the same
// direction to the same point, so it needs no scan and no shuffle) and its
// block size, kWarps = 1 warp: of 1, 2 and 4 the fastest on an H100
// (PERF.md, Findings).  A block takes
// epa_shapes_smem_bytes(f_max) of shared memory, 4,416 B a warp at the
// shape ladder's 48 faces; a ladder whose store does not fit raises.
// Every pair off the hit list keeps the pass-through row the wrapper wrote
// (closed-form depth and normal, or zeros, with the GJK status).
//
// What bounds it: each hit's iterations run one after another, a chain of
// dependent shared-memory passes, shuffles and ballots plus one analytic
// probe (two rotated supports), then the polish's 49 dependent probes; the
// warps resident on an SM hide each other's latency.  The launch lasts as
// long as its slowest warp's hits.
#include "epa_polish_warp.cuh"

namespace gjkepa {
namespace {

constexpr int kWarps = 1;  // W, the warps (hits in flight) a block

// A pair's support: both sides' analytic shapes, evaluated by every thread.
struct ShapePairs {
  const float* __restrict__ sa;
  const float* __restrict__ sb;
  __device__ __forceinline__ ShapeSupport operator()(int pair) const {
    return {load_shape(sa, pair), load_shape(sb, pair)};
  }
};

}  // namespace
}  // namespace gjkepa

// Bytes of shared memory a K7 block takes at face capacity f_max.
extern "C" int epa_shapes_smem_bytes(int f_max) {
  return (int)gjkepa::polish_smem_bytes<gjkepa::kWarps>(f_max);
}

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a tier ladder the kernel does not
// hold or a block past the device's shared memory
// (epa_shapes_smem_bytes against the opt-in limit); the launch is
// asynchronous on `stream`.
extern "C" int epa_shapes_launch(const void* sa, const void* sb, const void* simplex,
                                 const void* order, const void* n_act, void* depth, void* normal,
                                 void* iters, void* status, int B, int n_tiers,
                                 const int* tier_faces, const int* tier_kvis, int f_max,
                                 float eps_coincide, float eps_zero, int epa_max_iters,
                                 void* stream) {
  using namespace gjkepa;
  const ShapePairs load = {static_cast<const float*>(sa), static_cast<const float*>(sb)};
  const HitRows io = {static_cast<const float*>(simplex), static_cast<const int*>(order),
                      static_cast<const int*>(n_act),     static_cast<float*>(depth),
                      static_cast<float*>(normal),        static_cast<int*>(iters),
                      static_cast<int*>(status)};
  return launch_epa_polish<kWarps>(load, io, B, n_tiers, tier_faces, tier_kvis, f_max,
                                   eps_coincide, eps_zero, epa_max_iters,
                                   static_cast<cudaStream_t>(stream));
}
