// K10: the capped EPA cascade and the polish over hull-vs-shape hit lanes, a
// warp per hit, the polytope in shared memory.
//
// Replaces the TPU kernel _epa_cascade_kernel_hull_shape
// (gjkepa_tpu/ops/fused.py:2588, with _epa_cascade :837, _polish_direction
// :752 and the merge of _write_epa_out :975-1007).  Plain PyTorch version:
// epa_hull_shape_plain in gjkepa_tpu_torch/ops/fused_hull_shapes.py.
//
// The kernel is epa_polish_warp.cuh's, shared with K7: warp r strides over
// the GJK hits' ranks r < n_act (a device scalar, no host read), takes pair
// order[r], and runs the shape ladder (two tiers of F = 48 faces, K = 8
// then 16 visible faces, at most 16 iterations) over one 48-face store in
// dynamic shared memory, each face scan split across the warp, then the
// polish (valid for any exact support: the hull's first maximum is exact),
// and lane 0 writes the row.  Every other pair keeps the row the wrapper
// wrote: zero depth, normal and iterations with its GJK status.  This file
// gives it the pairs' support (HullShapePairs: TeamHullShapeSupport<32> of
// hull_shape.cuh, the hull's first maximum scanned by the warp's 32
// threads, as float4 groups of 4 vertices where N % 4 == 0, and reduced by
// xor shuffles, ties to the smaller index; every thread evaluates the
// shape side itself) and its block size, kWarps = 1 warp, as K7's
// (PERF.md, Findings).  A block takes
// epa_hull_shape_smem_bytes(f_max) of shared memory, 4,416 B a warp at the
// shape ladder's 48 faces; a ladder whose store does not fit raises.
//
// What bounds it: each hit's iterations run one after another, a chain of
// dependent shared-memory passes, shuffles and ballots plus one probe (a
// warp-split scan of the hull, 12 * N bytes, and the shape's closed-form
// support), then the polish's 49 dependent probes; the warps resident on
// an SM hide each other's latency, and the launch lasts as long as its
// slowest warp's hits.
#include "epa_polish_warp.cuh"
#include "hull_shape.cuh"

namespace gjkepa {
namespace {

constexpr int kWarps = 1;  // W, the warps (hits in flight) a block

// A pair's support: its (N, 3) hull against its analytic shape.
struct HullShapePairs {
  const float* __restrict__ p1;
  int n1;
  const float* __restrict__ sb;
  __device__ __forceinline__ TeamHullShapeSupport<kWarp> operator()(int pair) const {
    return {p1 + (size_t)pair * n1 * 3, n1, load_shape(sb, pair)};
  }
};

}  // namespace
}  // namespace gjkepa

// Bytes of shared memory a K10 block takes at face capacity f_max.
extern "C" int epa_hull_shape_smem_bytes(int f_max) {
  return (int)gjkepa::polish_smem_bytes<gjkepa::kWarps>(f_max);
}

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a tier ladder the kernel does not
// hold or a block past the device's shared memory
// (epa_hull_shape_smem_bytes against the opt-in limit); the launch is
// asynchronous on `stream`.
extern "C" int epa_hull_shape_launch(const void* p1, const void* sb, const void* simplex,
                                     const void* order, const void* n_act, void* depth,
                                     void* normal, void* iters, void* status, int B, int n1,
                                     int n_tiers, const int* tier_faces, const int* tier_kvis,
                                     int f_max, float eps_coincide, float eps_zero,
                                     int epa_max_iters, void* stream) {
  using namespace gjkepa;
  const HullShapePairs load = {static_cast<const float*>(p1), n1, static_cast<const float*>(sb)};
  const HitRows io = {static_cast<const float*>(simplex), static_cast<const int*>(order),
                      static_cast<const int*>(n_act),     static_cast<float*>(depth),
                      static_cast<float*>(normal),        static_cast<int*>(iters),
                      static_cast<int*>(status)};
  return launch_epa_polish<kWarps>(load, io, B, n_tiers, tier_faces, tier_kvis, f_max,
                                   eps_coincide, eps_zero, epa_max_iters,
                                   static_cast<cudaStream_t>(stream));
}
