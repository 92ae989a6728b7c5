// K7: the capped EPA cascade and the polish over shape hit lanes, a warp per
// hit, the polytope in shared memory.
//
// Replaces the TPU kernel _epa_cascade_kernel_shapes
// (gjkepa_tpu/ops/fused.py:2131, with _epa_cascade :837, _polish_direction
// :752 and the merge of _write_epa_out :975-1007).  Plain PyTorch version:
// epa_shapes_plain in gjkepa_tpu_torch/ops/fused_shapes.py.
//
// Warp r of the grid takes hit rank r, r + R, ... (R the warps of the grid)
// while r < n_act, pair order[r] (the GJK hits without a closed form, moved
// to the front by one cumsum, their count a device scalar, no host sync).
// It runs the capped tier ladder of epa_warp.cuh (two tiers of F = 48 faces,
// K = 8 then K = 16 visible faces, at most 16 iterations), each face scan
// split across its 32 threads, with the analytic shape support of
// shape_geom.cuh: every thread evaluates it on the same direction and gets
// the same point, so it needs no scan and no shuffle.  The warp's one face
// store (PairFaces, 17 words a face) and its WarpScratch live in dynamic
// shared memory; the store is passed as both of the ladder's stores, as in
// K13, and every tier restarts in it.  Then every thread runs the polish of
// shape_geom.cuh on the same values (its probes depend one on the next),
// a surviving capacity exit becomes HIT_EPA_DEGENERATE, and lane 0 writes
// depth, normal, iterations and status to pair order[r].  Every other pair
// keeps the pass-through row the wrapper wrote (closed-form depth and
// normal, or zeros, with the GJK status).
//
// The grid.  The hit count lies on the device, so the launcher sizes the
// grid to the blocks the card holds at once (at most one warp a pair) and
// each warp strides over the hit ranks: c3's 554 hits of 65,536 pairs do
// not pay for 65,536 warps that would exit at once.  A block holds W warps,
// K7_WARPS = 1, fixed at compile time: of 1, 2 and 4 the fastest on an
// H100 (PERF.md); `scripts/torch_kernel_sweep.py k7` rebuilds this file
// with -DK7_WARPS=W to time the others.  A block takes
// epa_shapes_smem_bytes(f_max) of shared memory, 4,416 B a warp at the
// shape ladder's 48 faces; a ladder whose store does not fit raises.
//
// What bounds it: each hit's iterations run one after another, a chain of
// dependent shared-memory passes, shuffles and ballots plus one analytic
// probe (two rotated supports), then the polish's 49 dependent probes; the
// warps resident on an SM hide each other's latency.  The launch lasts as
// long as its slowest warp's hits.
#include "epa_warp.cuh"
#include "shape_geom.cuh"

namespace gjkepa {
namespace {

#ifndef K7_WARPS
#define K7_WARPS 1
#endif
constexpr int kWarps = K7_WARPS;  // W, the warps (hits in flight) a block
constexpr size_t kScratchWords = sizeof(WarpScratch) / sizeof(float);
static_assert(sizeof(WarpScratch) % sizeof(float) == 0, "word-sized scratch");

// One warp's shared memory: its scratch, then its face store.
__host__ __device__ inline size_t warp_words(int f_max) {
  return kScratchWords + (size_t)kFields * f_max;
}

inline size_t smem_bytes(int f_max) {
  return (size_t)kWarps * warp_words(f_max) * sizeof(float);
}

// At least one block an SM: without it ptxas caps the registers low enough
// to spill (the block's shared memory and the grid bound the warps anyway).
__global__ void __launch_bounds__(kWarps * kWarp, 1)
epa_shapes_kernel(const float* __restrict__ sa, const float* __restrict__ sb,
                  const float* __restrict__ simplex, const int* __restrict__ order,
                  const int* __restrict__ n_act, float* __restrict__ depth_out,
                  float* __restrict__ normal_out, int* __restrict__ iters_out,
                  int* __restrict__ status_out, int B, Tiers tiers, int f_max, EpaParams prm) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  float* mine = smem + warp * warp_words(f_max);
  WarpScratch& ws = *reinterpret_cast<WarpScratch*>(mine);
  const PairFaces fs = {mine + kScratchWords, f_max};
  const int count = min(*n_act, B);
  for (int r = blockIdx.x * kWarps + warp; r < count; r += gridDim.x * kWarps) {
    const int pair = order[r];
    const ShapeSupport support = {load_shape(sa, pair), load_shape(sb, pair)};
    P3 s[4];
    for (int j = 0; j < 4; ++j) {
      const float* q = simplex + (size_t)pair * 12 + 3 * j;
      s[j] = mk(q[0], q[1], q[2]);
    }
    TierOut res = epa_cascade_warp(support, s, tiers, fs, fs, ws, prm);
    polish_direction(support, &res.depth, &res.normal, &res.status);
    if ((threadIdx.x & (kWarp - 1)) == 0) {
      if (res.status == kHitEpaCapacity) res.status = kHitEpaDegenerate;
      depth_out[pair] = res.depth;
      normal_out[3 * pair] = res.normal.x;
      normal_out[3 * pair + 1] = res.normal.y;
      normal_out[3 * pair + 2] = res.normal.z;
      iters_out[pair] = res.iters;
      status_out[pair] = res.status;
    }
  }
}

}  // namespace
}  // namespace gjkepa

// Bytes of shared memory a K7 block takes at face capacity f_max.
extern "C" int epa_shapes_smem_bytes(int f_max) { return (int)gjkepa::smem_bytes(f_max); }

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
  if (B <= 0) return 0;
  Tiers tiers;
  const int rc = make_tiers(n_tiers, tier_faces, tier_kvis, f_max, epa_max_iters, &tiers);
  if (rc != 0) return rc;
  const size_t smem = smem_bytes(f_max);
  const int err = allow_smem(epa_shapes_kernel, smem);
  if (err != 0) return err;
  int blocks = 0;
  const int grid_err =
      resident_grid(epa_shapes_kernel, kWarps * kWarp, smem, (B + kWarps - 1) / kWarps, &blocks);
  if (grid_err != 0) return grid_err;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  epa_shapes_kernel<<<blocks, kWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const float*>(simplex), static_cast<const int*>(order),
      static_cast<const int*>(n_act), static_cast<float*>(depth), static_cast<float*>(normal),
      static_cast<int*>(iters), static_cast<int*>(status), B, tiers, f_max, prm);
  return (int)cudaGetLastError();
}
