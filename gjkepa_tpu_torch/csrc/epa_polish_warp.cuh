// The capped EPA ladder and the polish over hit lanes, a warp a hit with
// the polytope in shared memory: the kernel of K7 (epa_shapes.cu, analytic
// pairs) and K10 (epa_hull_shape.cu, a hull against an analytic shape),
// which differ only in how a pair's support is built.
//
// Ports _epa_cascade (gjkepa_tpu/ops/fused.py:837), _polish_direction
// (:752) and the merge of _write_epa_out (:975-1007), as the TPU kernels
// _epa_cascade_kernel_shapes (:2131) and _epa_cascade_kernel_hull_shape
// (:2588) run them.  Plain PyTorch versions: epa_shapes_plain
// (ops/fused_shapes.py) and epa_hull_shape_plain (ops/fused_hull_shapes.py).
//
// Warp r of the grid takes hit rank r, r + R, ... (R the warps of the grid)
// while r < n_act, pair order[r] (the GJK hits, moved to the front by one
// cumsum, their count a device scalar, no host sync).  It builds the pair's
// support with the kernel's loader (`Loader::operator()(pair)`), runs the
// capped tier ladder of epa_warp.cuh (the shape ladder: two tiers of F = 48
// faces, K = 8 then K = 16 visible faces, at most 16 iterations), each face
// scan split across its 32 threads, every thread calling the support on
// the same direction.  The warp's one face store (PairFaces, 17 words a
// face) and its WarpScratch live in dynamic shared memory; the store is
// passed as both of the ladder's stores, and every tier restarts in it.
// Then every thread runs the polish of shape_geom.cuh on the same values
// (its 49 probes depend one on the next), a surviving capacity exit becomes
// HIT_EPA_DEGENERATE, and lane 0 writes depth, normal, iterations and
// status to pair order[r].  Every other pair keeps the pass-through row the
// wrapper wrote.
//
// The grid.  The hit count lies on the device, so the launcher sizes the
// grid to the blocks the card holds at once (at most one warp a pair) and
// each warp strides over the hit ranks.  A block holds W warps, a
// compile-time constant of each kernel (kWarps in epa_shapes.cu and
// epa_hull_shape.cu), and takes
// polish_smem_bytes<W>(f_max) of shared memory, 4,416 B a warp at the
// shape ladder's 48 faces; a ladder whose store does not fit makes the
// launcher return cudaErrorInvalidValue.
#pragma once

#include "epa_warp.cuh"
#include "shape_geom.cuh"

namespace gjkepa {

// W warps, each its scratch and its face store (epa_warp.cuh).
template <int W>
inline size_t polish_smem_bytes(int f_max) {
  return (size_t)W * warp_words(f_max) * sizeof(float);
}

// The hit lanes and the rows the kernel writes.
struct HitRows {
  const float* simplex;  // (B, 4, 3) GJK simplex
  const int* order;      // hit ranks first
  const int* n_act;      // hit count, a device scalar
  float* depth;
  float* normal;
  int* iters;
  int* status;
};

// At least one block an SM: without it ptxas caps the registers low enough
// to spill (the block's shared memory and the grid bound the warps anyway).
template <int W, class Loader>
__global__ void __launch_bounds__(W * kWarp, 1)
epa_polish_kernel(Loader load, HitRows io, int B, Tiers tiers, int f_max, EpaParams prm) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  float* mine = smem + warp * warp_words(f_max);
  WarpScratch& ws = *reinterpret_cast<WarpScratch*>(mine);
  const PairFaces fs = {mine + kScratchWords, f_max};
  const int count = min(*io.n_act, B);
  for (int r = blockIdx.x * W + warp; r < count; r += gridDim.x * W) {
    const int pair = io.order[r];
    const auto support = load(pair);
    P3 s[4];
    for (int j = 0; j < 4; ++j) {
      const float* q = io.simplex + (size_t)pair * 12 + 3 * j;
      s[j] = mk(q[0], q[1], q[2]);
    }
    TierOut res = epa_cascade_warp(support, s, tiers, fs, fs, ws, prm);
    polish_direction(support, &res.depth, &res.normal, &res.status);
    if ((threadIdx.x & (kWarp - 1)) == 0) {
      if (res.status == kHitEpaCapacity) res.status = kHitEpaDegenerate;
      io.depth[pair] = res.depth;
      io.normal[3 * pair] = res.normal.x;
      io.normal[3 * pair + 1] = res.normal.y;
      io.normal[3 * pair + 2] = res.normal.z;
      io.iters[pair] = res.iters;
      io.status[pair] = res.status;
    }
  }
}

// Launch epa_polish_kernel<W> over B pairs on `stream`.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a tier
// ladder the kernel does not hold or a block past the device's shared
// memory (polish_smem_bytes against the opt-in limit).
template <int W, class Loader>
inline int launch_epa_polish(const Loader& load, const HitRows& io, int B, int n_tiers,
                             const int* tier_faces, const int* tier_kvis, int f_max,
                             float eps_coincide, float eps_zero, int epa_max_iters,
                             cudaStream_t stream) {
  if (B <= 0) return 0;
  Tiers tiers;
  const int rc = make_tiers(n_tiers, tier_faces, tier_kvis, f_max, epa_max_iters, &tiers);
  if (rc != 0) return rc;
  const size_t smem = polish_smem_bytes<W>(f_max);
  const int err = allow_smem(epa_polish_kernel<W, Loader>, smem);
  if (err != 0) return err;
  int blocks = 0;
  const int grid_err =
      resident_grid(epa_polish_kernel<W, Loader>, W * kWarp, smem, (B + W - 1) / W, &blocks);
  if (grid_err != 0) return grid_err;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  epa_polish_kernel<W, Loader><<<blocks, W * kWarp, smem, stream>>>(load, io, B, tiers, f_max,
                                                                    prm);
  return (int)cudaGetLastError();
}

}  // namespace gjkepa
