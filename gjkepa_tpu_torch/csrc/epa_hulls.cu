// K2: the EPA capacity cascade over hit lanes, a warp per hit, the polytope
// in shared memory where it fits.
//
// Replaces the TPU kernel _epa_cascade_kernel_hulls
// (gjkepa_tpu/ops/fused.py:1112, with _epa_phase_fast :456-749, _epa_cascade
// :837-873 and the merge of _write_epa_out :975-1007).  Plain PyTorch
// version: epa_cascade_plain in gjkepa_tpu_torch/ops/fused_epa.py.
//
// A block holds P warps (P pairs).  Warp w of block i takes hit rank
// r = i * P + w, pair order[r] (the hit lanes, moved to the front by one
// cumsum on the host side, no sync), while r < n_act; a warp at or past
// n_act returns whole, its pair already filled with the miss pass-through
// by the wrapper.  The warp runs the tier ladder of epa_warp.cuh, each face
// scan split across its 32 threads, with the warp support of
// hull_stream.cuh (TeamHullSupport<32>: at 24 vertices six threads read a
// 4-vertex group each, then one xor reduction), and lane 0 writes depth,
// normal, iterations and status.  A final-tier capacity exit becomes
// HIT_EPA_DEGENERATE.  This is K13's warp tier, bit-equal to the same
// plain version; K13 shares each probe across a block because its hulls
// are large, K2 gives each warp its own pair because its hulls are small.
// P is K2_PAIRS = 1, fixed at compile time: of 1, 2, 4 and 8 the fastest
// on an H100 (PERF.md); `scripts/torch_kernel_sweep.py k2` rebuilds this
// file with -DK2_PAIRS=P to time the others.
//
// Face stores by size, never a refusal.  The block's dynamic shared memory
// holds, for each of its P warps, a WarpScratch (1,152 B) and a face store
// of near_faces faces (68 B a face).  A tier of at most near_faces faces
// keeps its faces there; a larger tier keeps them in a store of far_faces
// faces in device memory, one per hit rank ([rank][field][face]), which the
// wrapper allocates only when some tier needs it.  fused_epa.k2_near_faces
// picks near_faces, the largest tier whose store fits in the device's
// shared memory (epa_hulls_smem_bytes): the whole default ladder (208
// faces, 15,296 B a warp) fits, so the main path keeps every tier in shared
// memory and allocates no scratch.
//
// What bounds it: each hit's iterations run one after another, a chain of
// dependent shared-memory passes and shuffles plus one probe of both hulls
// (5 float operations a vertex), so the launch lasts as long as its waves'
// slowest hits; the warps resident on an SM hide each other's latency, and
// the whole ladder's store (14 warps an SM) allows fewer of them than the
// registers would (18).
#include "epa_warp.cuh"

namespace gjkepa {
namespace {

#ifndef K2_PAIRS
#define K2_PAIRS 1
#endif
constexpr int kPairs = K2_PAIRS;  // P, the warps (pairs) a block

// P warps, each its scratch and its near face store (epa_warp.cuh).
inline size_t smem_bytes(int near_faces) {
  return (size_t)kPairs * warp_words(near_faces) * sizeof(float);
}

// At least one block an SM: without it ptxas caps the registers at 80 and
// spills (the block's shared memory limits the warps an SM runs anyway).
__global__ void __launch_bounds__(kPairs * kWarp, 1)
epa_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                 const float* __restrict__ simplex, const int* __restrict__ order,
                 const int* __restrict__ n_act, float* __restrict__ depth_out,
                 float* __restrict__ normal_out, int* __restrict__ iters_out,
                 int* __restrict__ status_out, float* __restrict__ far_store, int n1, int n2,
                 Tiers tiers, int near_faces, int far_faces, EpaParams prm) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int r = blockIdx.x * kPairs + warp;
  if (r >= *n_act) return;  // the whole warp
  const int pair = order[r];
  float* mine = smem + warp * warp_words(near_faces);
  WarpScratch& ws = *reinterpret_cast<WarpScratch*>(mine);
  const PairFaces near = {mine + kScratchWords, near_faces};
  const PairFaces far = {far_store + (size_t)r * kFields * far_faces, far_faces};
  P3 s[4];
  for (int j = 0; j < 4; ++j) {
    const float* q = simplex + (size_t)pair * 12 + 3 * j;
    s[j] = mk(q[0], q[1], q[2]);
  }
  const TeamHullSupport<kWarp> support = {p1 + (size_t)pair * n1 * 3, n1,
                                          p2 + (size_t)pair * n2 * 3, n2};
  TierOut res = epa_cascade_warp(support, s, tiers, near, far, ws, prm);
  if ((threadIdx.x & (kWarp - 1)) != 0) return;
  if (res.status == kHitEpaCapacity) res.status = kHitEpaDegenerate;
  depth_out[pair] = res.depth;
  normal_out[3 * pair] = res.normal.x;
  normal_out[3 * pair + 1] = res.normal.y;
  normal_out[3 * pair + 2] = res.normal.z;
  iters_out[pair] = res.iters;
  status_out[pair] = res.status;
}

}  // namespace
}  // namespace gjkepa

// Words a face of the EPA face stores: K2's device store is (n_act,
// words, far_faces) float32, K10's scratch (words, f_max, B).
extern "C" int epa_scratch_words_per_face() { return gjkepa::kFields; }

// Bytes of shared memory a K2 block takes with a face store of `near_faces`
// faces a warp.
extern "C" int epa_hulls_smem_bytes(int near_faces) {
  return (int)gjkepa::smem_bytes(near_faces);
}

// C interface, bound with ctypes.  A tier of at most `near_faces` faces runs
// in shared memory, a larger one in `far_store`, (n_act, fields, far_faces)
// float32 (null when no tier needs it).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a tier ladder the kernel does
// not hold, a tier in neither store or a block past the device's shared
// memory; the launch is asynchronous on `stream`.
extern "C" int epa_hulls_launch(const void* p1, const void* p2, const void* simplex,
                                const void* order, const void* n_act, void* depth, void* normal,
                                void* iters, void* status, void* far_store, int B, int n1, int n2,
                                int n_tiers, const int* tier_faces, const int* tier_kvis,
                                int near_faces, int far_faces, float eps_coincide,
                                float eps_zero, int epa_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  if (near_faces < 0 || far_faces < 0) return (int)cudaErrorInvalidValue;
  Tiers tiers;
  const int f_max = near_faces > far_faces ? near_faces : far_faces;
  const int rc = make_tiers(n_tiers, tier_faces, tier_kvis, f_max, epa_max_iters, &tiers);
  if (rc != 0) return rc;
  for (int t = 0; t < tiers.n; ++t) {
    if (tiers.faces[t] > near_faces && far_store == nullptr) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(near_faces);
  const int err = allow_smem(epa_hulls_kernel, smem);
  if (err != 0) return err;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  const int blocks = (B + kPairs - 1) / kPairs;
  epa_hulls_kernel<<<blocks, kPairs * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(simplex), static_cast<const int*>(order),
      static_cast<const int*>(n_act), static_cast<float*>(depth), static_cast<float*>(normal),
      static_cast<int*>(iters), static_cast<int*>(status), static_cast<float*>(far_store), n1,
      n2, tiers, near_faces, far_faces, prm);
  return (int)cudaGetLastError();
}
