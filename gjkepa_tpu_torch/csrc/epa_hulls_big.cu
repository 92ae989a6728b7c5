// K13: the EPA capacity cascade over large hull pairs, a block of W warps
// per hit, the polytope in shared memory.
//
// Replaces the TPU kernel _epa_cascade_kernel_hulls_big
// (gjkepa_tpu/ops/fused.py:1086, with _epa_cascade :837-873 over the tier
// ladder of _cascade_plan :1147, and the merge of _write_epa_out :975-1007)
// over the streamed support _make_hull_support_streamed (:1010, K11:
// hull_stream.cuh).  Plain PyTorch version: epa_cascade_plain in
// gjkepa_tpu_torch/ops/fused_epa.py, the K2 cascade.
//
// Block i < n_act takes pair order[i] (the hit lanes, moved to the front by
// one cumsum with the count on the device); a block at or past n_act
// returns whole, its pair already filled with the miss pass-through by the
// wrapper.  Warp 0 runs the tier ladder of epa_warp.cuh, each face scan
// split across its 32 threads, on the pair's polytope, and thread 0 writes
// depth, normal, iterations and status.  A final-tier capacity exit becomes
// HIT_EPA_DEGENERATE, as in K2.
//
// Face stores by size, as K2's, never a refusal.  A tier of at most
// near_faces faces keeps its polytope in the block's dynamic shared memory
// (17 words a face, 14,144 B at the default ladder's F = 208, the tiers in
// sequence over the same store); a larger tier keeps it in a store of
// far_faces faces in device memory, one per hit rank ([rank][field][face]),
// which the wrapper allocates only when some tier needs it.
// fused_epa.near_store_faces picks near_faces, the largest tier whose block
// fits in the device's shared memory (epa_hulls_big_smem_bytes): the whole
// default ladder does, so the main path allocates no store and reads
// nothing back.  The kernel is a template on whether a device store exists:
// without one the shared-memory store serves as both, which keeps the
// default ladder's build at 80 registers (one build serving both stores
// took 98: two blocks an SM in place of three, ~11% slower at 4096 x 2600
// on an H100).
//
// The probe is split across the block.  Each EPA iteration is one support
// probe, 12 * (n1 + n2) bytes of hull (196 KB at 8192 + 8192), and at one
// warp a pair the probes took most of the time: 256 pairs are 256 warps on
// 132 SMs, each waiting on its own loads.  So all W * 32 threads scan the
// vertices for each probe (hull_stream.cuh's BlockHullSupport: warp 0's
// direction through shared memory, a block barrier, the strided scan in
// float4 groups, K11's shuffles in each warp, the W warp results folded in
// warp order behind a second barrier).  The face work stays with warp
// 0 (warps 1..W-1 wait at the barrier for the next direction or the stop
// word): it is a few shared-memory passes an iteration, and one warp keeps
// its ballots and shuffles free of block barriers.  The barrier is the
// named barrier 1 (barrier.sync, not .aligned), which warps may reach from
// different code.  W is kWarps = 8, the fastest of 1, 2, 4 and 8 on an
// H100 at both measured sizes (PERF.md, Findings).
//
// What bounds it: the probes' bytes at the card's memory rate (the L2 holds
// 256 pairs of 8192 + 8192 vertices, 50 MB, only in part), then warp 0's
// face work, which no other warp shares: each pair's iterations run one
// after another, so the slowest pair's count sets the time of a launch
// whose pairs all fit on the card at once.
#include "epa_warp.cuh"

namespace gjkepa {
namespace {

constexpr int kWarps = 8;  // W, the warps a block

using Probe = BlockProbe<kWarps>;
using Support = BlockHullSupport<kWarps>;

// K13's shared memory: the probe exchange, the warp scratch, then the near
// face store.
constexpr size_t kProbeWords = sizeof(Probe) / sizeof(float);
static_assert(sizeof(Probe) % sizeof(float) == 0, "word-sized probe exchange");

inline size_t smem_bytes(int near_faces) {
  return (kProbeWords + kScratchWords + (size_t)kFields * near_faces) * sizeof(float);
}

template <bool kFar>
__global__ void __launch_bounds__(kWarps * kWarp)
epa_hulls_big_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                     const float* __restrict__ simplex, const int* __restrict__ order,
                     const int* __restrict__ n_act, float* __restrict__ depth_out,
                     float* __restrict__ normal_out, int* __restrict__ iters_out,
                     int* __restrict__ status_out, float* __restrict__ far_store, int n1,
                     int n2, Tiers tiers, int near_faces, int far_faces, EpaParams prm) {
  extern __shared__ float smem[];
  const int i = blockIdx.x;
  if (i >= *n_act) return;  // the whole block
  const int pair = order[i];
  const Support support = {p1 + (size_t)pair * n1 * 3, n1, p2 + (size_t)pair * n2 * 3, n2,
                           reinterpret_cast<Probe*>(smem)};
  if (threadIdx.x >= kWarp) {
    support.serve();
    return;
  }
  WarpScratch& ws = *reinterpret_cast<WarpScratch*>(smem + kProbeWords);
  const PairFaces near = {smem + kProbeWords + kScratchWords, near_faces};
  P3 s[4];
  for (int j = 0; j < 4; ++j) {
    const float* q = simplex + (size_t)pair * 12 + 3 * j;
    s[j] = mk(q[0], q[1], q[2]);
  }
  TierOut r;
  if constexpr (kFar) {
    const PairFaces far = {far_store + (size_t)i * kFields * far_faces, far_faces};
    r = epa_cascade_warp(support, s, tiers, near, far, ws, prm);
  } else {
    r = epa_cascade_warp(support, s, tiers, near, near, ws, prm);
  }
  support.stop();
  if (threadIdx.x != 0) return;
  if (r.status == kHitEpaCapacity) r.status = kHitEpaDegenerate;
  depth_out[pair] = r.depth;
  normal_out[3 * pair] = r.normal.x;
  normal_out[3 * pair + 1] = r.normal.y;
  normal_out[3 * pair + 2] = r.normal.z;
  iters_out[pair] = r.iters;
  status_out[pair] = r.status;
}

}  // namespace
}  // namespace gjkepa

// Bytes of shared memory a K13 block takes with a face store of `near_faces`
// faces.
extern "C" int epa_hulls_big_smem_bytes(int near_faces) {
  return (int)gjkepa::smem_bytes(near_faces);
}

// The most shared memory a block may take on the current device (opt-in).
extern "C" int epa_hulls_big_smem_limit() { return gjkepa::smem_optin_limit(); }

// C interface, bound with ctypes: K2's arguments.  A tier of at most
// `near_faces` faces runs in shared memory, a larger one in `far_store`,
// (n_act, fields, far_faces) float32 (null when no tier needs it).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a tier ladder the kernel does not hold, a tier in neither store or a
// block past the device's shared memory (epa_hulls_big_smem_bytes against
// epa_hulls_big_smem_limit); the launch is asynchronous on `stream`.
extern "C" int epa_hulls_big_launch(const void* p1, const void* p2, const void* simplex,
                                    const void* order, const void* n_act, void* depth,
                                    void* normal, void* iters, void* status, void* far_store,
                                    int B, int n1, int n2, int n_tiers, const int* tier_faces,
                                    const int* tier_kvis, int near_faces, int far_faces,
                                    float eps_coincide, float eps_zero, int epa_max_iters,
                                    void* stream) {
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
  auto kernel = far_store != nullptr ? epa_hulls_big_kernel<true> : epa_hulls_big_kernel<false>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  kernel<<<B, kWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(simplex), static_cast<const int*>(order),
      static_cast<const int*>(n_act), static_cast<float*>(depth), static_cast<float*>(normal),
      static_cast<int*>(iters), static_cast<int*>(status), static_cast<float*>(far_store), n1,
      n2, tiers, near_faces, far_faces, prm);
  return (int)cudaGetLastError();
}
