// K12: GJK over large hull pairs, a block of W warps per pair, both hulls
// staged once into shared memory for all of its probes.
//
// Replaces the TPU kernel _gjk_kernel_hulls_big (gjkepa_tpu/ops/fused.py:
// 1073, with _gjk_guard :925 and _gjk_phase :262-453) over the streamed
// support _make_hull_support_streamed (:1010, K11: hull_stream.cuh).  Plain
// PyTorch version: gjk_hulls_big_plain in
// gjkepa_tpu_torch/ops/fused_streamed.py.
//
// The dispatch (fused_streamed.fused_hulls_streamed) takes this kernel when
// n1 + n2 > 4096 vertices, as the JAX package does.  The bounding-sphere
// broadphase comes in decided, as a (B,) bool: the JAX package computes it
// outside the kernel on the tile-padded hulls, and so does the port.  The
// kernel reads the unpadded hulls: trailing repeats of vertex 0 never change
// a first-max support.
//
// Block b takes pair b.  A pair the broadphase rejects makes no probe:
// thread 0 writes its miss rows.  Otherwise the block copies both hulls into
// dynamic shared memory once (the staged kernel): where a hull reads as
// float4 groups (n % 4 == 0, 16-B aligned: every pair of a (B, N, 3) batch
// then is) by one bulk copy of the Tensor Memory Accelerator completing on
// an mbarrier, else by the block's threads word by word.  Warp 0 then runs
// the GJK phase of gjk_core.cuh and warps 1..W-1 serve its probes
// (hull_stream.cuh's BlockHullSupport, as in K13): every probe reads the
// staged hulls, split across the W * 32 threads, and thread 0 writes hit,
// status, iterations, the separation lower bound and the 4x3 simplex.  The
// GJK arithmetic between probes runs once, in warp 0, not in every warp:
// the other warps wait at the barrier and leave the SM's instruction slots to the
// other resident blocks.  The launcher takes the staged kernel while both
// hulls fit in a block's shared memory (n1 + n2 up to about 19,300
// vertices on an H100, gjk_hulls_big_staged); past that the same kernel
// template scans the hulls in device memory on every probe, a choice by
// size, never a refusal.  W is kWarps = 4: of 2, 4, 8 and 16 the fastest
// at 4096 x 2600 and within 5% of the fastest (8) at 256 x 8192 on an
// H100 (PERF.md, Findings).
//
// What bounds it: reading both hulls, 12 * (n1 + n2) bytes a pair, once
// from device memory; then about 6 + iterations probes from shared memory
// and the GJK arithmetic between them, one after another within a pair.
#include "gjk_core.cuh"
#include "hull_stream.cuh"
#include "tma_stage.cuh"

namespace gjkepa {
namespace {

constexpr int kWarps = 4;  // W, the warps a block

using Probe = BlockProbe<kWarps>;
using Support = BlockHullSupport<kWarps>;

// K12's shared memory: the mbarrier (8 B, padded to 16), the probe
// exchange, then each staged hull padded to 16 B.
constexpr int kBarWords = 4;
constexpr int kHeadWords = kBarWords + (int)(sizeof(Probe) / sizeof(float));
static_assert(sizeof(Probe) % 16 == 0, "16-B aligned hulls");

__host__ __device__ inline int hull_words(int n) { return (3 * n + 3) & ~3; }

inline size_t smem_bytes(int n1, int n2, bool staged) {
  return (kHeadWords + (staged ? (size_t)hull_words(n1) + hull_words(n2) : 0)) * sizeof(float);
}

// Whether the launcher stages both hulls: while its block fits in the
// current device's shared memory.
inline bool stages(int n1, int n2) {
  const int limit = smem_optin_limit();
  return limit >= 0 && smem_bytes(n1, n2, true) <= (size_t)limit;
}

// Copy both hulls of a pair into shared memory, by the whole block.
__device__ __forceinline__ void stage_hulls(const float* v1, int n1, float* s1, const float* v2,
                                            int n2, float* s2, unsigned long long* bar_ptr) {
  const bool bulk1 = hull_in_groups(v1, n1), bulk2 = hull_in_groups(v2, n2);
  const unsigned bar = smem_addr(bar_ptr);
  if (bulk1 || bulk2) {
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();  // the initialised barrier before any wait on it
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, (bulk1 ? 12u * n1 : 0u) + (bulk2 ? 12u * n2 : 0u));
      if (bulk1) bulk_copy(s1, v1, 12u * n1, bar);
      if (bulk2) bulk_copy(s2, v2, 12u * n2, bar);
    }
  }
  if (!bulk1) {
    for (int i = threadIdx.x; i < 3 * n1; i += blockDim.x) s1[i] = v1[i];
  }
  if (!bulk2) {
    for (int i = threadIdx.x; i < 3 * n2; i += blockDim.x) s2[i] = v2[i];
  }
  if (bulk1 || bulk2) mbar_wait_phase0(bar);
  __syncthreads();  // the threads' own copies
}

__device__ __forceinline__ void write_rows(int b, const GjkOut& g, bool* hit_out, int* status_out,
                                           int* iters_out, float* sep_out, float* simplex_out) {
  hit_out[b] = g.status == kHit;
  status_out[b] = g.status;
  iters_out[b] = g.iters;
  sep_out[b] = g.sep;
  float* so = simplex_out + (size_t)b * 12;
  for (int i = 0; i < 4; ++i) {
    so[3 * i] = g.s[i].x;
    so[3 * i + 1] = g.s[i].y;
    so[3 * i + 2] = g.s[i].z;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * kWarp, 1)
gjk_hulls_big_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                     const bool* __restrict__ active, InitDirs dirs, bool* __restrict__ hit_out,
                     int* __restrict__ status_out, int* __restrict__ iters_out,
                     float* __restrict__ sep_out, float* __restrict__ simplex_out, int n1, int n2,
                     GjkParams prm) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  Support support = {p1 + (size_t)b * n1 * 3, n1, p2 + (size_t)b * n2 * 3, n2,
                     reinterpret_cast<Probe*>(smem + kBarWords)};
  if (!active[b]) {  // no probe: the broadphase-miss rows
    if (threadIdx.x == 0) {
      write_rows(b, gjk_phase(support, false, dirs, prm), hit_out, status_out, iters_out,
                 sep_out, simplex_out);
    }
    return;
  }
  if (kStaged) {
    float* s1 = smem + kHeadWords;
    float* s2 = s1 + hull_words(n1);
    stage_hulls(support.v1, n1, s1, support.v2, n2, s2,
                reinterpret_cast<unsigned long long*>(smem));
    support.v1 = s1;
    support.v2 = s2;
  }
  if (threadIdx.x >= kWarp) {
    support.serve();
    return;
  }
  const GjkOut g = gjk_phase(support, true, dirs, prm);
  support.stop();
  if (threadIdx.x == 0) write_rows(b, g, hit_out, status_out, iters_out, sep_out, simplex_out);
}

}  // namespace
}  // namespace gjkepa

// Whether K12 stages the hulls of n1 + n2 vertices in shared memory on the
// current device (else it scans them in device memory).
extern "C" int gjk_hulls_big_staged(int n1, int n2) { return gjkepa::stages(n1, n2); }

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch; the launch is asynchronous on `stream`.  broadphase_tol is not
// read (the broadphase comes in as `active`); it keeps K1's argument order.
extern "C" int gjk_hulls_big_launch(const void* p1, const void* p2, const void* active,
                                    const void* init_dirs_host, void* hit, void* status,
                                    void* iters, void* sep, void* simplex, int B, int n1, int n2,
                                    float eps_coincide, float eps_zero, float eps_sq,
                                    float broadphase_tol, int gjk_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  const bool staged = stages(n1, n2);
  const size_t smem = smem_bytes(n1, n2, staged);
  auto kernel = staged ? gjk_hulls_big_kernel<true> : gjk_hulls_big_kernel<false>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<B, kWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const bool*>(active), dirs, static_cast<bool*>(hit), static_cast<int*>(status),
      static_cast<int*>(iters), static_cast<float*>(sep), static_cast<float*>(simplex), n1, n2,
      prm);
  return (int)cudaGetLastError();
}
