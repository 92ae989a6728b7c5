// K1: broadphase + GJK over hull pairs, a team of T threads per pair.
//
// Replaces the TPU kernel _gjk_kernel_hulls (gjkepa_tpu/ops/fused.py:1099,
// with _hull_broadphase :876, _make_hull_support :237 and _gjk_phase
// :262-453).  Plain PyTorch version: gjk_hulls_plain in
// gjkepa_tpu_torch/ops/fused_gjk.py.
//
// A team of T threads takes one pair's two hulls, runs the bounding-sphere
// broadphase and the GJK phase of gjk_core.cuh (the staged v1-v4 init over
// the first 8 direction-table rows and the always-tetra loop with the
// simplex in registers) with the team support of hull_stream.cuh, every
// thread of the team on the same inputs, and thread 0 of the team writes
// hit, status, iterations, the separation lower bound and the 4x3 simplex.
// The centroid is summed in vertex order by every thread (the broadphase
// verdict keeps the thread-per-pair rounding), the radius and each support
// probe are split across the team.  Two instantiations of the same kernel,
// by where the hulls lie.
//
// Staged (kStaged, teams of 2 or 8): a block of 32 * T threads serves P =
// 32 consecutive pairs, whose hulls are two contiguous spans of (B, N, 3)
// memory.  The block copies them once into dynamic shared memory, every
// pair's hull 1, then every pair's hull 2: where a hull reads as float4
// groups (N % 4 == 0, 16-B aligned) by one bulk copy of the Tensor Memory
// Accelerator a hull, issued by the team's first thread and completing on
// one mbarrier, else by the block's coalesced loads, a warp a hull.  The
// sphere's two passes and every probe of gjk_phase then read shared memory,
// so each hull byte crosses from device memory once a call.  Layout: each
// hull row-major (N, 3), 16-B aligned (so hull_in_groups keeps its float4
// path), at a stride of an odd number of 16-B words (staged_words): a
// 64-vertex hull is 768 B = 192 words, 0 mod 32, so unpadded the teams of
// a warp summing their centroids would read one bank; at 196 words any
// eight consecutive pairs start on eight disjoint groups of four banks,
// and a probe's float4 loads (thread t of a team at 4-vertex group t)
// spread evenly over them.  The sums are the streamed kernel's, over the
// same values in the same order, so the rows are bit for bit the streamed
// kernel's and gjk_hulls_plain's.
//
// Streamed (teams of 4-32, fused_gjk.team_size): a block of kThreads
// threads, each team reading its pair's hulls from device memory on every
// probe (24*N bytes) and twice for the sphere; a team's loads cover 48*T
// neighbouring bytes (float4 words of 4-vertex groups, hull_stream.cuh).
// On an H100 the fastest streamed team grew with the hull: 4 threads up to
// 64 vertices, 8 up to 256, 16 at 512, 32 from 1024 on.
//
// The rule (fused_gjk.stages, a function of (n1, n2)): the staged kernel
// runs while a block's tile, gjk_hulls_staged_bytes(n1, n2), fits
// fused_gjk.STAGED_BUDGET (two blocks an SM: up to 148 vertices a hull);
// past it the streamed kernel runs.  The staged team (fused_gjk.staged_team)
// is 2 up to 64 vertices a hull in batches of 16,384 pairs or more (about
// four blocks an SM), else 8: in a smaller batch a team of 2 leaves an SM
// a block, two warps.  Each staged
// instantiation opts into the device's most shared memory a block once a
// device (opt_in_once), not at every launch.
//
// What bounds it (H100, PERF.md): not the hull bytes.  The team's serial
// geometry between probes is, at the resident pairs an SM holds: 122
// registers a thread (107 staged) and the 208 B stack of gjk_phase keep
// the streamed kernel at 16 warps, 128 pairs, an SM, and a 64-vertex
// tile of 32 pairs (50 KB) lets four blocks, 128 pairs, stay an SM.
// Staging removes the sphere's passes and the probes' device reads, and
// with them about a sixth of the time: at c2 (65,536 x 64) the staged
// kernel took 0.2206 ms against the streamed 0.2713 (0.1967 against
// 0.2281 without the broadphase), at c4 (16,384 x 24) 0.0224 against
// 0.0227 (0.0199 against 0.0222), against a byte bound of 0.030 ms at c2.
// In batches of 4,096-8,192 pairs the two kernels are within 7%.
//
// Without the broadphase (fused_gjkepa_hulls(..., use_broadphase=False),
// the TPU kernel's use_broadphase=False branch, :1105-1108) every pair runs
// GJK as active and no team computes a sphere.  The mode is a template
// parameter, so the broadphase's instantiations compile as before.
#include <atomic>

#include "gjk_core.cuh"
#include "hull_stream.cuh"
#include "tma_stage.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;
constexpr int kStagedPairs = 32;  // P, the pairs a staged block
constexpr int kBarWords = 4;  // the mbarrier (8 B), padded to 16

// The words of a staged hull of n vertices: 3n rounded up to whole 16-B
// words, then to an odd number of them.
__host__ __device__ constexpr int staged_words(int n) { return 4 * (((3 * n + 3) >> 2) | 1); }

// The staged kernel's dynamic shared memory a block.
inline size_t staged_bytes(int n1, int n2) {
  return ((size_t)kBarWords + (size_t)kStagedPairs * (staged_words(n1) + staged_words(n2))) *
         sizeof(float);
}

// Copy `pairs` consecutive hulls of n vertices (row-major, 3n words apart
// from `src`) to `w` words apart from `dst`: a warp a hull, a word a lane.
__device__ __forceinline__ void copy_hulls(const float* __restrict__ src, int n, float* dst,
                                           int w, int pairs) {
  const int lane = threadIdx.x & (kWarp - 1);
  for (int p = threadIdx.x / kWarp; p < pairs; p += blockDim.x / kWarp) {
    for (int i = lane; i < 3 * n; i += kWarp) dst[p * w + i] = src[(size_t)p * 3 * n + i];
  }
}

// Copy the hulls of a block's `pairs` pairs into shared memory (s1, s2, at
// strides w1, w2), by the whole block; team p's first thread issues pair
// p's bulk copies.
template <int T>
__device__ __forceinline__ void stage_pairs(const float* src1, int n1, float* s1, int w1,
                                            const float* src2, int n2, float* s2, int w2,
                                            int pairs, unsigned long long* bar_ptr) {
  const bool bulk1 = hull_in_groups(src1, n1), bulk2 = hull_in_groups(src2, n2);
  const unsigned bar = smem_addr(bar_ptr);
  if (bulk1 || bulk2) {
    if (threadIdx.x == 0) {  // armed with every byte before any copy is issued
      const unsigned bytes = pairs * ((bulk1 ? 12u * n1 : 0u) + (bulk2 ? 12u * n2 : 0u));
      mbar_init(bar);
      mbar_expect_tx(bar, bytes);
    }
    __syncthreads();
    const int p = threadIdx.x / T;
    if ((threadIdx.x & (T - 1)) == 0 && p < pairs) {
      if (bulk1) bulk_copy(s1 + p * w1, src1 + (size_t)p * 3 * n1, 12u * n1, bar);
      if (bulk2) bulk_copy(s2 + p * w2, src2 + (size_t)p * 3 * n2, 12u * n2, bar);
    }
  }
  if (!bulk1) copy_hulls(src1, n1, s1, w1, pairs);
  if (!bulk2) copy_hulls(src2, n2, s2, w2, pairs);
  if (bulk1 || bulk2) mbar_wait_phase0(bar);
  __syncthreads();  // the threads' own copies
}

template <int T, bool kBroadphase, bool kStaged>
__global__ void __launch_bounds__(kStaged ? kStagedPairs * T : kThreads)
gjk_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2, InitDirs dirs,
                 bool* __restrict__ hit_out, int* __restrict__ status_out,
                 int* __restrict__ iters_out, float* __restrict__ sep_out,
                 float* __restrict__ simplex_out, int B, int n1, int n2, GjkParams prm) {
  constexpr int kPairs = kStaged ? kStagedPairs : kThreads / T;
  const int b = blockIdx.x * kPairs + threadIdx.x / T;
  const float* v1 = p1 + (size_t)b * n1 * 3;
  const float* v2 = p2 + (size_t)b * n2 * 3;
  if constexpr (kStaged) {
    extern __shared__ __align__(16) float smem[];
    const int b0 = blockIdx.x * kPairs, w1 = staged_words(n1), w2 = staged_words(n2);
    float* s1 = smem + kBarWords;
    float* s2 = s1 + kPairs * w1;
    stage_pairs<T>(p1 + (size_t)b0 * n1 * 3, n1, s1, w1, p2 + (size_t)b0 * n2 * 3, n2, s2, w2,
                   min(kPairs, B - b0), reinterpret_cast<unsigned long long*>(smem));
    v1 = s1 + (threadIdx.x / T) * w1;
    v2 = s2 + (threadIdx.x / T) * w2;
  }
  if (b >= B) return;  // the whole team, after the block's staging

  bool active = true;
  if constexpr (kBroadphase) {
    P3 c1, c2;
    float r1, r2;
    team_bounding_sphere<T>(v1, n1, &c1, &r1);
    team_bounding_sphere<T>(v2, n2, &c2, &r2);
    active = norm(sub(c1, c2)) <= r1 + r2 + prm.bp_tol;
  }

  const TeamHullSupport<T> support = {v1, n1, v2, n2};
  const GjkOut g = gjk_phase(support, active, dirs, prm);
  if ((threadIdx.x & (T - 1)) != 0) return;
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

// Opt `kernel` into the device's most dynamic shared memory a block, once
// a device (`done`: a bit a device ordinal, one set a kernel).  Returns 0
// or the CUDA error.
template <class Kernel>
int opt_in_once(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  }
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

template <int T, bool kBroadphase, bool kStaged>
int launch(const float* p1, const float* p2, const InitDirs& dirs, bool* hit, int* status,
           int* iters, float* sep, float* simplex, int B, int n1, int n2, const GjkParams& prm,
           cudaStream_t stream) {
  constexpr int threads = kStaged ? kStagedPairs * T : kThreads;
  const auto kernel = gjk_hulls_kernel<T, kBroadphase, kStaged>;
  size_t smem = 0;
  if constexpr (kStaged) {
    static std::atomic<unsigned long long> opted{0};
    const int err = opt_in_once(kernel, opted);
    if (err != 0) return err;
    smem = staged_bytes(n1, n2);
  }
  const int blocks = (int)(((long long)B * T + threads - 1) / threads);
  kernel<<<blocks, threads, smem, stream>>>(p1, p2, dirs, hit, status, iters, sep, simplex, B,
                                            n1, n2, prm);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const float*, const float*, const InitDirs&, bool*, int*, int*, float*,
                       float*, int, int, int, const GjkParams&, cudaStream_t);

// The streamed kernel's teams (fused_gjk.TEAMS) and the staged one's
// (fused_gjk.STAGED_TEAMS).
template <bool kBroadphase>
Launch streamed(int team) {
  return team == 4    ? &launch<4, kBroadphase, false>
         : team == 8  ? &launch<8, kBroadphase, false>
         : team == 16 ? &launch<16, kBroadphase, false>
         : team == 32 ? &launch<32, kBroadphase, false>
                      : nullptr;
}

template <bool kBroadphase>
Launch staged(int team) {
  return team == 2 ? &launch<2, kBroadphase, true>
         : team == 8 ? &launch<8, kBroadphase, true>
                     : nullptr;
}

}  // namespace
}  // namespace gjkepa

// The staged kernel's shared memory a block (bytes) for hulls of n1 and n2
// vertices.
extern "C" int gjk_hulls_staged_bytes(int n1, int n2) {
  return (int)gjkepa::staged_bytes(n1, n2);
}

// C interface, bound with ctypes.  `team` is the threads per pair (the
// streamed kernel's 4, 8, 16 or 32, the staged one's 2 or 8; any other
// value returns cudaErrorInvalidValue); `use_broadphase` 0 runs GJK on
// every pair; `staged` 1 runs the staged kernel (the hulls in shared
// memory), 0 the streamed one.  Returns the CUDA error of the
// shared-memory opt-in or cudaGetLastError() after the launch; the launch
// is asynchronous on `stream`.
extern "C" int gjk_hulls_launch(const void* p1, const void* p2, const void* init_dirs_host,
                                void* hit, void* status, void* iters, void* sep,
                                void* simplex, int B, int n1, int n2, int team,
                                int use_broadphase, int staged, float eps_coincide,
                                float eps_zero, float eps_sq, float broadphase_tol,
                                int gjk_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  const Launch fn = use_broadphase ? (staged ? gjkepa::staged<true>(team) : streamed<true>(team))
                                   : (staged ? gjkepa::staged<false>(team) : streamed<false>(team));
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(static_cast<const float*>(p1), static_cast<const float*>(p2), dirs,
            static_cast<bool*>(hit), static_cast<int*>(status), static_cast<int*>(iters),
            static_cast<float*>(sep), static_cast<float*>(simplex), B, n1, n2, prm,
            static_cast<cudaStream_t>(stream));
}
