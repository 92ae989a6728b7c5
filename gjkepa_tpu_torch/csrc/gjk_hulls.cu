// K1: broadphase + GJK over hull pairs, a team of T threads per pair.
//
// Replaces the TPU kernel _gjk_kernel_hulls (gjkepa_tpu/ops/fused.py:1099,
// with _hull_broadphase :876, _make_hull_support :237 and _gjk_phase
// :262-453).  Plain PyTorch version: gjk_hulls_plain in
// gjkepa_tpu_torch/ops/fused_gjk.py.
//
// A team of T threads (T in 4, 8, 16, 32; the wrapper picks T from the hull
// size) reads one pair's two hulls from (B, N, 3) row-major global memory,
// runs the bounding-sphere broadphase and the GJK phase of gjk_core.cuh
// (the staged v1-v4 init over the first 8 direction-table rows and the
// always-tetra loop with the simplex in registers) with the team support of
// hull_stream.cuh, every thread of the team on the same inputs, and thread
// 0 of the team writes hit, status, iterations, the separation lower bound
// and the 4x3 simplex.  The centroid is summed in vertex order by every
// thread (the broadphase verdict keeps the thread-per-pair rounding), the
// radius and each support probe are split across the team.
//
// What bounds it: every support probe scans both hulls, 24*N bytes per pair
// (c2: 65,536 pairs x 64 vertices, 100 MB of hulls, more than the L2).  One
// thread per pair left neighbouring threads 12*N bytes apart, so no load
// coalesced; a team's loads cover 48*T neighbouring bytes (float4 words of
// 4-vertex groups, hull_stream.cuh), and the centroid's serial sum reads
// float4 words too.  On an H100 the fastest team grew with the hull: 4
// threads up to 64 vertices, 8 up to 256, 16 at 512, 32 from 1024 on
// (fused_gjk.team_size; PERF.md).  A small team serves more pairs a warp,
// and every thread of a team pays the whole serial centroid; a large team
// splits the probes of a large hull and fills the card with few pairs.
// Iteration counts differ between pairs, so the teams of one warp diverge;
// each team's shuffles name only its own lanes.
//
// Without the broadphase (fused_gjkepa_hulls(..., use_broadphase=False),
// the TPU kernel's use_broadphase=False branch, :1105-1108) every pair runs
// GJK as active and no team computes a sphere.  The mode is a template
// parameter, so the broadphase's instantiations compile as before.
#include "gjk_core.cuh"
#include "hull_stream.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

template <int T, bool kBroadphase>
__global__ void __launch_bounds__(kThreads)
gjk_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2, InitDirs dirs,
                 bool* __restrict__ hit_out, int* __restrict__ status_out,
                 int* __restrict__ iters_out, float* __restrict__ sep_out,
                 float* __restrict__ simplex_out, int B, int n1, int n2, GjkParams prm) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) / T;
  if (b >= B) return;  // the whole team
  const float* v1 = p1 + (size_t)b * n1 * 3;
  const float* v2 = p2 + (size_t)b * n2 * 3;

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

template <int T, bool kBroadphase>
void launch(const float* p1, const float* p2, const InitDirs& dirs, bool* hit, int* status,
            int* iters, float* sep, float* simplex, int B, int n1, int n2,
            const GjkParams& prm, cudaStream_t stream) {
  const int blocks = (int)(((long long)B * T + kThreads - 1) / kThreads);
  gjk_hulls_kernel<T, kBroadphase><<<blocks, kThreads, 0, stream>>>(
      p1, p2, dirs, hit, status, iters, sep, simplex, B, n1, n2, prm);
}

using Launch = void (*)(const float*, const float*, const InitDirs&, bool*, int*, int*, float*,
                        float*, int, int, int, const GjkParams&, cudaStream_t);

template <bool kBroadphase>
Launch launcher(int team) {
  return team == 4    ? &launch<4, kBroadphase>
         : team == 8  ? &launch<8, kBroadphase>
         : team == 16 ? &launch<16, kBroadphase>
         : team == 32 ? &launch<32, kBroadphase>
                      : nullptr;
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  `team` is the threads per pair (4, 8, 16
// or 32; any other value returns cudaErrorInvalidValue); `use_broadphase`
// 0 runs GJK on every pair.  Returns cudaGetLastError() after the launch;
// the launch is asynchronous on `stream`.
extern "C" int gjk_hulls_launch(const void* p1, const void* p2, const void* init_dirs_host,
                                void* hit, void* status, void* iters, void* sep,
                                void* simplex, int B, int n1, int n2, int team,
                                int use_broadphase, float eps_coincide, float eps_zero,
                                float eps_sq, float broadphase_tol, int gjk_max_iters,
                                void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  const Launch fn = use_broadphase ? launcher<true>(team) : launcher<false>(team);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  fn(static_cast<const float*>(p1), static_cast<const float*>(p2), dirs,
     static_cast<bool*>(hit), static_cast<int*>(status), static_cast<int*>(iters),
     static_cast<float*>(sep), static_cast<float*>(simplex), B, n1, n2, prm,
     static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
