// K1: broadphase + GJK over hull pairs, one thread per pair.
//
// Replaces the TPU kernel _gjk_kernel_hulls (gjkepa_tpu/ops/fused.py:1099,
// with _hull_broadphase :876, _make_hull_support :237 and _gjk_phase
// :262-453).  Plain PyTorch version: gjk_hulls_plain in
// gjkepa_tpu_torch/ops/fused_gjk.py.
//
// Each thread reads its two hulls from (B, N, 3) row-major global memory,
// runs the bounding-sphere broadphase and the GJK phase of gjk_core.cuh
// (the staged v1-v4 init over the first 8 direction-table rows and the
// always-tetra loop with the simplex in registers) with the hull support,
// and writes hit, status, iterations, the separation lower bound and the
// 4x3 simplex.
//
// What bounds it: every support probe scans both hulls, 24*N bytes per pair,
// and neighbouring threads read addresses 12*N bytes apart, so a warp's loads
// do not coalesce; iteration counts differ between pairs, so warps diverge.
// The kernel is bandwidth- and divergence-bound.  Coalescing the vertex
// reads across a warp (or a warp per pair sharing the argmax) is later work;
// this first form is the plain per-pair loop, kept simple and exact.
#include "gjk_core.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gjk_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2, InitDirs dirs,
                 bool* __restrict__ hit_out, int* __restrict__ status_out,
                 int* __restrict__ iters_out, float* __restrict__ sep_out,
                 float* __restrict__ simplex_out, int B, int n1, int n2, GjkParams prm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* v1 = p1 + (size_t)b * n1 * 3;
  const float* v2 = p2 + (size_t)b * n2 * 3;

  P3 c1, c2;
  float r1, r2;
  bounding_sphere(v1, n1, &c1, &r1);
  bounding_sphere(v2, n2, &c2, &r2);
  const bool active = norm(sub(c1, c2)) <= r1 + r2 + prm.bp_tol;

  const HullSupport support = {v1, n1, v2, n2};
  const GjkOut g = gjk_phase(support, active, dirs, prm);
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

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch; the launch is asynchronous on `stream`.
extern "C" int gjk_hulls_launch(const void* p1, const void* p2, const void* init_dirs_host,
                                void* hit, void* status, void* iters, void* sep,
                                void* simplex, int B, int n1, int n2, float eps_coincide, float eps_zero, float eps_sq,
                                float broadphase_tol, int gjk_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  const int blocks = (B + kThreads - 1) / kThreads;
  gjk_hulls_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2), dirs,
      static_cast<bool*>(hit), static_cast<int*>(status), static_cast<int*>(iters),
      static_cast<float*>(sep), static_cast<float*>(simplex), B, n1, n2, prm);
  return (int)cudaGetLastError();
}
