// K12: GJK over large hull pairs, one warp per pair.
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
// The 32 threads of a warp run the GJK phase of gjk_core.cuh on the same
// pair, each with the same inputs, so their control flow is the same and
// each support probe finds all 32 at its shuffles; thread 0 writes hit,
// status, iterations, the separation lower bound and the 4x3 simplex.  A
// warp whose pair index is past B returns whole.
//
// What bounds it: the support probes, each a read of both hulls, 12 *
// (n1 + n2) bytes (98 KB at n1 = n2 = 4096), about 6 + iterations probes a
// pair; the GJK arithmetic between probes is a few hundred operations.
// Small blocks (kWarpsPerBlock warps) spread 256 pairs over most of the
// SMs.
#include "gjk_core.cuh"
#include "hull_stream.cuh"

namespace gjkepa {
namespace {

constexpr int kWarpsPerBlock = 2;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
gjk_hulls_big_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                     const bool* __restrict__ active, InitDirs dirs, bool* __restrict__ hit_out,
                     int* __restrict__ status_out, int* __restrict__ iters_out,
                     float* __restrict__ sep_out, float* __restrict__ simplex_out, int B, int n1,
                     int n2, GjkParams prm) {
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (b >= B) return;  // the whole warp
  const WarpHullSupport support = {p1 + (size_t)b * n1 * 3, n1, p2 + (size_t)b * n2 * 3, n2};
  const GjkOut g = gjk_phase(support, active[b], dirs, prm);
  if ((threadIdx.x & (kWarp - 1)) != 0) return;
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
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gjk_hulls_big_kernel<<<blocks, kWarpsPerBlock * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const bool*>(active), dirs, static_cast<bool*>(hit), static_cast<int*>(status),
      static_cast<int*>(iters), static_cast<float*>(sep), static_cast<float*>(simplex), B, n1, n2,
      prm);
  return (int)cudaGetLastError();
}
