// K9: GJK over hull-vs-shape pairs, one thread per pair.
//
// Replaces the TPU kernel _gjk_kernel_hull_shape (gjkepa_tpu/ops/fused.py:2571):
// the GJK phase of gjk_core.cuh on the HullShapeSupport of hull_shape.cuh.
// Plain PyTorch version: gjk_hull_shape_plain in
// gjkepa_tpu_torch/ops/fused_hull_shapes.py.
//
// Thread i takes pair order[i] (a permutation of all B pairs: the dispatch
// puts the lanes a bounding-sphere predicate marks active first, so they fill
// whole warps).  A lane runs GJK when the hull-shape broadphase passes and
// the dispatch has not retired it (the sphere-envelope bit, decided once in
// torch); every lane runs through the order, so the predicate only groups the
// lanes and never decides which run.  It writes hit, status, iterations, the
// separation lower bound and the simplex to pair order[i].
//
// What bounds it: each support probe scans the hull (12*N bytes, not coalesced
// across a warp: neighbouring threads read rows 12*N bytes apart) and
// evaluates the shape's closed-form support; iteration counts and shape kinds
// differ between the lanes of a warp.  Bound by the scans' latency and by
// divergence, as K1.
#include "gjk_core.cuh"
#include "hull_shape.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gjk_hull_shape_kernel(const float* __restrict__ p1, const float* __restrict__ sb,
                      const bool* __restrict__ retired, const int* __restrict__ order,
                      InitDirs dirs, bool* __restrict__ hit_out, int* __restrict__ status_out,
                      int* __restrict__ iters_out, float* __restrict__ sep_out,
                      float* __restrict__ simplex_out, int B, int n1, GjkParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int lane = order[i];
  const float* v1 = p1 + (size_t)lane * n1 * 3;
  const HullShapeSupport support = {v1, n1, load_shape(sb, lane)};
  const bool active = hull_shape_broadphase(v1, n1, support.b, prm.bp_tol) && !retired[lane];
  const GjkOut g = gjk_phase(support, active, dirs, prm);
  hit_out[lane] = g.status == kHit;
  status_out[lane] = g.status;
  iters_out[lane] = g.iters;
  sep_out[lane] = g.sep;
  float* so = simplex_out + (size_t)lane * 12;
  for (int j = 0; j < 4; ++j) {
    so[3 * j] = g.s[j].x;
    so[3 * j + 1] = g.s[j].y;
    so[3 * j + 2] = g.s[j].z;
  }
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch; the launch is asynchronous on `stream`.
extern "C" int gjk_hull_shape_launch(const void* p1, const void* sb, const void* retired,
                                     const void* order, const void* init_dirs_host, void* hit,
                                     void* status, void* iters, void* sep, void* simplex, int B,
                                     int n1, float eps_coincide, float eps_zero, float eps_sq,
                                     float broadphase_tol, int gjk_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  const int blocks = (B + kThreads - 1) / kThreads;
  gjk_hull_shape_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(sb),
      static_cast<const bool*>(retired), static_cast<const int*>(order), dirs,
      static_cast<bool*>(hit), static_cast<int*>(status), static_cast<int*>(iters),
      static_cast<float*>(sep), static_cast<float*>(simplex), B, n1, prm);
  return (int)cudaGetLastError();
}
