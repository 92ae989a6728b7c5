// K6a and K6b: GJK over analytic shape pairs, one thread per pair.
//
// K6a replaces the TPU kernel _gjk_sub_kernel_shapes
// (gjkepa_tpu/ops/fused.py:1910), K6b replaces _gjk_kernel_shapes (:1935);
// both run the GJK phase of gjk_core.cuh with the shape support of
// shape_geom.cuh.  Plain PyTorch versions: gjk_sub_shapes_plain and
// gjk_shapes_plain in gjkepa_tpu_torch/ops/fused_shapes.py.
//
// Activity is the same in both: bounding-sphere overlap, no closed form,
// and not retired (the capsule-envelope bit the dispatch decides once and
// passes in; the kernels read it and never recompute it).
//
//   K6a runs over the compacted GJK lanes: thread i < n_act (a device
//       scalar) takes pair order[i] and writes its hit, status, iterations,
//       separation and simplex to pair order[i]; the wrapper has filled the
//       other pairs with the inactive row.
//   K6b runs over every pair in the caller's order and also writes the
//       closed-form channel (final flag, depth, normal); a closed-form
//       lane's status and separation come from the closed form.
//
// What bounds it: each support probe is a few dozen flops on the 128 bytes
// of the pair's two shapes, held in registers, so the kernel is bound by
// compute and by divergence: iteration counts and kind branches differ
// between the lanes of a warp.  K6a keeps the warps of the split pipeline
// full of GJK lanes; K6b lets closed-form and missing lanes idle beside
// them.
#include "gjk_core.cuh"
#include "shape_geom.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void write_gjk(const GjkOut& g, int lane, bool* __restrict__ hit_out,
                                          int* __restrict__ status_out,
                                          int* __restrict__ iters_out,
                                          float* __restrict__ sep_out,
                                          float* __restrict__ simplex_out) {
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

__global__ void __launch_bounds__(kThreads)
gjk_sub_shapes_kernel(const float* __restrict__ sa, const float* __restrict__ sb,
                      const bool* __restrict__ retired, const int* __restrict__ order,
                      const int* __restrict__ n_act, InitDirs dirs, bool* __restrict__ hit_out,
                      int* __restrict__ status_out, int* __restrict__ iters_out,
                      float* __restrict__ sep_out, float* __restrict__ simplex_out, int B,
                      GjkParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || i >= *n_act) return;
  const int lane = order[i];
  const ShapeSupport support = {load_shape(sa, lane), load_shape(sb, lane)};
  const bool active = shape_broadphase(support.a, support.b, prm.bp_tol) &&
                      !cf_kind_mask(support.a.kind, support.b.kind) && !retired[lane];
  const GjkOut g = gjk_phase(support, active, dirs, prm);
  write_gjk(g, lane, hit_out, status_out, iters_out, sep_out, simplex_out);
}

__global__ void __launch_bounds__(kThreads)
gjk_shapes_kernel(const float* __restrict__ sa, const float* __restrict__ sb,
                  const bool* __restrict__ retired, InitDirs dirs, bool* __restrict__ hit_out,
                  int* __restrict__ status_out, int* __restrict__ iters_out,
                  float* __restrict__ sep_out, float* __restrict__ simplex_out,
                  bool* __restrict__ final_out, float* __restrict__ cf_depth_out,
                  float* __restrict__ cf_normal_out, int B, GjkParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const ShapeSupport support = {load_shape(sa, i), load_shape(sb, i)};
  const ClosedForm cf = closed_form(support.a, support.b, prm.bp_tol);
  const bool active =
      shape_broadphase(support.a, support.b, prm.bp_tol) && !cf.final && !retired[i];
  GjkOut g = gjk_phase(support, active, dirs, prm);
  if (cf.final) {
    g.status = cf.status;
    g.sep = fmaxf(cf.gap, 0.0f);
  }
  write_gjk(g, i, hit_out, status_out, iters_out, sep_out, simplex_out);
  final_out[i] = cf.final;
  cf_depth_out[i] = cf.depth;
  cf_normal_out[3 * i] = cf.normal.x;
  cf_normal_out[3 * i + 1] = cf.normal.y;
  cf_normal_out[3 * i + 2] = cf.normal.z;
}

}  // namespace
}  // namespace gjkepa

// C interfaces, bound with ctypes.  Each returns cudaGetLastError() after
// the launch; the launch is asynchronous on `stream`.
extern "C" int gjk_sub_shapes_launch(const void* sa, const void* sb, const void* retired,
                                     const void* order, const void* n_act,
                                     const void* init_dirs_host, void* hit, void* status,
                                     void* iters, void* sep, void* simplex, int B,
                                     float eps_coincide, float eps_zero, float eps_sq,
                                     float broadphase_tol, int gjk_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  const int blocks = (B + kThreads - 1) / kThreads;
  gjk_sub_shapes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const bool*>(retired), static_cast<const int*>(order),
      static_cast<const int*>(n_act), dirs, static_cast<bool*>(hit), static_cast<int*>(status),
      static_cast<int*>(iters), static_cast<float*>(sep), static_cast<float*>(simplex), B, prm);
  return (int)cudaGetLastError();
}

extern "C" int gjk_shapes_launch(const void* sa, const void* sb, const void* retired,
                                 const void* init_dirs_host, void* hit, void* status, void* iters,
                                 void* sep, void* simplex, void* final_flag, void* cf_depth,
                                 void* cf_normal, int B, float eps_coincide, float eps_zero,
                                 float eps_sq, float broadphase_tol, int gjk_max_iters,
                                 void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  const int blocks = (B + kThreads - 1) / kThreads;
  gjk_shapes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const bool*>(retired), dirs, static_cast<bool*>(hit), static_cast<int*>(status),
      static_cast<int*>(iters), static_cast<float*>(sep), static_cast<float*>(simplex),
      static_cast<bool*>(final_flag), static_cast<float*>(cf_depth),
      static_cast<float*>(cf_normal), B, prm);
  return (int)cudaGetLastError();
}
