// K5: the closed-form shape kernel, one thread per pair, in the caller's order.
//
// Replaces the TPU kernel _cf_kernel_shapes (gjkepa_tpu/ops/fused.py:1880,
// with the closed forms _closed_form_rows :1662 and the broadphase
// _shape_broadphase :1654).  Plain PyTorch version: cf_shapes_plain in
// gjkepa_tpu_torch/ops/fused_shapes.py.
//
// A closed-form lane (sphere/capsule pairs, sphere-box, box-box,
// sphere-cylinder) gets its exact hit, status, depth, normal and distance;
// every other lane gets the broadphase-miss row (status MISS_BROADPHASE,
// zeros), which is also the row K6a writes for a lane its GJK phase finds
// inactive.  The kernel also writes `act`, the GJK activity of the lane
// (bounding-sphere overlap, no closed form, not retired by the capsule
// envelope): the dispatch compacts the GJK lanes on it, so every lane K6a
// runs is active in K6a's own test, which uses the same device functions.
//
// What bounds it: 64 bytes of shape rows in and 25 bytes out per pair, and a
// few hundred flops (the box-box SAT is the longest branch); lanes of a warp
// take different kind branches.  It is a short memory-bound pass; the rows
// are read with 16-byte loads.
#include "shape_geom.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cf_shapes_kernel(const float* __restrict__ sa, const float* __restrict__ sb,
                 const bool* __restrict__ retired, bool* __restrict__ hit_out,
                 int* __restrict__ status_out, float* __restrict__ depth_out,
                 float* __restrict__ normal_out, float* __restrict__ dist_out,
                 bool* __restrict__ act_out, int B, float bp_tol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const Shape a = load_shape(sa, i), b = load_shape(sb, i);
  const ClosedForm cf = closed_form(a, b, bp_tol);
  const int status = cf.final ? cf.status : kMissBroadphase;
  hit_out[i] = status == kHit;
  status_out[i] = status;
  depth_out[i] = cf.depth;  // depth and normal are zero off the closed-form hits
  normal_out[3 * i] = cf.normal.x;
  normal_out[3 * i + 1] = cf.normal.y;
  normal_out[3 * i + 2] = cf.normal.z;
  dist_out[i] = cf.final ? fmaxf(cf.gap, 0.0f) : 0.0f;
  act_out[i] = !cf.final && !retired[i] && shape_broadphase(a, b, bp_tol);
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch; the launch is asynchronous on `stream`.
extern "C" int cf_shapes_launch(const void* sa, const void* sb, const void* retired, void* hit,
                                void* status, void* depth, void* normal, void* distance,
                                void* act, int B, float broadphase_tol, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  cf_shapes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const bool*>(retired), static_cast<bool*>(hit), static_cast<int*>(status),
      static_cast<float*>(depth), static_cast<float*>(normal), static_cast<float*>(distance),
      static_cast<bool*>(act), B, broadphase_tol);
  return (int)cudaGetLastError();
}
