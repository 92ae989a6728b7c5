// K5: the closed-form shape kernel, a thread a pair in the caller's order.
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
// What bounds it: 129 bytes in (two 64-byte rows and the retirement bit)
// and 26 out per pair, and a few hundred flops: a memory-bound pass with
// one long branch, the box-box SAT (15 axes, each with a square root and a
// divide).  On an H100 (PERF.md, Findings) a
// kernel that only moves these bytes takes ~4.0 us at c3.  The first
// version of this kernel took 7.2 us in natural order, its box quarter
// alone 6.5 us: the SAT loop kept its axes in local memory (a 72-byte
// stack).  Unrolled (shape_geom.cuh), the axes stay in registers, and the
// kernel takes ~5.5 us natural and ~7.8 shuffled.  Of the ~2.2 us, warps
// that mix branches cost ~1 (the shuffled pairs sorted by kind in each
// block of 128 take ~6.9), and where the box pairs fall in the batch the
// other ~1 (whole warps of one kind in a random order take ~6.6).  Staging
// a block's rows in shared memory, and dealing its pairs into one list per
// branch, cost more than they saved in both orders (PERF.md).
#include "shape_geom.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

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
