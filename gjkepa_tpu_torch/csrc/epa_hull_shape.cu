// K10: the capped EPA cascade and the polish over hull-vs-shape hit lanes, one
// thread per lane.
//
// Replaces the TPU kernel _epa_cascade_kernel_hull_shape
// (gjkepa_tpu/ops/fused.py:2588, with _epa_cascade :837, _polish_direction
// :752 and the merge of _write_epa_out :975-1007).  Plain PyTorch version:
// epa_hull_shape_plain in gjkepa_tpu_torch/ops/fused_hull_shapes.py.
//
// Thread i < n_act (a device scalar) takes pair order[i] (the GJK hits, moved
// to the front by one cumsum, no host sync), runs the capped tier ladder of
// epa_core.cuh on the HullShapeSupport of hull_shape.cuh (two tiers of F=48
// faces, K=8 then K=16 visible faces, at most 16 iterations), refines depth
// and normal with the polish of shape_geom.cuh (valid for any exact support:
// the hull's argmax is exact), maps a surviving capacity exit to
// HIT_EPA_DEGENERATE and writes depth, normal, iterations and status to pair
// order[i].  Every other pair keeps the row the wrapper wrote: zero depth,
// normal and iterations with its GJK status.
//
// What bounds it: the polytope state in global scratch (17 words a face,
// lane-minor) scanned every iteration and the 49 polish probes a lane,
// each probe here a scan of the hull; few lanes (the hits) leave most of the
// card idle, so each lane's chain of dependent loads sets the time.
#include "epa_core.cuh"
#include "hull_shape.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
epa_hull_shape_kernel(const float* __restrict__ p1, const float* __restrict__ sb,
                      const float* __restrict__ simplex, const int* __restrict__ order,
                      const int* __restrict__ n_act, float* __restrict__ depth_out,
                      float* __restrict__ normal_out, int* __restrict__ iters_out,
                      int* __restrict__ status_out, float* __restrict__ scratch, int B, int n1,
                      Tiers tiers, int f_max, EpaParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || i >= *n_act) return;
  const int lane = order[i];
  const HullShapeSupport support = {p1 + (size_t)lane * n1 * 3, n1, load_shape(sb, lane)};
  P3 s[4];
  for (int j = 0; j < 4; ++j) {
    const float* q = simplex + (size_t)lane * 12 + 3 * j;
    s[j] = mk(q[0], q[1], q[2]);
  }
  Faces fs;
  fs.base = scratch + i;
  fs.field_stride = (size_t)f_max * B;
  fs.B = B;

  TierOut r = epa_cascade(support, s, tiers, fs, prm);
  polish_direction(support, &r.depth, &r.normal, &r.status);
  if (r.status == kHitEpaCapacity) r.status = kHitEpaDegenerate;
  depth_out[lane] = r.depth;
  normal_out[3 * lane] = r.normal.x;
  normal_out[3 * lane + 1] = r.normal.y;
  normal_out[3 * lane + 2] = r.normal.z;
  iters_out[lane] = r.iters;
  status_out[lane] = r.status;
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch (or an invalid-value code for a tier ladder the kernel does not
// hold); the launch is asynchronous on `stream`.  Scratch is
// (epa_scratch_words_per_face(), f_max, B) float32.
extern "C" int epa_hull_shape_launch(const void* p1, const void* sb, const void* simplex,
                                     const void* order, const void* n_act, void* depth,
                                     void* normal, void* iters, void* status, void* scratch,
                                     int B, int n1, int n_tiers, const int* tier_faces,
                                     const int* tier_kvis, int f_max, float eps_coincide,
                                     float eps_zero, int epa_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  Tiers tiers;
  const int rc = make_tiers(n_tiers, tier_faces, tier_kvis, f_max, epa_max_iters, &tiers);
  if (rc != 0) return rc;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  const int blocks = (B + kThreads - 1) / kThreads;
  epa_hull_shape_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(sb),
      static_cast<const float*>(simplex), static_cast<const int*>(order),
      static_cast<const int*>(n_act), static_cast<float*>(depth), static_cast<float*>(normal),
      static_cast<int*>(iters), static_cast<int*>(status), static_cast<float*>(scratch), B, n1,
      tiers, f_max, prm);
  return (int)cudaGetLastError();
}
