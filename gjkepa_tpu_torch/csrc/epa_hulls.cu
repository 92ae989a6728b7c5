// K2: the EPA capacity cascade over hit lanes, one thread per lane.
//
// Replaces the TPU kernel _epa_cascade_kernel_hulls
// (gjkepa_tpu/ops/fused.py:1112, with _epa_phase_fast :456-749, _epa_cascade
// :837-873 and the merge of _write_epa_out :975-1007).  Plain PyTorch
// version: epa_cascade_plain in gjkepa_tpu_torch/ops/fused_epa.py.
//
// Thread i < n_act takes pair order[i] (the hit lanes, moved to the front by
// one cumsum on the host side, no sync), runs the cascade of epa_core.cuh
// with the hull support, and writes depth, normal, iterations and status to
// pair order[i].  A final-tier capacity exit becomes HIT_EPA_DEGENERATE.
// Threads at i >= n_act return at once; the wrapper has already filled their
// pairs with the miss pass-through.
//
// The polytope state lives in global scratch (see epa_core.cuh); at the c4
// size (16384 lanes, F=208) that is 16384 * 208 * 17 * 4 B = 231 MB, which
// an 80 GB card holds easily.
//
// What bounds it: every iteration scans the lane's F faces in global memory
// (argmin, duplicate test, visible test: about 14 words a face) plus one
// support probe over both hulls; lanes of a warp run different iteration
// counts.  Memory traffic and divergence bound it; keeping the small first
// tier in shared memory is later work.
#include "epa_core.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
epa_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                 const float* __restrict__ simplex, const int* __restrict__ order,
                 const int* __restrict__ n_act, float* __restrict__ depth_out,
                 float* __restrict__ normal_out, int* __restrict__ iters_out,
                 int* __restrict__ status_out, float* __restrict__ scratch, int B, int n1, int n2,
                 Tiers tiers, int f_max, EpaParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || i >= *n_act) return;
  const int lane = order[i];
  const float* v1 = p1 + (size_t)lane * n1 * 3;
  const float* v2 = p2 + (size_t)lane * n2 * 3;
  P3 s[4];
  for (int j = 0; j < 4; ++j) {
    const float* q = simplex + (size_t)lane * 12 + 3 * j;
    s[j] = mk(q[0], q[1], q[2]);
  }
  Faces fs;
  fs.base = scratch + i;
  fs.field_stride = (size_t)f_max * B;
  fs.B = B;

  const HullSupport support = {v1, n1, v2, n2};
  TierOut r = epa_cascade(support, s, tiers, fs, prm);
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

// Words of scratch per face and lane: scratch is (fields, f_max, B) float32.
extern "C" int epa_scratch_words_per_face() { return gjkepa::kFields; }

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch (or an invalid-value code for a tier ladder the kernel does not
// hold); the launch is asynchronous on `stream`.
extern "C" int epa_hulls_launch(const void* p1, const void* p2, const void* simplex,
                                const void* order, const void* n_act, void* depth, void* normal,
                                void* iters, void* status, void* scratch, int B, int n1, int n2,
                                int n_tiers, const int* tier_faces, const int* tier_kvis,
                                int f_max, float eps_coincide, float eps_zero,
                                int epa_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  Tiers tiers;
  const int rc = make_tiers(n_tiers, tier_faces, tier_kvis, f_max, epa_max_iters, &tiers);
  if (rc != 0) return rc;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  const int blocks = (B + kThreads - 1) / kThreads;
  epa_hulls_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(simplex), static_cast<const int*>(order),
      static_cast<const int*>(n_act), static_cast<float*>(depth), static_cast<float*>(normal),
      static_cast<int*>(iters), static_cast<int*>(status), static_cast<float*>(scratch), B, n1,
      n2, tiers, f_max, prm);
  return (int)cudaGetLastError();
}
