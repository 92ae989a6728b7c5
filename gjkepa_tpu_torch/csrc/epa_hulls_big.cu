// K13: the EPA capacity cascade over large hull pairs, one warp per hit.
//
// Replaces the TPU kernel _epa_cascade_kernel_hulls_big
// (gjkepa_tpu/ops/fused.py:1086, with _epa_cascade :837-873 over the tier
// ladder of _cascade_plan :1147, and the merge of _write_epa_out :975-1007)
// over the streamed support _make_hull_support_streamed (:1010, K11:
// hull_stream.cuh).  Plain PyTorch version: epa_cascade_plain in
// gjkepa_tpu_torch/ops/fused_epa.py, the K2 cascade.
//
// Warp slot i < n_act takes pair order[i] (the hit lanes, moved to the front
// by one cumsum with the count on the device), runs the cascade of
// epa_core.cuh with the warp's support, and thread 0 writes depth, normal,
// iterations and status to pair order[i].  A final-tier capacity exit
// becomes HIT_EPA_DEGENERATE, as in K2.  A slot at or past n_act returns
// whole; the wrapper has already filled its pair with the miss
// pass-through.
//
// The polytope scratch is K2's, [field][face][slot], one slot per warp:
// Faces.base = scratch + i for all 32 threads, each storing the same value
// to the same word (one transaction for the warp) behind a __syncwarp()
// (hull_stream.cuh WarpFaces).  At 4096 slots and F = 208 it is 17 * 208 *
// 4096 * 4 B = 58 MB.
//
// What bounds it: each EPA iteration is one support probe, 12 * (n1 + n2)
// bytes of hull read by the warp, and a scan of the slot's F faces in
// scratch (about 14 words a face) that every thread of the warp repeats.
// The warp splits the probe, the part that grows with N; the face scan
// stays serial, as in K2.
#include "epa_core.cuh"
#include "hull_stream.cuh"

namespace gjkepa {
namespace {

constexpr int kWarpsPerBlock = 2;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
epa_hulls_big_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                     const float* __restrict__ simplex, const int* __restrict__ order,
                     const int* __restrict__ n_act, float* __restrict__ depth_out,
                     float* __restrict__ normal_out, int* __restrict__ iters_out,
                     int* __restrict__ status_out, float* __restrict__ scratch, int B, int n1,
                     int n2, Tiers tiers, int f_max, EpaParams prm) {
  const int i = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= B || i >= *n_act) return;  // the whole warp
  const int lane = order[i];
  P3 s[4];
  for (int j = 0; j < 4; ++j) {
    const float* q = simplex + (size_t)lane * 12 + 3 * j;
    s[j] = mk(q[0], q[1], q[2]);
  }
  WarpFaces fs;
  fs.base = scratch + i;
  fs.field_stride = (size_t)f_max * B;
  fs.B = B;

  const WarpHullSupport support = {p1 + (size_t)lane * n1 * 3, n1, p2 + (size_t)lane * n2 * 3,
                                   n2};
  TierOut r = epa_cascade(support, s, tiers, fs, prm);
  if ((threadIdx.x & (kWarp - 1)) != 0) return;
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

// C interface, bound with ctypes, with epa_hulls_launch's arguments (the
// scratch has epa_scratch_words_per_face() fields).  Returns
// cudaGetLastError() after the launch (or an invalid-value code for a tier
// ladder the kernel does not hold); the launch is asynchronous on `stream`.
extern "C" int epa_hulls_big_launch(const void* p1, const void* p2, const void* simplex,
                                    const void* order, const void* n_act, void* depth,
                                    void* normal, void* iters, void* status, void* scratch, int B,
                                    int n1, int n2, int n_tiers, const int* tier_faces,
                                    const int* tier_kvis, int f_max, float eps_coincide,
                                    float eps_zero, int epa_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  Tiers tiers;
  const int rc = make_tiers(n_tiers, tier_faces, tier_kvis, f_max, epa_max_iters, &tiers);
  if (rc != 0) return rc;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  epa_hulls_big_kernel<<<blocks, kWarpsPerBlock * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(simplex), static_cast<const int*>(order),
      static_cast<const int*>(n_act), static_cast<float*>(depth), static_cast<float*>(normal),
      static_cast<int*>(iters), static_cast<int*>(status), static_cast<float*>(scratch), B, n1,
      n2, tiers, f_max, prm);
  return (int)cudaGetLastError();
}
