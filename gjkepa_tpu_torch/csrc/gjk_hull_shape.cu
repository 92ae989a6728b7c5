// K9: GJK over hull-vs-shape pairs, a team of T threads per pair.
//
// Replaces the TPU kernel _gjk_kernel_hull_shape (gjkepa_tpu/ops/fused.py:2571,
// with _hull_shape_broadphase :2561): the GJK phase of gjk_core.cuh on the
// TeamHullShapeSupport of hull_shape.cuh.  Plain PyTorch version:
// gjk_hull_shape_plain in gjkepa_tpu_torch/ops/fused_hull_shapes.py.
//
// Team j (T threads, T in 4, 8, 16, 32; the wrapper picks T from the hull
// size, fused_hull_shapes.team_size) takes pair order[j], a permutation of
// all B pairs: the dispatch puts the lanes a bounding-sphere predicate
// marks active first, so they fill whole teams and warps, or passes the
// caller's order; the order only packs the lanes and never decides which
// run.  A pair the dispatch retired (the sphere-envelope bit, decided once
// in torch) skips the bounding sphere and takes gjk_phase's inactive row:
// `active` is `broadphase && !retired`, so its verdict is the same.  Any
// other pair's team computes the hull's bounding sphere
// (team_bounding_sphere: the centroid summed in vertex order by every
// thread, which keeps the plain version's rounding of the verdict, the
// radius split across the team) against the shape's bounding radius, then
// runs GJK with every probe's hull scan split across the team, and thread
// 0 of the team writes hit, status, iterations, the separation lower bound
// and the simplex to pair order[j].
//
// What bounds it: each probe reads the hull, 12 * N bytes, and evaluates the
// shape's closed-form support; iteration counts and shape kinds differ
// between the teams of a warp.  One thread a pair left neighbouring threads
// 12 * N bytes apart, so no load coalesced; a team's loads cover 48 * T
// neighbouring bytes (float4 words of 4-vertex groups where N % 4 == 0,
// hull_stream.cuh), and retired pairs cost one load.
#include "gjk_core.cuh"
#include "hull_shape.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;

template <int T>
__global__ void __launch_bounds__(kThreads)
gjk_hull_shape_kernel(const float* __restrict__ p1, const float* __restrict__ sb,
                      const bool* __restrict__ retired, const int* __restrict__ order,
                      InitDirs dirs, bool* __restrict__ hit_out, int* __restrict__ status_out,
                      int* __restrict__ iters_out, float* __restrict__ sep_out,
                      float* __restrict__ simplex_out, int B, int n1, GjkParams prm) {
  const int j = (blockIdx.x * kThreads + threadIdx.x) / T;
  if (j >= B) return;  // the whole team
  const int lane = order[j];
  const float* v1 = p1 + (size_t)lane * n1 * 3;
  const Shape b = load_shape(sb, lane);
  bool active = false;
  if (!retired[lane]) {
    P3 c1;
    float r1;
    team_bounding_sphere<T>(v1, n1, &c1, &r1);
    active = norm(sub(c1, b.pos)) <= r1 + shape_radius(b) + prm.bp_tol;
  }
  const TeamHullShapeSupport<T> support = {v1, n1, b};
  const GjkOut g = gjk_phase(support, active, dirs, prm);
  if ((threadIdx.x & (T - 1)) != 0) return;
  hit_out[lane] = g.status == kHit;
  status_out[lane] = g.status;
  iters_out[lane] = g.iters;
  sep_out[lane] = g.sep;
  float* so = simplex_out + (size_t)lane * 12;
  for (int i = 0; i < 4; ++i) {
    so[3 * i] = g.s[i].x;
    so[3 * i + 1] = g.s[i].y;
    so[3 * i + 2] = g.s[i].z;
  }
}

template <int T>
void launch(const float* p1, const float* sb, const bool* retired, const int* order,
            const InitDirs& dirs, bool* hit, int* status, int* iters, float* sep,
            float* simplex, int B, int n1, const GjkParams& prm, cudaStream_t stream) {
  const int blocks = (int)(((long long)B * T + kThreads - 1) / kThreads);
  gjk_hull_shape_kernel<T><<<blocks, kThreads, 0, stream>>>(
      p1, sb, retired, order, dirs, hit, status, iters, sep, simplex, B, n1, prm);
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  `team` is the threads per pair (4, 8, 16
// or 32; any other value returns cudaErrorInvalidValue).  Returns
// cudaGetLastError() after the launch; the launch is asynchronous on
// `stream`.
extern "C" int gjk_hull_shape_launch(const void* p1, const void* sb, const void* retired,
                                     const void* order, const void* init_dirs_host, void* hit,
                                     void* status, void* iters, void* sep, void* simplex, int B,
                                     int n1, int team, float eps_coincide, float eps_zero,
                                     float eps_sq, float broadphase_tol, int gjk_max_iters,
                                     void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  auto* fn = team == 4    ? &launch<4>
             : team == 8  ? &launch<8>
             : team == 16 ? &launch<16>
             : team == 32 ? &launch<32>
                          : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  fn(static_cast<const float*>(p1), static_cast<const float*>(sb),
     static_cast<const bool*>(retired), static_cast<const int*>(order), dirs,
     static_cast<bool*>(hit), static_cast<int*>(status), static_cast<int*>(iters),
     static_cast<float*>(sep), static_cast<float*>(simplex), B, n1, prm,
     static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
