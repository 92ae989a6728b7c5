// K8: distance GJK with witness points over hull pairs, one thread per pair.
//
// Replaces the TPU kernel _distance_kernel_hulls (gjkepa_tpu/ops/fused.py:2867,
// with _make_hull_support_ab :2778 and _closest_candidates :2799).  Plain
// PyTorch version: distance_hulls_plain in gjkepa_tpu_torch/ops/fused_distance.py,
// whose operation order every expression here keeps (built with --fmad=false).
//
// Thread i < n_act (a device scalar; every pair without an order) takes pair
// order[i] (i without an order), runs the distance GJK from scratch and writes
// the pair's row: distance, the witness points on A and B, the intersecting
// and converged flags and the iteration count.  Each iteration:
//   1. the closest point of the simplex to the origin over the 15
//      sub-simplices (4 vertices, 6 clamped edges, 4 faces by barycentric
//      test, the tetrahedron by Cramer's rule), folded one candidate at a time
//      in that order, the first strict minimum winning, so only the best d2,
//      its index and its barycentrics stay live;
//   2. the witnesses from the same barycentrics, the simplex reduced to the
//      winning candidate's vertices;
//   3. a new support point along -v, the relative duality gap and the repeat
//      test, and the new point inserted at the end of the simplex.
// The two-phase dispatch launches it twice: every pair at a low cap, then the
// unconverged pairs (moved to the front of `order`) at the full cap; a
// restart retraces the same iterations, so the rows equal a single pass.
//
// What bounds it: every iteration scans both hulls once (24*N bytes a pair at
// N vertices a side); neighbouring threads read addresses 12*N bytes apart, so
// the loads do not coalesce, and the pairs of a warp run different iteration
// counts.  The candidate step is ~500 flops of register arithmetic.  Like K1
// it is bound by its uncoalesced vertex scans and by divergence; sharing the
// scan across a warp is later work.
#include "lane_geom.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;
constexpr float kBigD2 = 3.4e38f;  // d2 of an invalid candidate
constexpr float kEpsRel = 1e-6f;   // relative duality gap; |v|^2 of a touch

// Candidate k's sub-simplex: its vertices (-1 past its size) and its size,
// in the order the candidates are folded.
__constant__ signed char kSubset[15][4] = {
    {0, -1, -1, -1}, {1, -1, -1, -1}, {2, -1, -1, -1}, {3, -1, -1, -1},
    {0, 1, -1, -1},  {0, 2, -1, -1},  {0, 3, -1, -1},  {1, 2, -1, -1},
    {1, 3, -1, -1},  {2, 3, -1, -1},  {0, 1, 2, -1},   {0, 1, 3, -1},
    {0, 2, 3, -1},   {1, 2, 3, -1},   {0, 1, 2, 3}};
__constant__ signed char kSubsetSize[15] = {1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4};

// w[i] of a 4-point simplex held in registers, i chosen at run time.
__device__ __forceinline__ P3 pick4(const P3 (&w)[4], int i) {
  return i == 0 ? w[0] : (i == 1 ? w[1] : (i == 2 ? w[2] : w[3]));
}

// The running best candidate: d2, index and barycentrics.
struct Best {
  float d2;
  int k;
  float bary[4];
  __device__ __forceinline__ void consider(int kk, float d2k, float b0, float b1, float b2,
                                           float b3) {
    if (kk == 0 || d2k < d2) {
      d2 = d2k;
      k = kk;
      bary[0] = b0;
      bary[1] = b1;
      bary[2] = b2;
      bary[3] = b3;
    }
  }
};

// Steps 1 of an iteration: the 15 candidates of the simplex w holding n points.
__device__ __forceinline__ Best closest_candidate(const P3 (&w)[4], int n) {
  Best best;
  best.d2 = 0.0f;
  best.k = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d2 = i < n ? dot(w[i], w[i]) : kBigD2;
    best.consider(i, d2, i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f, i == 2 ? 1.0f : 0.0f,
                  i == 3 ? 1.0f : 0.0f);
  }
  constexpr int ei[6] = {0, 0, 0, 1, 1, 2}, ej[6] = {1, 2, 3, 2, 3, 3};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const P3 a = w[ei[e]], b = w[ej[e]];
    const P3 ab = sub(b, a);
    const float den = dot(ab, ab);
    float t = dot(neg(a), ab) / (den > 0.0f ? den : 1.0f);
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const P3 p = add(a, scale(ab, t));
    const float d2 = (ej[e] < n && den > 0.0f) ? dot(p, p) : kBigD2;
    float bb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bb[ei[e]] = 1.0f - t;
    bb[ej[e]] = t;
    best.consider(4 + e, d2, bb[0], bb[1], bb[2], bb[3]);
  }
  constexpr int fi[4] = {0, 0, 0, 1}, fj[4] = {1, 1, 2, 2}, fk[4] = {2, 3, 3, 3};
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const P3 a = w[fi[f]], b = w[fj[f]], c = w[fk[f]];
    const P3 nrm = cross(sub(b, a), sub(c, a));
    const float nn = dot(nrm, nrm);
    const P3 p = scale(nrm, dot(a, nrm) / (nn > 0.0f ? nn : 1.0f));
    const P3 v0 = sub(b, a), v1 = sub(c, a), v2 = sub(p, a);
    const float d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
    const float d20 = dot(v2, v0), d21 = dot(v2, v1);
    const float den = d00 * d11 - d01 * d01;
    const float dsafe = fabsf(den) > 0.0f ? den : 1.0f;
    const float bv = (d11 * d20 - d01 * d21) / dsafe;
    const float bw = (d00 * d21 - d01 * d20) / dsafe;
    const float bu = 1.0f - bv - bw;
    const bool inside = bu >= 0.0f && bv >= 0.0f && bw >= 0.0f && fabsf(den) > 0.0f;
    const float d2 = (fk[f] < n && inside) ? dot(p, p) : kBigD2;
    float bb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bb[fi[f]] = bu;
    bb[fj[f]] = bv;
    bb[fk[f]] = bw;
    best.consider(10 + f, d2, bb[0], bb[1], bb[2], bb[3]);
  }
  // the tetrahedron's interior: [e0 e1 e2] l = -a by Cramer's rule
  const P3 e0 = sub(w[1], w[0]), e1 = sub(w[2], w[0]), e2 = sub(w[3], w[0]);
  const float det = dot(cross(e0, e1), e2);
  const float dsafe = fabsf(det) > 0.0f ? det : 1.0f;
  const P3 rhs = neg(w[0]);
  const float l0 = dot(cross(rhs, e1), e2) / dsafe;
  const float l1 = dot(cross(e0, rhs), e2) / dsafe;
  const float l2 = dot(cross(e0, e1), rhs) / dsafe;
  const float u = 1.0f - l0 - l1 - l2;
  const bool inside =
      u >= 0.0f && l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && fabsf(det) > 0.0f;
  best.consider(14, (n >= 4 && inside) ? 0.0f : kBigD2, u, l0, l1, l2);
  return best;
}

__global__ void __launch_bounds__(kThreads)
distance_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                      const int* __restrict__ order, const int* __restrict__ n_act,
                      float* __restrict__ dist_out, float* __restrict__ pa_out,
                      float* __restrict__ pb_out, bool* __restrict__ inter_out,
                      int* __restrict__ iters_out, bool* __restrict__ conv_out, int B, int n1,
                      int n2, float eps, int max_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || (n_act != nullptr && i >= *n_act)) return;
  const int lane = order != nullptr ? order[i] : i;
  const float* h1 = p1 + (size_t)lane * n1 * 3;
  const float* h2 = p2 + (size_t)lane * n2 * 3;
  const P3 zero = mk(0.0f, 0.0f, 0.0f);

  P3 w[4], wa[4], wb[4];
  const P3 d0 = mk(1.0f, 0.0f, 0.0f);
  wa[0] = vertex(h1, first_max_vertex<false>(h1, n1, d0));
  wb[0] = vertex(h2, first_max_vertex<true>(h2, n2, d0));
  w[0] = sub(wa[0], wb[0]);
#pragma unroll
  for (int s = 1; s < 4; ++s) w[s] = wa[s] = wb[s] = zero;
  int n = 1, it = 0;
  bool done = false, inter = false;
  float d2 = 0.0f;
  P3 pa = zero, pb = zero;
  while (!done && it < max_iters) {
    const Best best = closest_candidate(w, n);
    P3 vpt = zero, pak = zero, pbk = zero;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      vpt = add(vpt, scale(w[s], best.bary[s]));
      pak = add(pak, scale(wa[s], best.bary[s]));
      pbk = add(pbk, scale(wb[s], best.bary[s]));
    }
    const float v2 = dot(vpt, vpt);
    const bool now_inter = v2 < kEpsRel;

    // reduce to the winning sub-simplex, compacted to the front
    const int size = kSubsetSize[best.k];
    P3 nw[4], na[4], nb[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int src = kSubset[best.k][s];
      nw[s] = src < 0 ? zero : pick4(w, src);
      na[s] = src < 0 ? zero : pick4(wa, src);
      nb[s] = src < 0 ? zero : pick4(wb, src);
    }

    const P3 nd = neg(vpt);
    const P3 ra = vertex(h1, first_max_vertex<false>(h1, n1, nd));
    const P3 rb = vertex(h2, first_max_vertex<true>(h2, n2, nd));
    const P3 rw = sub(ra, rb);
    const float gap = v2 - dot(vpt, rw);
    const bool converged = now_inter || gap <= kEpsRel * fmaxf(v2, 1.0f);
    bool dup = false;
#pragma unroll
    for (int s = 0; s < 4; ++s) dup = dup || (s < size && coincide(nw[s], rw, eps));
    const bool done_now = converged || dup;
    if (!done_now) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s == size) {
          nw[s] = rw;
          na[s] = ra;
          nb[s] = rb;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      w[s] = nw[s];
      wa[s] = na[s];
      wb[s] = nb[s];
    }
    n = done_now ? size : min(size + 1, 4);
    ++it;
    done = done_now;
    d2 = v2;
    pa = pak;
    pb = pbk;
    inter = now_inter;
  }
  dist_out[lane] = inter ? 0.0f : sqrtf(fmaxf(d2, 0.0f));
  pa_out[3 * lane] = pa.x;
  pa_out[3 * lane + 1] = pa.y;
  pa_out[3 * lane + 2] = pa.z;
  pb_out[3 * lane] = pb.x;
  pb_out[3 * lane + 1] = pb.y;
  pb_out[3 * lane + 2] = pb.z;
  inter_out[lane] = inter;
  iters_out[lane] = it;
  conv_out[lane] = done;
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  `order` and `n_act` are both null (every
// pair in order) or both device pointers.  Returns cudaGetLastError() after
// the launch; the launch is asynchronous on `stream`.
extern "C" int distance_hulls_launch(const void* p1, const void* p2, const void* order,
                                     const void* n_act, void* distance, void* point_a,
                                     void* point_b, void* intersecting, void* iters,
                                     void* converged, int B, int n1, int n2, float eps_coincide,
                                     int max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  distance_hulls_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const int*>(order), static_cast<const int*>(n_act),
      static_cast<float*>(distance), static_cast<float*>(point_a), static_cast<float*>(point_b),
      static_cast<bool*>(intersecting), static_cast<int*>(iters), static_cast<bool*>(converged),
      B, n1, n2, eps_coincide, max_iters);
  return (int)cudaGetLastError();
}
