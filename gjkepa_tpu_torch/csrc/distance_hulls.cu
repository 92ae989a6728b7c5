// K8: distance GJK with witness points over hull pairs, a team of T threads
// per pair.
//
// Replaces the TPU kernel _distance_kernel_hulls (gjkepa_tpu/ops/fused.py:2867,
// with _make_hull_support_ab :2778 and _closest_candidates :2799).  Plain
// PyTorch version: distance_hulls_plain in gjkepa_tpu_torch/ops/fused_distance.py,
// whose operation order every expression here keeps (built with --fmad=false).
//
// Team i < n_act (a device scalar; every pair without an order) takes pair
// order[i] (i without an order), runs the distance GJK from scratch and its
// thread 0 writes the pair's row: distance, the witness points on A and B,
// the intersecting and converged flags and the iteration count.  Each
// iteration:
//   1. the closest point of the simplex to the origin over the 15
//      sub-simplices (4 vertices, 6 clamped edges, 4 faces by barycentric
//      test, the tetrahedron by Cramer's rule), the first strict minimum of
//      the in-order fold winning;
//   2. the witnesses from the same barycentrics, the simplex reduced to the
//      winning candidate's vertices;
//   3. a new support point along -v, the relative duality gap and the repeat
//      test, and the new point inserted at the end of the simplex.
// The two-phase dispatch launches it twice: every pair at a low cap, then the
// unconverged pairs (moved to the front of `order`) at the full cap; a
// restart retraces the same iterations, so the rows equal a single pass.
//
// The team.  T threads of one warp (T in 4, 8, 16, 32; the wrapper picks T,
// fused_distance.team_size) share each iteration.  The probe
// (hull_stream.cuh's team_first_max_ab, K1's and K2's too): each thread
// scans both hulls' 4-vertex groups t, t + T, ... as float4 words, and one
// xor-shuffle reduction over the team's lanes folds both hulls' (value,
// index) pairs side by side, so every thread ends with both first maxima.  The candidates: the 15 are
// dealt out over the team (team_closest: one a thread from T = 16, four
// at T = 4), each thread folds its own, and a (key, d2) xor-shuffle
// reduction under a total order ends at the in-order fold's winner, NaN
// included; its barycentrics come by one shuffle from the thread that
// computed it.  Every thread keeps the simplex in registers and every value
// that decides the loop is the same across the team, which leaves the loop
// as a whole; teams of one warp may run apart, and each shuffle names only
// its own team's lanes.
//
// The grid.  Without an order every pair has a team (B * T threads); with
// one, the count n_act lies on the device, so the launcher sizes the grid to
// the teams the card holds at once and each team strides over
// order[i], i < n_act: the restart of a few unconverged pairs does not pay
// for B * T threads that would exit at once.
//
// What bounds it: every iteration probes both hulls (24*N bytes a pair at
// N vertices a side, c2: 65,536 pairs x 64 vertices, 100 MB of hulls, more
// than the L2, read from the L1 after a pair's first probe) and runs ~500
// flops for the candidates, one dependent chain a pair.  One thread per
// pair left neighbouring threads 12*N bytes apart, so no load coalesced; a
// team's loads cover 48*T neighbouring bytes.  The pairs' iteration counts
// differ (1 to 64 at c2), so a warp waits on its slowest team, and the
// restart of the ~127 unconverged pairs is one chain of up to 64 dependent
// iterations a pair, on a card that is otherwise idle: there a wide team
// shortens each iteration, the candidates computed side by side rather than
// one after another.  Over every pair the chains are what the card waits
// on, so the warps an SM holds matter: unbounded, ptxas takes 138-142
// registers (3 blocks, 12 warps an SM); kMinBlocks = 4 bounds it to
// 126 without a spill (16 warps) and reads faster, while 6 or 8 blocks (80
// or 64 registers) spill and read slower; a flat loop in which each team
// walks its own pairs read no faster than a team a pair (PERF.md,
// Findings).
#include "hull_stream.cuh"

namespace gjkepa {
namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks an SM ptxas sizes registers for
constexpr float kBigD2 = 3.4e38f;  // d2 of an invalid candidate
constexpr float kEpsRel = 1e-6f;   // relative duality gap; |v|^2 of a touch

// w[i] of a 4-point simplex held in registers, i chosen at run time.
__device__ __forceinline__ P3 pick4(const P3 (&w)[4], int i) {
  return i == 0 ? w[0] : (i == 1 ? w[1] : (i == 2 ? w[2] : w[3]));
}

// The vertices of candidate k's sub-simplex in the order the candidates
// are folded (-1 past its size), from k by arithmetic: the threads of a
// warp ask for different k, and a table in constant memory would serve
// them one address at a time.
__device__ __forceinline__ void subset_of(int k, int* i, int* j, int* l, int* m) {
  *m = -1;
  if (k < 4) {  // vertex k
    *i = k;
    *j = *l = -1;
  } else if (k < 10) {  // edge (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
    const int e = k - 4;
    *i = e < 3 ? 0 : (e < 5 ? 1 : 2);
    *j = e < 3 ? e + 1 : (e < 5 ? e - 1 : 3);
    *l = -1;
  } else if (k < 14) {  // face (0,1,2) (0,1,3) (0,2,3) (1,2,3)
    const int f = k - 10;
    *i = f == 3 ? 1 : 0;
    *j = f < 2 ? 1 : 2;
    *l = f == 0 ? 2 : 3;
  } else {  // the tetrahedron
    *i = 0;
    *j = 1;
    *l = 2;
    *m = 3;
  }
}

__device__ __forceinline__ int subset_size(int k) {
  return k < 4 ? 1 : (k < 10 ? 2 : (k < 14 ? 3 : 4));
}

// Candidate k of the simplex w holding n points (0-3 a vertex, 4-9 a
// clamped edge, 10-13 a face by barycentric test, 14 the tetrahedron's
// interior by Cramer's rule): its d2 (kBigD2 when invalid), and its
// barycentrics in bb.
__device__ __forceinline__ float candidate(const P3 (&w)[4], int n, int k, float (&bb)[4]) {
  if (k == 14) {  // [e0 e1 e2] l = -a by Cramer's rule
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
    bb[0] = u;
    bb[1] = l0;
    bb[2] = l1;
    bb[3] = l2;
    return (n >= 4 && inside) ? 0.0f : kBigD2;
  }
  int i, j, l, m;
  subset_of(k, &i, &j, &l, &m);
  const P3 a = pick4(w, i);
  if (k < 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) bb[s] = s == i ? 1.0f : 0.0f;
    return i < n ? dot(a, a) : kBigD2;
  }
  const P3 b = pick4(w, j);
  if (k < 10) {
    const P3 ab = sub(b, a);
    const float den = dot(ab, ab);
    float t = dot(neg(a), ab) / (den > 0.0f ? den : 1.0f);
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const P3 p = add(a, scale(ab, t));
#pragma unroll
    for (int s = 0; s < 4; ++s) bb[s] = s == i ? 1.0f - t : (s == j ? t : 0.0f);
    return (j < n && den > 0.0f) ? dot(p, p) : kBigD2;
  }
  const P3 c = pick4(w, l);
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
#pragma unroll
  for (int s = 0; s < 4; ++s) bb[s] = s == i ? bu : (s == j ? bv : (s == l ? bw : 0.0f));
  return (l < n && inside) ? dot(p, p) : kBigD2;
}

// How a team deals out the 15 candidates: thread t of a team of T takes
// slots t, t + T, ...; slot s holds candidate deal(s), so that each run of
// 4 slots holds one kind (the vertices, edges 0-3, the faces, then edges
// 4-5 and the tetrahedron) and the threads of a small team run one code
// path at a time.  dealt(k) is the slot of candidate k.
__device__ __forceinline__ int deal(int s) {
  return s < 8 ? s : (s < 12 ? s + 2 : (s < 14 ? s - 4 : 14));
}
__device__ __forceinline__ int dealt(int k) {
  return k < 8 ? k : (k < 10 ? k + 4 : (k < 14 ? k - 2 : 14));
}

// A candidate's key in the team's order: its class times 16 plus k.  Class
// 0 is candidate 0 with a NaN d2 (the in-order fold starts from it and no
// comparison with a NaN replaces it), 1 a number, 2 a NaN d2 after
// candidate 0 (never taken), 3 a thread without a candidate.
__device__ __forceinline__ int candidate_key(int k, float d2) {
  return (isnan(d2) ? (k == 0 ? 0 : 2) : 1) * 16 + k;
}

// Whether candidate (ka, da) goes before (kb, db): the smaller class, in
// class 1 the smaller d2, then the smaller k.  The order is total, so any
// split of the candidates among the threads and any xor-shuffle reduction
// ends at the candidate the in-order fold with strict < keeps: the first
// minimum (fused_distance.team_closest_plain models it).
__device__ __forceinline__ bool goes_before(int ka, float da, int kb, float db) {
  const int ca = ka >> 4, cb = kb >> 4;
  if (ca != cb) return ca < cb;
  if (ca == 1 && da != db) return da < db;
  return ka < kb;
}

// Step 1 of an iteration for a team of T: the closest of the 15 candidates
// of the simplex w holding n points, its index and barycentrics the same in
// every thread of the team.  Each thread folds the candidates dealt to it,
// log2(T) xor shuffles of (key, d2) end at the team's first minimum, and
// its barycentrics come from the thread that dealt it.
struct Closest {
  int k;
  float bary[4];
};

template <int T>
__device__ __forceinline__ Closest team_closest(const P3 (&w)[4], int n) {
  const int t = threadIdx.x & (T - 1);
  int key = 3 * 16 + 15;
  float d2 = 0.0f, mine[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m * T < 15; ++m) {
    const int slot = t + m * T;
    if (slot < 15) {
      const int k = deal(slot);
      float bb[4];
      const float dk = candidate(w, n, k, bb);
      const int kk = candidate_key(k, dk);
      if (goes_before(kk, dk, key, d2)) {
        key = kk;
        d2 = dk;
#pragma unroll
        for (int s = 0; s < 4; ++s) mine[s] = bb[s];
      }
    }
  }
  const unsigned mask = team_mask<T>();
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(mask, key, off, T);
    const float od = __shfl_xor_sync(mask, d2, off, T);
    if (goes_before(ok, od, key, d2)) {
      key = ok;
      d2 = od;
    }
  }
  Closest c;
  c.k = key & 15;
  const int owner = dealt(c.k) & (T - 1);
#pragma unroll
  for (int s = 0; s < 4; ++s) c.bary[s] = __shfl_sync(mask, mine[s], owner, T);
  return c;
}

template <int T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
distance_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                      const int* __restrict__ order, const int* __restrict__ n_act,
                      float* __restrict__ dist_out, float* __restrict__ pa_out,
                      float* __restrict__ pb_out, bool* __restrict__ inter_out,
                      int* __restrict__ iters_out, bool* __restrict__ conv_out, int B, int n1,
                      int n2, float eps, int max_iters) {
  const int count = n_act != nullptr ? min(*n_act, B) : B;
  const int stride = gridDim.x * (kThreads / T);
  for (int i = (blockIdx.x * kThreads + threadIdx.x) / T; i < count; i += stride) {
    const int lane = order != nullptr ? order[i] : i;
    const float* h1 = p1 + (size_t)lane * n1 * 3;
    const float* h2 = p2 + (size_t)lane * n2 * 3;
    const P3 zero = mk(0.0f, 0.0f, 0.0f);

    P3 w[4], wa[4], wb[4];
    int i1, i2;
    team_first_max_ab<T>(h1, n1, h2, n2, mk(1.0f, 0.0f, 0.0f), &i1, &i2);
    wa[0] = vertex(h1, i1);
    wb[0] = vertex(h2, i2);
    w[0] = sub(wa[0], wb[0]);
#pragma unroll
    for (int s = 1; s < 4; ++s) w[s] = wa[s] = wb[s] = zero;
    int n = 1, it = 0;
    bool done = false, inter = false;
    float d2 = 0.0f;
    P3 pa = zero, pb = zero;
    while (!done && it < max_iters) {
      const Closest best = team_closest<T>(w, n);
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
      const int size = subset_size(best.k);
      int from[4];
      subset_of(best.k, &from[0], &from[1], &from[2], &from[3]);
      P3 nw[4], na[4], nb[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int src = from[s];
        nw[s] = src < 0 ? zero : pick4(w, src);
        na[s] = src < 0 ? zero : pick4(wa, src);
        nb[s] = src < 0 ? zero : pick4(wb, src);
      }

      team_first_max_ab<T>(h1, n1, h2, n2, neg(vpt), &i1, &i2);
      const P3 ra = vertex(h1, i1);
      const P3 rb = vertex(h2, i2);
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
    if ((threadIdx.x & (T - 1)) == 0) {
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
  }
}

// The blocks of one launch: a team a pair without an order, else as many
// as the device holds at once (at most a team a pair).
template <int T>
int launch(const float* p1, const float* p2, const int* order, const int* n_act, float* dist,
           float* pa, float* pb, bool* inter, int* iters, bool* conv, int B, int n1, int n2,
           float eps, int max_iters, cudaStream_t stream) {
  const long long need = ((long long)B * T + kThreads - 1) / kThreads;
  int blocks = (int)need;
  if (order != nullptr) {
    const int err = resident_grid(distance_hulls_kernel<T>, kThreads, 0, need, &blocks);
    if (err != 0) return err;
  }
  distance_hulls_kernel<T><<<blocks, kThreads, 0, stream>>>(
      p1, p2, order, n_act, dist, pa, pb, inter, iters, conv, B, n1, n2, eps, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gjkepa

// C interface, bound with ctypes.  `order` and `n_act` are both null (every
// pair in order) or both device pointers; `team` is the threads a pair (4,
// 8, 16 or 32; any other value returns cudaErrorInvalidValue).  Returns
// cudaGetLastError() after the launch; the launch is asynchronous on
// `stream`.
extern "C" int distance_hulls_launch(const void* p1, const void* p2, const void* order,
                                     const void* n_act, void* distance, void* point_a,
                                     void* point_b, void* intersecting, void* iters,
                                     void* converged, int B, int n1, int n2, int team,
                                     float eps_coincide, int max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  auto* fn = team == 4    ? &launch<4>
             : team == 8  ? &launch<8>
             : team == 16 ? &launch<16>
             : team == 32 ? &launch<32>
                          : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(static_cast<const float*>(p1), static_cast<const float*>(p2),
            static_cast<const int*>(order), static_cast<const int*>(n_act),
            static_cast<float*>(distance), static_cast<float*>(point_a),
            static_cast<float*>(point_b), static_cast<bool*>(intersecting),
            static_cast<int*>(iters), static_cast<bool*>(converged), B, n1, n2, eps_coincide,
            max_iters, static_cast<cudaStream_t>(stream));
}
