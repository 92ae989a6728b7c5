// K6a and K6b: GJK over analytic shape pairs.
//
// K6a replaces the TPU kernel _gjk_sub_kernel_shapes
// (gjkepa_tpu/ops/fused.py:1910), K6b replaces _gjk_kernel_shapes (:1935);
// both run the GJK phase with the shape support of shape_geom.cuh.  Plain
// PyTorch versions: gjk_sub_shapes_plain and gjk_shapes_plain in
// gjkepa_tpu_torch/ops/fused_shapes.py.
//
// Activity is the same in both: bounding-sphere overlap, no closed form,
// and not retired (the capsule-envelope bit the dispatch decides once and
// passes in; the kernels read it and never recompute it).
//
//   K6a runs over the compacted GJK lanes, a quad of threads a pair
//       (gjk_phase_quad, gjk_quad.cuh): compact index i < n_act (a device
//       scalar) takes pair order[i] and writes its hit, status,
//       iterations, separation and simplex to pair order[i].  The same
//       grid writes the inactive row (all zeros, status MISS_BROADPHASE)
//       of pair order[i] for every i >= n_act, a thread a pair; order is
//       a permutation of the pairs (hit_first_order's), so every row of
//       the output is written once, as the plain version leaves it, and
//       the wrapper fills nothing.
//   K6b runs over every pair in the caller's order, in one launch of
//       blocks of kAllPairs pairs, and also writes the closed-form channel
//       (final flag, depth, normal); a closed-form lane's status and
//       separation come from the closed form.  A block works in three
//       steps: (1) a thread a pair computes the closed form (K5's, with the
//       SAT unrolled), the broadphase and the activity, writes the
//       closed-form channel, and writes the whole GJK row of every lane
//       that runs no GJK (the closed form's status and max(gap, 0), or
//       gjk_phase's inactive row); (2) the block's GJK lanes are dealt into
//       a list in shared memory in pair order (a ballot and popc a warp, a
//       prefix over the block's warps); (3) its quads take the list's
//       entries q, q + quads, ... through gjk_phase_quad and write their
//       rows as K6a does.  No host read, no global atomics, no second
//       launch: the caller's order needs no compaction.
//
// What bounds them: each support probe is a few dozen flops on the 128
// bytes of the pair's two shapes, held in registers, so GJK is bound by
// each pair's chain of dependent iterations (c3: 793 GJK lanes, 2.3
// iterations on average, up to 15).  K6a's grid does not scale with B:
// the blocks of kSubPairs quads the card holds at once (resident_grid,
// hull_stream.cuh), and quad t of block b takes compact indices b + G*t,
// b + G*t + G*kSubPairs, ... (G blocks), so the few live pairs reach
// every SM rather than the first few blocks; the quad splits each
// iteration's four faces, which shortens the chain (on an H100 an
// iteration of c3's longest chain takes ~0.9 us in a quad and ~1.5 us on
// one thread; of 8, 16, 32 and 64 quads a block, 8 read first or level on
// every input measured, PERF.md, Findings).  The inactive rows are ~60
// bytes a pair over nearly all B pairs, in pair order (hit_first_order is
// stable), the simplex as three float4 words; they are most of the bytes
// bound.  K6b reads every pair once and writes every row (~210 bytes a
// pair), and a block's time is its closed-form pass plus its longest GJK
// chain.  A block of 128 threads takes 32 pairs, so each GJK lane has a
// quad of its own and a block runs one round of chains whatever its share
// of GJK lanes; the closed forms take one warp.  With 128 pairs a block
// (the first design) a block whose GJK lanes outnumber its 32 quads runs
// them in rounds: on an H100 (PERF.md, Findings) that took 2.5x the old
// thread-a-pair kernel on the 16 kind pairs, while 32 pairs a block beat
// it on every input measured (c3, shuffled, the 16 kind pairs,
// all-cylinder pairs); 128 pairs were ~25% faster only on c3 shuffled,
// where the closed forms of four warps overlap.
#include "gjk_quad.cuh"
#include "shape_geom.cuh"

namespace gjkepa {
namespace {

constexpr int kSubPairs = 8;  // K6a's quads (pairs in flight) a block
constexpr int kSubThreads = kSubPairs * kQuad;

__global__ void __launch_bounds__(kSubThreads)
gjk_sub_shapes_kernel(const float* __restrict__ sa, const float* __restrict__ sb,
                      const bool* __restrict__ retired, const int* __restrict__ order,
                      const int* __restrict__ n_act, InitDirs dirs,
                      bool* __restrict__ hit_out, int* __restrict__ status_out,
                      int* __restrict__ iters_out, float* __restrict__ sep_out,
                      float* __restrict__ simplex_out, int B, GjkParams prm) {
  const int count = min(*n_act, B);
  // the inactive rows, pairs order[count:]: a thread a pair
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = count + blockIdx.x * kSubThreads + threadIdx.x; i < B;
       i += gridDim.x * kSubThreads) {
    const int lane = order[i];
    hit_out[lane] = false;
    status_out[lane] = kMissBroadphase;
    iters_out[lane] = 0;
    sep_out[lane] = 0.0f;
    float4* __restrict__ words = reinterpret_cast<float4*>(simplex_out) + (size_t)lane * 3;
    words[0] = zero4;
    words[1] = zero4;
    words[2] = zero4;
  }

  // the GJK lanes, pairs order[:count]: a quad a pair
  const int f = threadIdx.x & (kQuad - 1);
  for (int i = blockIdx.x + gridDim.x * (threadIdx.x / kQuad); i < count;
       i += gridDim.x * kSubPairs) {
    const int lane = order[i];
    const ShapeSupport support = {load_shape(sa, lane), load_shape(sb, lane)};
    const bool active = shape_broadphase(support.a, support.b, prm.bp_tol) &&
                        !cf_kind_mask(support.a.kind, support.b.kind) && !retired[lane];
    const GjkOut g = gjk_phase_quad(support, active, dirs, prm);
    if (f == 0) {
      hit_out[lane] = g.status == kHit;
      status_out[lane] = g.status;
      iters_out[lane] = g.iters;
      sep_out[lane] = g.sep;
    }
    // lane f writes vertex f of the simplex
    const P3 v = simplex_vertex(g.s, f);
    float* so = simplex_out + (size_t)lane * 12 + 3 * f;
    so[0] = v.x;
    so[1] = v.y;
    so[2] = v.z;
  }
}

// K6b's threads and pairs a block.
constexpr int kAllThreads = 128;
constexpr int kAllPairs = 32;
constexpr int kAllWarps = kAllThreads / 32;
constexpr int kAllQuads = kAllThreads / kQuad;
static_assert(kAllThreads % 32 == 0 && kAllThreads <= 1024 && kAllPairs <= kAllThreads,
              "kAllThreads, kAllPairs");

__global__ void __launch_bounds__(kAllThreads, 512 / kAllThreads)
gjk_shapes_kernel(const float* __restrict__ sa, const float* __restrict__ sb,
                  const bool* __restrict__ retired, InitDirs dirs, bool* __restrict__ hit_out,
                  int* __restrict__ status_out, int* __restrict__ iters_out,
                  float* __restrict__ sep_out, float* __restrict__ simplex_out,
                  bool* __restrict__ final_out, float* __restrict__ cf_depth_out,
                  float* __restrict__ cf_normal_out, int B, GjkParams prm) {
  __shared__ int lanes[kAllPairs];  // the block's GJK lanes, in pair order
  __shared__ int counts[kAllWarps];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kAllPairs + t;

  // 1. closed forms, a thread a pair; every row but the GJK lanes' written
  //    here (a thread past B takes part in the deal as a lane without GJK)
  bool gjk = false;
  if (t < kAllPairs && i < B) {
    const Shape a = load_shape(sa, i), b = load_shape(sb, i);
    const ClosedForm cf = closed_form(a, b, prm.bp_tol);
    gjk = shape_broadphase(a, b, prm.bp_tol) && !cf.final && !retired[i];
    if (!gjk) {
      // gjk_phase's inactive row; a closed-form lane's status and sep
      const int status = cf.final ? cf.status : kMissBroadphase;
      hit_out[i] = status == kHit;
      status_out[i] = status;
      iters_out[i] = 0;
      sep_out[i] = cf.final ? fmaxf(cf.gap, 0.0f) : 0.0f;
      const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4* __restrict__ words = reinterpret_cast<float4*>(simplex_out) + (size_t)i * 3;
      words[0] = zero4;
      words[1] = zero4;
      words[2] = zero4;
    }
    final_out[i] = cf.final;
    cf_depth_out[i] = cf.depth;
    cf_normal_out[3 * i] = cf.normal.x;
    cf_normal_out[3 * i + 1] = cf.normal.y;
    cf_normal_out[3 * i + 2] = cf.normal.z;
  }

  // 2. the deal: each warp's GJK lanes by ballot, the warps' offsets by a
  //    prefix over the block's warps, so the list keeps pair order
  const int w = t >> 5, l = t & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, gjk);
  if (l == 0) counts[w] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kAllWarps; ++k) {
    base += k < w ? counts[k] : 0;
    total += counts[k];
  }
  if (gjk) lanes[base + __popc(ballot & ((1u << l) - 1u))] = i;
  __syncthreads();

  // 3. GJK, a quad a lane of the list: quad q takes entries q, q +
  //    kAllQuads, ...; `total` is the block's, so each quad's loop is uniform
  const int f = t & (kQuad - 1);
  for (int q = t / kQuad; q < total; q += kAllQuads) {
    const int lane = lanes[q];
    const ShapeSupport support = {load_shape(sa, lane), load_shape(sb, lane)};
    const GjkOut g = gjk_phase_quad(support, true, dirs, prm);
    if (f == 0) {
      hit_out[lane] = g.status == kHit;
      status_out[lane] = g.status;
      iters_out[lane] = g.iters;
      sep_out[lane] = g.sep;
    }
    // lane f writes vertex f of the simplex
    const P3 v = simplex_vertex(g.s, f);
    float* so = simplex_out + (size_t)lane * 12 + 3 * f;
    so[0] = v.x;
    so[1] = v.y;
    so[2] = v.z;
  }
}

}  // namespace
}  // namespace gjkepa

// C interfaces, bound with ctypes.  Each returns cudaGetLastError() after
// the launch (or the error of asking the device its occupancy); the launch
// is asynchronous on `stream`.  The simplex output of both must be
// 16-byte aligned.
extern "C" int gjk_sub_shapes_launch(const void* sa, const void* sb, const void* retired,
                                     const void* order, const void* n_act,
                                     const void* init_dirs_host, void* hit, void* status,
                                     void* iters, void* sep, void* simplex, int B,
                                     float eps_coincide, float eps_zero, float eps_sq,
                                     float broadphase_tol, int gjk_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  // the blocks the card holds at once, no more quads than pairs
  int blocks = 0;
  const int err = resident_grid(gjk_sub_shapes_kernel, kSubThreads, 0,
                                (B + kSubPairs - 1) / kSubPairs, &blocks);
  if (err != 0) return err;
  const InitDirs dirs = make_init_dirs(static_cast<const float*>(init_dirs_host));
  const GjkParams prm =
      make_gjk_params(eps_coincide, eps_zero, eps_sq, broadphase_tol, gjk_max_iters);
  gjk_sub_shapes_kernel<<<blocks, kSubThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const bool*>(retired), static_cast<const int*>(order),
      static_cast<const int*>(n_act), dirs,
      static_cast<bool*>(hit), static_cast<int*>(status), static_cast<int*>(iters),
      static_cast<float*>(sep), static_cast<float*>(simplex), B, prm);
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
  const int blocks = (B + kAllPairs - 1) / kAllPairs;
  gjk_shapes_kernel<<<blocks, kAllThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<const bool*>(retired), dirs, static_cast<bool*>(hit), static_cast<int*>(status),
      static_cast<int*>(iters), static_cast<float*>(sep), static_cast<float*>(simplex),
      static_cast<bool*>(final_flag), static_cast<float*>(cf_depth),
      static_cast<float*>(cf_normal), B, prm);
  return (int)cudaGetLastError();
}
