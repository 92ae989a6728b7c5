// K2: the EPA capacity cascade over hit lanes, a team of TW lanes per hit
// (16 or 32), the small tiers' polytope in shared memory and the larger
// ones' in a pooled slot.
//
// Replaces the TPU kernel _epa_cascade_kernel_hulls
// (gjkepa_tpu/ops/fused.py:1112, with _epa_phase_fast :456-749, _epa_cascade
// :837-873 and the merge of _write_epa_out :975-1007).  Plain PyTorch
// version: epa_cascade_plain in gjkepa_tpu_torch/ops/fused_epa.py.
//
// A block holds P warps, each 32 / TW teams, one hit a team: H = P * 32 /
// TW hits a block.  Team h of block i takes hit rank r = i * H + h, pair
// order[r] (the hit lanes, moved to the front by one cumsum on the host
// side, no sync), while r < n_act; a team at or past n_act returns alone,
// its pair already filled with the miss pass-through by the wrapper, and
// the other team of its warp never waits for it (every primitive of the
// tier takes the team's mask).  The team runs its ladder (k2_ladder) over
// the tier of epa_warp.cuh, each face scan split across its TW lanes, with
// the team support of hull_stream.cuh (TeamHullSupport<TW>: at 24
// vertices six lanes read a 4-vertex group each, then log2(TW) xor
// shuffles), and its lane 0 writes depth, normal, iterations and status.
// A final-tier capacity exit becomes HIT_EPA_DEGENERATE.  Where a tier
// stops for capacity by free faces, the next one carries its polytope on
// wherever the plain version's restart would repeat the smaller tier's
// iterations bit for bit (k2_ladder), and restarts from the simplex
// elsewhere.  This is K13's warp tier, bit-equal to the same plain
// version at either width (the min-face fold, the support's first maximum
// and the ballot ranks are total orders, whatever the lanes' split); K13
// shares each probe across a block because its hulls are large, K2 gives
// each team its own pair because its hulls are small.  P is kPairs = 1: of 1, 2, 4 and 8 the
// fastest on an H100 (PERF.md, Findings).  fused_epa.k2_team picks TW by
// the hulls' sizes: 16 where both hulls have at most 64 vertices (16
// 4-vertex groups, one probe pass on 16 lanes as on 32; the 48-face tier
// is 3 faces a lane, a horizon of at most 48 rows 3 chunks), so that two
// hits share each instruction a warp issues and an SM's warps carry twice
// the EPA chains; 32 above.
//
// Face stores by size, never a refusal.  The block's dynamic shared memory
// holds, for each of its H teams, a WarpScratch (1,152 B) and a face store
// of near_faces faces (68 B a face): a tier of at most near_faces faces
// keeps its faces there.  A larger tier keeps them in a slot of a device
// pool, [slot][field][far_faces] float32, which the team claims only when
// its ladder reaches such a tier, and frees when its hit is done: the
// team's lane 0 sets a free bit of its own SM's slot mask (%smid) with
// atomicOr and broadcasts the slot.  The pool holds, for each SM id
// (%nsmid), one slot for every hit of K2 an SM can ever hold at either
// width (the device's most blocks an SM times the hits a block of 16-lane
// teams, at most its threads / 16), so a team always finds a free slot,
// whatever the width, the occupancy, the streams and the launches in
// flight; fused_epa.k2_pool allocates it once a device, and no host read
// sizes it.  fused_epa.k2_near_faces picks near_faces: the largest tier
// whose block still lets as many blocks an SM as K2's registers allow
// (epa_hulls_blocks_per_sm(TW, 0)) fit in the SM's shared memory (its size
// and reserve a block from epa_hulls_device).  At the default ladder (48,
// 88 and 208 faces) on an H100, 16 blocks an SM by the registers: at TW =
// 32 48 and 88 faces stay (7,136 B a block) and 208 is pooled, at TW = 16
// 48 faces stay (2 x 4,416 B a block) and 88 and 208 are pooled.  A hit
// reaches a pooled tier only after the smaller tiers exit for capacity; a
// polytope carried on from shared memory into the pool is copied into the
// slot.  An optional tally counts, by the teams' lane-0 atomics, the hits
// that finish in each tier and the pool's claims, and at TW = 16 the EPA
// iterations the hits ran and, a warp, those of its longer team (null on
// the main path).  The pool's two int32 words before its masks count, on
// the main path too, its claims and the tiers carried into
// (fused_epa.pool_claims and tier_carries read them; the kernel never
// does); every launch is handed them, with no slot where no tier is
// pooled.
//
// What bounds it: each hit's iterations run one after another, a chain of
// dependent shared-memory passes and shuffles plus one probe of both hulls
// (5 float operations a vertex), so the launch lasts as long as its waves'
// slowest hits; the chains resident on an SM hide each other's latency,
// and the registers set how many warps reside, the team width how many
// chains each carries.
#include "epa_warp.cuh"

namespace gjkepa {
namespace {

constexpr int kPairs = 1;     // P, the warps a block
constexpr int kNarrowTeam = 16;  // the narrowest team K2 is built for

// The tally's entries past the tiers' counts (MAX_TIERS + 3 in all).
constexpr int kTallyClaims = kMaxTiers;      // the pool's claims
constexpr int kTallyIters = kMaxTiers + 1;   // the hits' EPA iterations (TW < 32)
constexpr int kTallyLonger = kMaxTiers + 2;  // a warp's longer team's (TW < 32)

// H teams, each its scratch and its near face store (epa_warp.cuh).
inline size_t smem_bytes(int hits, int near_faces) {
  return (size_t)hits * warp_words(near_faces) * sizeof(float);
}

// The device pool of face stores for the tiers past near_faces.
struct SlotPool {
  float* faces;    // [slot][field][f_max]
  unsigned* mask;  // [SM id][words]: a set bit is a slot taken; mask[-2]
                   // counts the claims, mask[-1] the carries
  int per_sm;      // slots an SM id
  int f_max;       // faces a slot
  __device__ __forceinline__ int words() const { return (per_sm + 31) / 32; }
};

// The team's lane 0 takes a free slot of its SM's mask, counts the claim,
// and the whole team gets the slot.  The SM's resident hits are at most its
// slots, so the scan ends.
template <int TW>
__device__ __forceinline__ int claim_slot(const SlotPool& pool) {
  int slot = 0;
  if ((threadIdx.x & (TW - 1)) == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned* mask = pool.mask + (size_t)sm * pool.words();
    for (int i = 0;; i = i + 1 < pool.words() ? i + 1 : 0) {
      const int n = min(32, pool.per_sm - 32 * i);
      const unsigned all = n == 32 ? ~0u : (1u << n) - 1u;
      unsigned free_bits = ~*reinterpret_cast<volatile unsigned*>(mask + i) & all;
      while (free_bits != 0u) {
        const unsigned bit = free_bits & (0u - free_bits);
        if ((atomicOr(mask + i, bit) & bit) == 0u) {
          slot = (int)sm * pool.per_sm + 32 * i + __ffs(bit) - 1;
          break;
        }
        free_bits &= ~bit;
      }
      if (free_bits != 0u) break;
    }
    atomicAdd(reinterpret_cast<int*>(pool.mask) - 2, 1);
    __threadfence();  // the slot's last holder's writes before ours
  }
  return __shfl_sync(team_mask<TW>(), slot, 0, TW);
}

// The whole team, after its last use of the slot.
template <int TW>
__device__ __forceinline__ void release_slot(const SlotPool& pool, int slot) {
  __threadfence();  // this team's writes to the slot before the release
  __syncwarp(team_mask<TW>());
  if ((threadIdx.x & (TW - 1)) == 0) {
    const int sm = slot / pool.per_sm, k = slot - sm * pool.per_sm;
    atomicAnd(pool.mask + (size_t)sm * pool.words() + k / 32, ~(1u << (k % 32)));
  }
}

// The team copies faces 0..n-1 of one store into another, every field,
// each lane its own faces: no barrier.  Rare (a carry into the pool), so
// kept a word at a time: unrolled, its loads in flight would set the
// kernel's registers.
template <int TW>
__device__ __forceinline__ void copy_faces(const PairFaces& from, const PairFaces& to, int n) {
#pragma unroll 1
  for (int k = 0; k < kFields; ++k) {
#pragma unroll 1
    for (int f = threadIdx.x & (TW - 1); f < n; f += TW) to.at(k, f) = from.at(k, f);
  }
}

// epa_cascade_warp's ladder, its rows bit for bit, with the far tiers in a
// pool slot, claimed when the ladder first reaches one.  A tier stopped by
// free faces (kHitEpaFull) hands its `held` faces to the next one where
// that has F' >= F and K' >= K (epa_tier_warp's kCarry), in the same store
// or copied into the slot, and the team's lane 0 adds 1 to the pool's
// carry counter; every other capacity exit restarts the next tier from
// the simplex.  At TW < 32, `ran` adds the iterations the hit ran.
template <int TW, class Support>
__device__ __forceinline__ TierOut k2_ladder(const Support& support, const P3* s,
                                             const Tiers& tiers, const PairFaces& near,
                                             const SlotPool& pool, WarpScratch& ws,
                                             const EpaParams& prm, int* tally, int& ran) {
  const P3 interior = mean4(s);
  const bool lead = (threadIdx.x & (TW - 1)) == 0;
  TierOut r;
  int slot = -1, t = 0, held = 0;
  for (;; ++t) {
    const int F = tiers.faces[t], K = tiers.kvis[t];
    const int resume = held > 0 ? r.iters - 1 : 0;  // the stopped iteration runs again
    if (F <= near.f_max) {
      r = epa_tier_warp<TW, true>(support, s, interior, F, K, near, ws, prm, held, resume);
    } else {
      if (slot < 0) slot = claim_slot<TW>(pool);
      const PairFaces far = {pool.faces + (size_t)slot * kFields * pool.f_max, pool.f_max};
      if (held > 0 && held <= near.f_max) copy_faces<TW>(near, far, held);
      r = epa_tier_warp<TW, true>(support, s, interior, F, K, far, ws, prm, held, resume);
    }
    if constexpr (TW < kWarp) ran += r.iters - resume;
    const bool full = r.status == kHitEpaFull;
    if (full) r.status = kHitEpaCapacity;
    if (r.status != kHitEpaCapacity || t + 1 == tiers.n) break;
    held = full && tiers.faces[t + 1] >= F && tiers.kvis[t + 1] >= K ? F : 0;
    if (lead && held > 0) atomicAdd(reinterpret_cast<int*>(pool.mask) - 1, 1);
  }
  if (slot >= 0) release_slot<TW>(pool, slot);
  if (tally != nullptr && lead) {
    atomicAdd(tally + t, 1);
    if (slot >= 0) atomicAdd(tally + kTallyClaims, 1);
  }
  return r;
}

// Hit rank r of the block's team on its pair, by the whole team; returns
// the EPA iterations it ran (counted at TW < 32 only).
template <int TW>
__device__ __forceinline__ int k2_hit(const float* __restrict__ p1, const float* __restrict__ p2,
                                      const float* __restrict__ simplex,
                                      const int* __restrict__ order, float* __restrict__ depth_out,
                                      float* __restrict__ normal_out, int* __restrict__ iters_out,
                                      int* __restrict__ status_out, const SlotPool& pool,
                                      int* __restrict__ tally, int n1, int n2,
                                      const Tiers& tiers, int near_faces, const EpaParams& prm,
                                      int team, int r) {
  extern __shared__ float smem[];
  const int pair = order[r];
  float* mine = smem + team * warp_words(near_faces);
  WarpScratch& ws = *reinterpret_cast<WarpScratch*>(mine);
  const PairFaces near = {mine + kScratchWords, near_faces};
  P3 s[4];
  for (int j = 0; j < 4; ++j) {
    const float* q = simplex + (size_t)pair * 12 + 3 * j;
    s[j] = mk(q[0], q[1], q[2]);
  }
  const TeamHullSupport<TW> support = {p1 + (size_t)pair * n1 * 3, n1,
                                       p2 + (size_t)pair * n2 * 3, n2};
  int ran = 0;
  TierOut res = k2_ladder<TW>(support, s, tiers, near, pool, ws, prm, tally, ran);
  if ((threadIdx.x & (TW - 1)) != 0) return ran;
  if (res.status == kHitEpaCapacity) res.status = kHitEpaDegenerate;
  depth_out[pair] = res.depth;
  normal_out[3 * pair] = res.normal.x;
  normal_out[3 * pair + 1] = res.normal.y;
  normal_out[3 * pair + 2] = res.normal.z;
  iters_out[pair] = res.iters;
  status_out[pair] = res.status;
  return ran;
}

// At least one block an SM: without it ptxas caps the registers at 80 and
// spills.  With a tally at TW < 32, each warp adds its teams' iterations
// and its longer team's: their ratio over 2 is the share of the warp's
// iterations that ran both teams (the pairing's efficiency).
template <int TW>
__global__ void __launch_bounds__(kPairs * kWarp, 1)
epa_hulls_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                 const float* __restrict__ simplex, const int* __restrict__ order,
                 const int* __restrict__ n_act, float* __restrict__ depth_out,
                 float* __restrict__ normal_out, int* __restrict__ iters_out,
                 int* __restrict__ status_out, SlotPool pool, int* __restrict__ tally, int n1,
                 int n2, Tiers tiers, int near_faces, EpaParams prm) {
  const int team = threadIdx.x / TW;
  const int r = blockIdx.x * (kPairs * kWarp / TW) + team;
  if constexpr (TW == kWarp) {
    if (r >= *n_act) return;  // the whole warp
    k2_hit<TW>(p1, p2, simplex, order, depth_out, normal_out, iters_out, status_out, pool,
               tally, n1, n2, tiers, near_faces, prm, team, r);
  } else {
    int ran = 0;
    if (r < *n_act) {  // else the team returns alone
      ran = k2_hit<TW>(p1, p2, simplex, order, depth_out, normal_out, iters_out, status_out,
                       pool, tally, n1, n2, tiers, near_faces, prm, team, r);
    }
    if (tally == nullptr) return;
    __syncwarp();  // both teams, each past its hit
    const int other = __shfl_xor_sync(kFullMask, ran, TW);
    if ((threadIdx.x & (kWarp - 1)) == 0) {
      atomicAdd(tally + kTallyIters, ran + other);
      atomicAdd(tally + kTallyLonger, max(ran, other));
    }
  }
}

__global__ void sm_ids_kernel(int* out) {
  unsigned n;
  asm("mov.u32 %0, %%nsmid;" : "=r"(n));
  *out = (int)n;
}

}  // namespace
}  // namespace gjkepa

// Words a face of the EPA face stores: K2's pool is (slots, words,
// far_faces) float32, K13's device store (n_act, words, far_faces), K10's
// scratch (words, f_max, B).
extern "C" int epa_scratch_words_per_face() { return gjkepa::kFields; }

namespace {

// The hits a K2 block of teams of `team` lanes takes, or 0 for a width K2
// is not built for.
int hits_a_block(int team) {
  using namespace gjkepa;
  return team == kWarp ? kPairs : team == kNarrowTeam ? kPairs * kWarp / kNarrowTeam : 0;
}

// K2's instantiation for teams of `team` lanes (one hits_a_block holds):
// both take the same arguments.
auto kernel_for(int team) {
  using namespace gjkepa;
  return team == kWarp ? epa_hulls_kernel<kWarp> : epa_hulls_kernel<kNarrowTeam>;
}

}  // namespace

// Bytes of shared memory a K2 block of teams of `team` lanes takes with a
// face store of `near_faces` faces a team, or -1 for a width K2 is not
// built for.
extern "C" int epa_hulls_smem_bytes(int team, int near_faces) {
  const int hits = hits_a_block(team);
  return hits == 0 ? -1 : (int)gjkepa::smem_bytes(hits, near_faces);
}

// K2 blocks of teams of `team` lanes an SM holds with `smem` bytes of
// dynamic shared memory a block (the occupancy calculator; at 0, what its
// registers allow), or minus the CUDA error.
extern "C" int epa_hulls_blocks_per_sm(int team, int smem) {
  using namespace gjkepa;
  if (hits_a_block(team) == 0) return -(int)cudaErrorInvalidValue;
  const auto kernel = kernel_for(team);
  const int err = allow_smem(kernel, (size_t)smem);
  if (err != 0) return -err;
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPairs * kWarp, (size_t)smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

// What K2's store rule and pool observe of the current device besides its
// occupancy, for teams of `team` lanes, in `facts`: [0] the hits a block
// (H), [1] the shared memory of an SM, [2] the shared memory the system
// reserves a block, [3] the pool's slots an SM id (the most K2 hits an SM
// can hold at either width), [4] the SM ids (%nsmid, read by a one-thread
// kernel and a copy: the call waits for the device).  Returns 0 or the
// CUDA error.
extern "C" int epa_hulls_device(int team, int* facts) {
  using namespace gjkepa;
  const int hits = hits_a_block(team);
  if (hits == 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sm_bytes = 0, reserve = 0, max_blocks = 0, max_threads = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserve, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_blocks, cudaDevAttrMaxBlocksPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  int* sm_ids = nullptr;
  int n_ids = 0;
  if (err == cudaSuccess) err = cudaMalloc(&sm_ids, sizeof(int));
  if (err == cudaSuccess) {
    sm_ids_kernel<<<1, 1>>>(sm_ids);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaMemcpy(&n_ids, sm_ids, sizeof(int), cudaMemcpyDeviceToHost);
  }
  if (sm_ids != nullptr) cudaFree(sm_ids);
  if (err != cudaSuccess) return (int)err;
  const int most_hits = max_blocks * kPairs * (kWarp / kNarrowTeam);
  const int narrow_teams = max_threads / kNarrowTeam;
  facts[0] = hits;
  facts[1] = sm_bytes;
  facts[2] = reserve;
  facts[3] = most_hits < narrow_teams ? most_hits : narrow_teams;
  facts[4] = n_ids;
  return 0;
}

// C interface, bound with ctypes.  Teams of `team` lanes (16 or 32), one
// hit a team.  A tier of at most `near_faces` faces runs in shared memory,
// a larger one in a slot of the pool `pool_faces` (slots, fields,
// far_faces) float32 (null when no tier needs it) with `pool_mask` int32
// (SM ids, ceil(pool_per_sm / 32)) zeroed, preceded by the int32 claim and
// carry counters (never null).  `tally`, when not null,
// is int32 (MAX_TIERS + 3): each hit adds one to the tier it finished in,
// and one to entry MAX_TIERS if it took a slot; at team 16, each warp adds
// its hits' EPA iterations to entry MAX_TIERS + 1 and its longer team's to
// MAX_TIERS + 2.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a tier ladder the kernel does not hold, no
// counters, a tier in neither store, a block past the device's shared
// memory or a team width K2 is not built for; the launch is asynchronous on `stream`.
extern "C" int epa_hulls_launch(const void* p1, const void* p2, const void* simplex,
                                const void* order, const void* n_act, void* depth, void* normal,
                                void* iters, void* status, void* pool_faces, void* pool_mask,
                                void* tally, int B, int n1, int n2, int n_tiers,
                                const int* tier_faces, const int* tier_kvis, int near_faces,
                                int far_faces, int pool_per_sm, int team, float eps_coincide,
                                float eps_zero, int epa_max_iters, void* stream) {
  using namespace gjkepa;
  if (B <= 0) return 0;
  if (near_faces < 0 || far_faces < 0) return (int)cudaErrorInvalidValue;
  Tiers tiers;
  const int f_max = near_faces > far_faces ? near_faces : far_faces;
  const int rc = make_tiers(n_tiers, tier_faces, tier_kvis, f_max, epa_max_iters, &tiers);
  if (rc != 0) return rc;
  if (pool_mask == nullptr) return (int)cudaErrorInvalidValue;
  const bool pooled = pool_faces != nullptr && pool_per_sm > 0;
  for (int t = 0; t < tiers.n; ++t) {
    if (tiers.faces[t] > near_faces && !pooled) return (int)cudaErrorInvalidValue;
  }
  const int hits = hits_a_block(team);
  if (hits == 0) return (int)cudaErrorInvalidValue;
  const EpaParams prm = make_epa_params(eps_coincide, eps_zero, epa_max_iters);
  const SlotPool pool = {static_cast<float*>(pool_faces), static_cast<unsigned*>(pool_mask),
                         pool_per_sm, far_faces};
  const size_t smem = smem_bytes(hits, near_faces);
  const auto kernel = kernel_for(team);
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const int blocks = (B + hits - 1) / hits;
  kernel<<<blocks, kPairs * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(simplex), static_cast<const int*>(order),
      static_cast<const int*>(n_act), static_cast<float*>(depth), static_cast<float*>(normal),
      static_cast<int*>(iters), static_cast<int*>(status), pool, static_cast<int*>(tally), n1,
      n2, tiers, near_faces, prm);
  return (int)cudaGetLastError();
}
