// The EPA capacity cascade for one pair, run by a team of TW lanes of one
// warp (TW = 32: the whole warp; TW = 16: a half, two pairs a warp),
// templated on its support map, over one or two face stores.
//
// Ports _epa_phase_fast (gjkepa_tpu/ops/fused.py:456-749) and _epa_cascade
// (:837-873) over epa_core.cuh's shared pieces (Tiers, plane_of,
// write_face).  Plain PyTorch version: epa_phase and run_cascade in
// gjkepa_tpu_torch/ops/fused_epa.py, whose per-face tensor operations are
// what the team computes TW faces at a time; the reductions' rules in torch
// are warp_first_min_plain and ballot_rank_plain in
// gjkepa_tpu_torch/ops/fused_streamed.py.  K2 (epa_hulls.cu) runs it over
// hull supports on a team of 16 or 32, K13 (epa_hulls_big.cu) over hull
// supports, K10 (epa_hull_shape.cu) over a hull against an analytic shape,
// K7 (epa_shapes.cu) over the analytic shape support, which every thread
// evaluates to the same point, each on a whole warp.
//
// A face store (PairFaces) is one pair's polytope, [field][face] with
// f_max faces a field, 17 words a face (epa_core.cuh Field): 14,144 B at
// the default ladder's F = 208, in shared memory or, for a face capacity
// whose store does not fit there, in device memory.  In epa_cascade_warp
// (K7, K10, K13) each tier restarts from the GJK simplex, so a later tier
// may keep its faces in another store without changing any result; K2's
// ladder (epa_hulls.cu) carries a tier stopped by free faces into the next
// one where that gives the same rows (kCarry).  Lane t of the team owns
// faces t, t + TW, ...: it alone writes them, and the others read them
// only after a __syncwarp of the team.  Each EPA iteration:
//
//   min face    each lane folds its faces' distances (dead: kBig) with
//               strict <, then log2(TW) xor shuffles keep the smaller value
//               and, on an equal value, the smaller index, and the team's
//               lane 0 broadcasts its pair: the first minimum,
//               torch.argmin's index (0 when every face is dead or
//               degenerate);
//   probe       the team support (hull_stream.cuh), one direction for all;
//   repeat      each lane tests its own live faces' corners, __any_sync;
//   visible     per TW-face chunk a __ballot_sync of the visible faces,
//               kept to the team's bits; a face's rank is
//               __popc(ballot & lanemask_lt) plus the chunk's running
//               count, the stable argsort's order, and the first K are
//               staged (9 corners, 3 ids) in WarpScratch, since the new
//               faces overwrite visible slots; nvis > K exits with
//               HIT_EPA_CAPACITY;
//   horizon     one lane per edge row (edge e of staged face k, e-major)
//               of the 3 * nvis: its undirected key is counted among them,
//               and the unique rows are ranked by ballot in row order
//               (hord);
//   new faces   the free faces (dead or visible) are ranked by ballot in
//               index order (rank_f); the r-th takes the r-th horizon edge
//               through epa_core.cuh's plane_of / write_face, written by
//               the lane that owns it, and the rest are set dead.
//
// Every value that decides control flow is the same in all lanes of the
// team (a shuffle broadcast, a ballot count or a value read from the store
// after a __syncwarp), so every exit (hit, capacity, degenerate, iteration
// cap) is taken by the whole team, and every primitive takes the team's
// mask, so that it waits for the team alone: two teams of one warp run
// their pairs apart, and one may leave while the other goes on.
#pragma once

#include "epa_core.cuh"
#include "hull_stream.cuh"

namespace gjkepa {

// One pair's polytope, [field][face], in shared or device memory.  Each
// face is stored by the thread that owns it, so a store needs no barrier of
// its own.
struct PairFaces {
  float* base;
  int f_max;
  __device__ __forceinline__ float& at(int field, int f) const { return base[field * f_max + f]; }
};

// A team's per-iteration scratch in shared memory.
struct WarpScratch {
  float vis[kKMax][12];  // the first K visible faces: 9 corner coordinates, 3 ids
  int key[3 * kKMax];    // undirected key of edge row j (edge j / nvis of face j % nvis)
  int hor[3 * kKMax];    // horizon rows, in row order
};

// kCarry's capacity exit by free faces with every least distance at most
// kBig: K2's ladder takes the polytope up from it (epa_tier_warp), and
// turns it back into kHitEpaCapacity; never in a row.
constexpr int kHitEpaFull = 7;

// WarpScratch in 32-bit words, and one team's shared memory in the kernels
// that give each team its own pair (K2, K7, K10): its scratch, then a face
// store of `faces` faces.
constexpr size_t kScratchWords = sizeof(WarpScratch) / sizeof(float);
static_assert(sizeof(WarpScratch) % sizeof(float) == 0, "word-sized scratch");

__host__ __device__ inline size_t warp_words(int faces) {
  return kScratchWords + (size_t)kFields * faces;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A ballot of the calling team's lanes, kept to the team's bits.
__device__ __forceinline__ unsigned team_ballot(unsigned mask, bool p) {
  return __ballot_sync(mask, p) & mask;
}

// One tier of compact-visible EPA (_epa_phase_fast) for one pair, run by a
// whole team of TW lanes over one face store.
//
// kCarry (K2's ladder) returns kHitEpaFull at a stop by free faces where no
// least distance lay above kBig, and, given `held` > 0 faces, takes up the
// polytope of the tier before it in place of the seed: that tier stopped
// so at iteration `resume` + 1, its `held` faces in `fs` as they were,
// visible marks aside, at that iteration's start.  A tier of F >= held
// faces run from the simplex reaches that same state with its faces past
// `held` dead: they come last, so no first minimum (none lay above kBig),
// visible set, horizon or r-th free face differs.  So the visible marks
// are cleared, the faces past `held` die, and the loop runs that iteration
// again with more free faces, bit for bit the larger tier's rows.  At the
// top of each iteration nv is 4 + out.iters, so `resume` gives both.
template <int TW = kWarp, bool kCarry = false, class Support>
__device__ __forceinline__ TierOut epa_tier_warp(const Support& support, const P3* s,
                                                 P3 interior, int F, int K, const PairFaces& fs,
                                                 WarpScratch& ws, const EpaParams& prm,
                                                 int held = 0, int resume = 0) {
  const float eps = prm.eps, epz = prm.epz;
  const unsigned mask = team_mask<TW>();
  const int lane = threadIdx.x & (TW - 1);
  const int chunks = (F + TW - 1) / TW;
  // seed: the 4 simplex faces (ref :279-293), each by its owner
  __syncwarp(mask);  // a previous tier's reads of the store are done
  const int seed[4][3] = {{0, 1, 2}, {0, 2, 3}, {0, 1, 3}, {1, 2, 3}};
  bool seeded = true;
  int from = 4;  // the first face to die
  if constexpr (kCarry) {
    seeded = held == 0;
    if (!seeded) {
      from = held;
      for (int f = lane; f < from; f += TW) {
        if (fs.at(ALIVE, f) == kVisible) fs.at(ALIVE, f) = kAlive;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (lane == f && seeded) {
      write_face(fs, f, s[seed[f][0]], s[seed[f][1]], s[seed[f][2]], seed[f][0], seed[f][1],
                 seed[f][2], interior, epz);
    }
  }
  for (int f = from + lane; f < F; f += TW) fs.at(ALIVE, f) = kDead;

  TierOut out;
  out.depth = 0.0f;
  out.normal = mk(0.0f, 0.0f, 0.0f);
  out.iters = 0;
  out.status = kHitEpaCap;
  int nv = 4;
  [[maybe_unused]] bool odd = false;
  if constexpr (kCarry) {
    out.iters = resume;
    nv = 4 + resume;
  }

  while (out.iters < prm.max_iters) {
    __syncwarp(mask);  // the faces written last (seed or new faces) before any read
    // -- min face (first minimum over alive faces) / probe direction --------
    float d_min = INFINITY;
    int kmin = INT_MAX;
    for (int f = lane; f < F; f += TW) {
      const float dv = fs.at(ALIVE, f) != kDead ? fs.at(DD, f) : kBig;
      if (dv < d_min) {
        d_min = dv;
        kmin = f;
      }
    }
#pragma unroll
    for (int off = TW / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(mask, d_min, off, TW);
      const int oi = __shfl_xor_sync(mask, kmin, off, TW);
      if (ov < d_min || (ov == d_min && oi < kmin)) {
        d_min = ov;
        kmin = oi;
      }
    }
    d_min = __shfl_sync(mask, d_min, 0, TW);
    kmin = __shfl_sync(mask, kmin, 0, TW);
    if constexpr (kCarry) odd = odd || !(d_min <= kBig);
    if (kmin == INT_MAX) {  // no face below +inf: every distance is NaN
      kmin = 0;
      d_min = fs.at(ALIVE, 0) != kDead ? fs.at(DD, 0) : kBig;
    }
    const bool all_deg = d_min >= kBig * 0.5f;
    if (all_deg) d_min = 0.0f;
    P3 dir = all_deg ? mk(0.0f, 0.0f, 0.0f)
                     : mk(fs.at(NX, kmin), fs.at(NY, kmin), fs.at(NZ, kmin));

    P3 w = support(dir);
    float gain = dot(w, dir) - d_min;
    bool dup = false;
    for (int f = lane; f < F; f += TW) {
      if (fs.at(ALIVE, f) == kDead) continue;
      for (int c = 0; c < 3; ++c) {
        P3 q = mk(fs.at(AX + 3 * c, f), fs.at(AY + 3 * c, f), fs.at(AZ + 3 * c, f));
        if (coincide(q, w, eps)) dup = true;
      }
    }
    dup = __any_sync(mask, dup);
    ++out.iters;
    out.depth = d_min;
    out.normal = dir;
    if (gain < eps || dup) {
      out.status = kHit;
      return out;
    }

    // -- visible set; stage the first K visible faces ------------------------
    int nvis = 0, n_free = 0;
    for (int c = 0; c < chunks; ++c) {
      const int f = c * TW + lane;
      bool vis = false, is_free = false;
      if (f < F) {
        const float alive = fs.at(ALIVE, f);
        if (alive != kDead) {
          const float dd = fs.at(DD, f);
          const bool star = f == kmin;
          const bool beyond =
              (fs.at(NX, f) * w.x + fs.at(NY, f) * w.y + fs.at(NZ, f) * w.z) > dd + epz;
          vis = ((beyond || star) && dd < kBig * 0.5f) || star;
        }
        is_free = vis || alive != kAlive;
      }
      const unsigned vmask = team_ballot(mask, vis);
      if (vis) {
        fs.at(ALIVE, f) = kVisible;
        const int rank = nvis + __popc(vmask & lanemask_lt());
        if (rank < K) {
          for (int j = 0; j < 12; ++j) ws.vis[rank][j] = fs.at(AX + j, f);
        }
      }
      nvis += __popc(vmask);
      n_free += __popc(team_ballot(mask, is_free));
    }
    if (nvis > K) {
      out.status = kHitEpaCapacity;
      return out;
    }

    // -- horizon: edges whose undirected key is unique among the 3*nvis -----
    // row j < 3 * nvis is edge e = j / nvis of staged face k = j % nvis:
    // e-major, the serial order e * K + k over the valid rows
    __syncwarp(mask);  // the staged faces before the edge rows read them
    const int rows = 3 * nvis;
    for (int j = lane; j < rows; j += TW) {
      const int e = j / nvis, k = j - e * nvis;
      const int u = (int)ws.vis[k][9 + e], v = (int)ws.vis[k][9 + (e + 1) % 3];
      ws.key[j] = min(u, v) * kMaxId + max(u, v);
    }
    __syncwarp(mask);  // every key before the counts
    int n_new = 0;
    for (int c = 0; c * TW < rows; ++c) {
      const int j = c * TW + lane;
      bool h = false;
      if (j < rows) {
        const int key = ws.key[j];
        int cnt = 0;
        for (int j2 = 0; j2 < rows; ++j2) cnt += ws.key[j2] == key;
        h = cnt == 1;
      }
      const unsigned hmask = team_ballot(mask, h);
      if (h) ws.hor[n_new + __popc(hmask & lanemask_lt())] = j;
      n_new += __popc(hmask);
    }
    if (n_new > n_free) {
      out.status = kHitEpaCapacity;
      if constexpr (kCarry) {
        if (!odd) out.status = kHitEpaFull;
      }
      return out;
    }
    if (n_new == 0 || all_deg) {
      out.status = kHitEpaDegenerate;
      return out;
    }

    // -- r-th free face (ascending index) <- r-th horizon edge --------------
    __syncwarp(mask);  // the horizon rows before the free faces read them
    int r0 = 0;
    for (int c = 0; c < chunks; ++c) {
      const int f = c * TW + lane;
      const bool is_free = f < F && fs.at(ALIVE, f) != kAlive;
      const unsigned fmask = team_ballot(mask, is_free);
      if (is_free) {
        const int r = r0 + __popc(fmask & lanemask_lt());
        if (r < n_new) {
          const int j = ws.hor[r];
          const int e = j / nvis, k = j - e * nvis;
          const int a = e, b = (e + 1) % 3;
          const float* q = ws.vis[k];
          write_face(fs, f, mk(q[3 * a], q[3 * a + 1], q[3 * a + 2]),
                     mk(q[3 * b], q[3 * b + 1], q[3 * b + 2]), w, (int)q[9 + a], (int)q[9 + b],
                     nv, interior, epz);
        } else {
          fs.at(ALIVE, f) = kDead;  // visible and not reused
        }
      }
      r0 += __popc(fmask);
    }
    ++nv;
  }
  return out;  // iteration cap: HIT_EPA_CAP
}

// The tier ladder for one pair, run by a whole team of TW lanes: each later
// tier only if the previous one stopped for capacity.  A tier of at most
// near.f_max faces keeps them in `near`, a larger one in `far` (K13 passes
// its one store as both).  Each store has its own inlined tier, so that one
// in shared memory is read as such.
template <int TW = kWarp, class Support>
__device__ __forceinline__ TierOut epa_cascade_warp(const Support& support, const P3* s,
                                                    const Tiers& tiers, const PairFaces& near,
                                                    const PairFaces& far, WarpScratch& ws,
                                                    const EpaParams& prm) {
  const P3 interior = mean4(s);
  TierOut r;
  r.status = kHitEpaCapacity;
  for (int t = 0; t < tiers.n && r.status == kHitEpaCapacity; ++t) {
    const int F = tiers.faces[t], K = tiers.kvis[t];
    r = F <= near.f_max ? epa_tier_warp<TW>(support, s, interior, F, K, near, ws, prm)
                        : epa_tier_warp<TW>(support, s, interior, F, K, far, ws, prm);
  }
  return r;
}

}  // namespace gjkepa
