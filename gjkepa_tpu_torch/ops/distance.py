"""Distance-GJK: closest distance and witness points, the portable path.

Port of ``gjkepa_tpu/ops/distance.py``, lane-vectorised over (B,) queries
where the JAX package vmaps a per-pair ``lax.while_loop``.  The classical
distance GJK with simplex reduction, fixed-shape:

  * the simplex is a padded (B, 4, 3) buffer plus a count;
  * the closest point of the simplex to the origin comes from all 15
    sub-simplices (4 vertices, 6 clamped edges, 4 triangles by barycentric
    test, the tetrahedron by Cramer's rule), each a closed-form projection;
    the first minimum over the valid ones wins (``_closest_point_candidates``
    keeps the JAX order);
  * the carry tracks each vertex's witness pair (a_i, b_i), so the closest
    points on A and B come from the same barycentrics.

Convergence: the relative duality gap |v|^2 - <v, w> <= eps |v|^2, a
repeated support point, or |v|^2 below eps (intersecting: distance 0).
Torch code, no kernel: the fused hull query with its kernel K8 is
``ops.fused_distance``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import GJKEPAConfig
from .lane_geom import fsqrt

__all__ = ["DistanceResult", "gjk_distance"]

# candidate index -> its sub-simplex, in the emit order of
# _closest_point_candidates (and of the fused kernel's candidates)
SUBSETS = ((0,), (1,), (2,), (3,),
            (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3),
            (0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3),
            (0, 1, 2, 3))
# ... its vertices padded with 0, and its size
_CAND_VERTS = torch.tensor([s + (0,) * (4 - len(s)) for s in SUBSETS])
_CAND_SIZE = torch.tensor([len(s) for s in SUBSETS], dtype=torch.int32)


class DistanceResult(NamedTuple):
    distance: torch.Tensor      # (B,) closest distance (0 if intersecting)
    point_a: torch.Tensor       # (B, 3) witness on A
    point_b: torch.Tensor       # (B, 3) witness on B
    intersecting: torch.Tensor  # (B,) bool
    iters: torch.Tensor         # (B,) int32


def _dot(a, b):
    return (a * b).sum(-1)


def _closest_point_candidates(pts, n_pts, big):
    """Closest point to the origin on each sub-simplex of pts (B, 4, 3).

    Returns d2 (B, 15) and barycentrics (B, 15, 4); a candidate that uses a
    vertex >= n_pts, or whose unclamped face/tetra barycentrics leave the
    simplex, gets d2 = big.  Vertices and clamped edges keep at least one
    candidate valid."""
    zero = torch.zeros_like(pts[:, 0, 0])
    one = torch.ones_like(zero)
    cands_d, cands_b = [], []

    def emit(d2, bary, valid):
        cands_d.append(torch.where(valid, d2, big))
        cands_b.append(torch.stack(bary, 1))

    for i in range(4):
        p = pts[:, i]
        bary = [zero] * 4
        bary[i] = one
        emit(_dot(p, p), bary, i < n_pts)

    for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        a, b = pts[:, i], pts[:, j]
        ab = b - a
        den = _dot(ab, ab)
        t = torch.clamp(_dot(-a, ab) / torch.where(den > 0, den, 1.0), 0.0,
                        1.0)
        p = a + t[:, None] * ab
        bary = [zero] * 4
        bary[i], bary[j] = 1.0 - t, t
        emit(_dot(p, p), bary, (j < n_pts) & (den > 0))

    for i, j, k in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
        a, b, c = pts[:, i], pts[:, j], pts[:, k]
        n = torch.linalg.cross(b - a, c - a)
        nn = _dot(n, n)
        dist_plane = _dot(a, n) / torch.where(nn > 0, nn, 1.0)
        p = dist_plane[:, None] * n
        v0, v1, v2 = b - a, c - a, p - a
        d00, d01, d11 = _dot(v0, v0), _dot(v0, v1), _dot(v1, v1)
        d20, d21 = _dot(v2, v0), _dot(v2, v1)
        den = d00 * d11 - d01 * d01
        dsafe = torch.where(torch.abs(den) > 0, den, 1.0)
        v = (d11 * d20 - d01 * d21) / dsafe
        w = (d00 * d21 - d01 * d20) / dsafe
        u = 1.0 - v - w
        inside = (u >= 0) & (v >= 0) & (w >= 0) & (torch.abs(den) > 0)
        bary = [zero] * 4
        bary[i], bary[j], bary[k] = u, v, w
        emit(_dot(p, p), bary, (k < n_pts) & inside)

    # tetra interior: solve [e0 e1 e2] l = -a by Cramer's rule
    a, b, c, d = pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]
    e0, e1, e2 = b - a, c - a, d - a
    cross = torch.linalg.cross
    det = _dot(cross(e0, e1), e2)
    dsafe = torch.where(torch.abs(det) > 0, det, 1.0)
    rhs = -a
    l0 = _dot(cross(rhs, e1), e2) / dsafe
    l1 = _dot(cross(e0, rhs), e2) / dsafe
    l2 = _dot(cross(e0, e1), rhs) / dsafe
    u = 1.0 - (l0 + l1 + l2)
    inside = ((u >= 0) & (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
              & (torch.abs(det) > 0))
    emit(zero, [u, l0, l1, l2], (n_pts >= 4) & inside)
    return torch.stack(cands_d, 1), torch.stack(cands_b, 1)


def gjk_distance(support: Callable, cfg: GJKEPAConfig,
                 dtype: torch.dtype = torch.float32, max_iters: int = 64,
                 active: torch.Tensor | None = None) -> DistanceResult:
    """Closest distance between the pairs of convex sets behind `support`.

    ``support(d)`` maps (B, 3) directions (or one (1, 3) direction, which
    it broadcasts) to a result with fields ``w`` (the Minkowski point),
    ``a`` and ``b`` (the witnesses), each (B, 3).  ``active`` (B,) bool:
    inactive lanes run no iteration and report zeros; it also names the
    device of the first direction (the CPU without it)."""
    big = torch.finfo(dtype).max
    eps_rel = 1e-12 if dtype == torch.float64 else 1e-6
    dev = None if active is None else active.device
    r0 = support(torch.tensor([[1.0, 0.0, 0.0]], dtype=dtype, device=dev))
    b, dev = r0.w.shape[0], r0.w.device
    if r0.w.shape[1:] != (3,) or r0.w.dtype != dtype:
        raise ValueError(f"support must return (B, 3) {dtype}, got "
                         f"{r0.w.dtype} {tuple(r0.w.shape)}")

    def seed(x):
        return torch.cat([x[:, None], torch.zeros((b, 3, 3), dtype=dtype,
                                                  device=dev)], 1)

    w, wa, wb = seed(r0.w), seed(r0.a), seed(r0.b)
    n = torch.ones(b, dtype=torch.int32, device=dev)
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    done = (torch.zeros(b, dtype=torch.bool, device=dev) if active is None
            else ~active)
    dist2 = torch.zeros(b, dtype=dtype, device=dev)
    pa = torch.zeros((b, 3), dtype=dtype, device=dev)
    pb = torch.zeros_like(pa)
    inter = torch.zeros(b, dtype=torch.bool, device=dev)
    lane4 = torch.arange(4, device=dev)[None, :]
    verts, sizes = _CAND_VERTS.to(dev), _CAND_SIZE.to(dev)
    while True:
        run = ~done & (it < max_iters)
        if not bool(run.any()):
            break
        d2s, barys = _closest_point_candidates(w, n, big)
        k = torch.argmin(d2s, dim=1)                       # first minimum
        bary = barys[torch.arange(b, device=dev), k]       # (B, 4)
        v = (bary[:, :, None] * w).sum(1)
        pa_k = (bary[:, :, None] * wa).sum(1)
        pb_k = (bary[:, :, None] * wb).sum(1)
        v2 = _dot(v, v)
        intersecting = v2 < eps_rel

        # reduce to the supporting sub-simplex, compacted to the front
        idx = verts[k][:, :, None].expand(-1, -1, 3)
        size = sizes[k]
        w_new, wa_new, wb_new = (torch.gather(x, 1, idx) for x in (w, wa, wb))

        r = support(-v)
        gap = v2 - _dot(v, r.w)                            # duality gap
        converged = intersecting | (gap <= eps_rel * torch.clamp(v2, min=1.0))
        same = (torch.abs(w_new - r.w[:, None]) < cfg.eps_coincide).all(2)
        dup = ((lane4 < size[:, None]) & same).any(1)
        stop = converged | dup

        slot = (lane4 == torch.clamp(size, max=3)[:, None])[:, :, None]
        w_new = torch.where(slot, r.w[:, None], w_new)
        wa_new = torch.where(slot, r.a[:, None], wa_new)
        wb_new = torch.where(slot, r.b[:, None], wb_new)
        keep = (run & ~stop)[:, None, None]
        w = torch.where(keep, w_new, w)
        wa = torch.where(keep, wa_new, wa)
        wb = torch.where(keep, wb_new, wb)
        n = torch.where(run & ~stop, torch.clamp(size + 1, max=4), n)
        it = torch.where(run, it + 1, it)
        done = done | (run & stop)
        dist2 = torch.where(run, v2, dist2)
        pa = torch.where(run[:, None], pa_k, pa)
        pb = torch.where(run[:, None], pb_k, pb)
        inter = torch.where(run, intersecting, inter)
    dist = fsqrt(torch.clamp(dist2, min=0.0))
    return DistanceResult(torch.where(inter, 0.0, dist).to(dtype), pa, pb,
                          inter, it)
