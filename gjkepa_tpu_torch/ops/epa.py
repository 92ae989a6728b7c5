"""EPA penetration depth over a capped-face polytope, the portable path.

Port of ``gjkepa_tpu/ops/epa.py``, lane-vectorised over (B,) queries.  The
reference's EPA (``GCLIB_GJKEPA.f90:242-346``, :863-1022) rebuilds a hull
every iteration; the JAX package keeps the polytope in fixed arrays and so
does this port: ``verts`` (B, V, 3) with a count, ``faces`` (B, F, 3)
vertex-index triples with an alive mask.  Each iteration takes the alive
face closest to the origin (the first minimum), probes the support along
its outward normal (oriented against the polytope centroid), and either
converges (the support gains < eps beyond the face, or repeats a vertex)
or stitches the new vertex in over the horizon.

What decides results is the JAX package's: the visibility rule (f* always
visible), a horizon edge is an undirected edge that occurs exactly once
among the visible faces' edges, the r-th horizon edge in the ``u``/``v``
concatenation order goes to the r-th free slot, the new vertex takes index
``n_verts``, and the convergence, duplicate, cant-expand and status rules.
The TPU lowering tricks are gone: the edges are counted by sorting each
lane's edge keys (the JAX package's O(E^2) pairwise key match would cost
~2 GB at 16k lanes), and slots and edges are matched by gathers, not
triangular matmuls and one-hot contractions.

The iteration cap maps to HIT_EPA_CAP with the current best depth and
normal.  Torch code, no kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import GJKEPAConfig
from ..types import Status
from .geom import cross3, dot3, norm3
from .lane_geom import fsqrt

__all__ = ["EPAResult", "run_epa", "polish_support_descent"]

# Seed polytope: the 4 faces of the GJK simplex, the reference's seeding
# (ref :279-293): (1,2,3), (1,3,4), (1,2,4), (2,3,4).
_SEED_FACES = ((0, 1, 2), (0, 2, 3), (0, 1, 3), (1, 2, 3))


class EPAResult(NamedTuple):
    depth: torch.Tensor    # (B,) penetration depth
    normal: torch.Tensor   # (B, 3) contact normal, from A toward B
    iters: torch.Tensor    # (B,) int32 expansion iterations used
    status: torch.Tensor   # (B,) int32 HIT / HIT_EPA_CAP / HIT_EPA_DEGENERATE


def _face_geometry(verts, faces, alive, n_verts, eps_zero):
    """Outward unit normals (B, F, 3), origin distances (B, F; inf where
    not ok) and the ok mask of the alive, non-degenerate faces; outward is
    away from the centroid of the ``n_verts`` vertices (ref :902-910)."""
    v = verts.shape[1]
    vmask = (torch.arange(v, device=verts.device) < n_verts[:, None])[..., None]
    nf = torch.clamp(n_verts, min=1).to(verts.dtype)
    centroid = torch.where(vmask, verts, 0.0).sum(1) / nf[:, None]
    a, b, c = (torch.gather(verts, 1, faces[:, :, j, None].expand(-1, -1, 3))
               for j in range(3))
    n = cross3(b - a, c - a)
    nrm = norm3(n)
    ok = alive & (nrm > eps_zero)
    n = n / torch.where(nrm > eps_zero, nrm, 1.0)[..., None]
    outward = dot3(n, a - centroid[:, None]) >= 0.0
    n = torch.where(outward[..., None], n, -n)
    dist = dot3(n, a)
    return n, torch.where(ok, dist, torch.inf), ok


def _horizon(u, v, evis, n_verts_cap):
    """(B, E) mask of the visible edges whose undirected key occurs exactly
    once among the visible edges of their lane."""
    key = torch.minimum(u, v) * n_verts_cap + torch.maximum(u, v)
    key = torch.where(evis, key, -1 - torch.arange(key.shape[1],
                                                   device=key.device))
    sk, perm = torch.sort(key, dim=1)
    eq = sk[:, 1:] == sk[:, :-1]
    f = torch.zeros_like(eq[:, :1])
    once = ~(torch.cat([f, eq], 1) | torch.cat([eq, f], 1))
    return torch.zeros_like(evis).scatter(1, perm, once) & evis


def run_epa(support: Callable, simplex: torch.Tensor, active: torch.Tensor,
            cfg: GJKEPAConfig) -> EPAResult:
    """Expand the polytope seeded with ``simplex`` (B, 4, 3) on the lanes
    of ``active`` (B,) bool until the closest face lies on the Minkowski
    boundary; inactive lanes run nothing and report zeros."""
    b, dev, dtype = simplex.shape[0], simplex.device, simplex.dtype
    V, F, eps = cfg.epa_max_verts, cfg.epa_max_faces, cfg.eps_coincide
    i32 = dict(dtype=torch.int32, device=dev)
    verts = torch.zeros((b, V, 3), dtype=dtype, device=dev)
    verts[:, :4] = simplex
    faces = torch.zeros((b, F, 3), dtype=torch.int64, device=dev)
    faces[:, :4] = torch.tensor(_SEED_FACES, device=dev)
    alive = torch.zeros((b, F), dtype=torch.bool, device=dev)
    alive[:, :4] = True
    n_verts = torch.full((b,), 4, dtype=torch.int64, device=dev)
    it = torch.zeros(b, **i32)
    done = ~active
    depth = torch.zeros(b, dtype=dtype, device=dev)
    normal = torch.zeros((b, 3), dtype=dtype, device=dev)
    status = torch.full((b,), Status.HIT_EPA_CAP, **i32)
    rows = torch.arange(b, device=dev)
    slots = torch.arange(F, device=dev)
    vids = torch.arange(V, device=dev)
    while True:
        run = ~done & (it < cfg.epa_max_iters)
        if not bool(run.any()):
            break
        normals, dists, ok = _face_geometry(verts, faces, alive, n_verts,
                                            cfg.eps_zero)
        all_degenerate = ~ok.any(1)
        f_star = torch.argmin(dists, dim=1)
        d_min = torch.where(all_degenerate, 0.0, dists[rows, f_star])
        direction = torch.where(all_degenerate[:, None], 0.0,
                                normals[rows, f_star])

        w = support(direction).w
        gain = dot3(w, direction) - d_min
        vmask = vids < n_verts[:, None]
        dup = (vmask & (torch.abs(verts - w[:, None]) < eps).all(2)).any(1)
        converged = (gain < eps) | dup

        # the horizon: visible edges that occur once among visible edges
        visible = ok & (dot3(normals, w[:, None]) > dists + cfg.eps_zero)
        visible = (visible | (slots == f_star[:, None])) & alive
        u = torch.cat([faces[:, :, 0], faces[:, :, 1], faces[:, :, 2]], 1)
        v = torch.cat([faces[:, :, 1], faces[:, :, 2], faces[:, :, 0]], 1)
        horizon = _horizon(u, v, visible.repeat(1, 3), V)
        n_new = horizon.sum(1)
        free = ~alive | visible
        cant_expand = ~converged & ((n_new > free.sum(1)) | (n_verts >= V)
                                    | (n_new == 0) | all_degenerate)
        do_insert = run & ~(converged | cant_expand)

        # the r-th horizon edge (u/v order) into the r-th free slot
        rank_f = torch.cumsum(free.long(), 1) - 1
        hor_order = torch.argsort((~horizon).to(torch.int8), dim=1,
                                  stable=True)
        src = torch.gather(hor_order, 1, rank_f.clamp(0, 3 * F - 1))
        write = free & (rank_f < n_new[:, None]) & do_insert[:, None]
        new_face = torch.stack([torch.gather(u, 1, src),
                                torch.gather(v, 1, src),
                                n_verts[:, None].expand(-1, F)], 2)
        faces = torch.where(write[..., None], new_face, faces)
        alive = torch.where(do_insert[:, None], (alive & ~visible) | write,
                            alive)
        verts = torch.where(((vids == n_verts[:, None])
                             & do_insert[:, None])[..., None], w[:, None],
                            verts)
        n_verts = n_verts + do_insert.long()

        stop = run & (converged | cant_expand)
        status = torch.where(run & converged, Status.HIT,
                             torch.where(run & cant_expand,
                                         Status.HIT_EPA_DEGENERATE,
                                         status)).to(torch.int32)
        depth = torch.where(run, d_min, depth)
        normal = torch.where(run[:, None], direction, normal)
        done = done | stop
        it = torch.where(run, it + 1, it)

    return EPAResult(torch.where(active, depth, 0.0),
                     torch.where(active[:, None], normal, 0.0), it,
                     torch.where(active, status, 0).to(torch.int32))


def polish_support_descent(support: Callable, depth, normal, ok,
                           rounds: int = 6, spread: float = 0.45,
                           shrink: float = 1.0 / 3.0):
    """Fixed-cost refinement of (depth (B,), normal (B, 3)) for exact
    support maps (``polish_support_descent``, the JAX package's twin of the
    fused polish): depth is min over unit d of h(d) = <support(d), d>, and
    a 3x3 tangent-grid descent from the EPA direction reaches it.  The 8
    ring points of each of ``rounds`` rounds are probed (the centre
    skipped), the step multiplied by ``shrink`` after the 8th; a probe
    replaces the best on strict ``<``.  Lanes with ~ok or a non-unit
    normal pass through.  Returns (depth, normal)."""
    ok = ok & (norm3(normal) > 0.5)
    small_x = torch.abs(normal[:, 0]) < 0.9
    one, zero = torch.ones_like(depth), torch.zeros_like(depth)
    helper = torch.stack([torch.where(small_x, one, zero),
                          torch.where(small_x, zero, one), zero], 1)
    u = cross3(normal, helper)
    u = u / torch.clamp(norm3(u), min=1e-20)[:, None]
    v = cross3(normal, u)

    def h_at(a, b):
        inv = 1.0 / fsqrt(1.0 + a * a + b * b)
        d = (normal + a[:, None] * u + b[:, None] * v) * inv[:, None]
        return dot3(support(d).w, d), d

    a0, b0 = zero, zero
    best_h, _ = h_at(a0, b0)
    s = torch.full_like(depth, spread)
    for r in range(8 * rounds):
        k = r % 8
        k2 = k + (1 if k >= 4 else 0)
        aa = a0 + float(k2 // 3 - 1) * s
        bb = b0 + float(k2 % 3 - 1) * s
        hh, _ = h_at(aa, bb)
        better = ok & (hh < best_h)
        best_h = torch.where(better, hh, best_h)
        a0 = torch.where(better, aa, a0)
        b0 = torch.where(better, bb, b0)
        if k == 7:
            s = s * shrink
    _, d_best = h_at(a0, b0)
    return (torch.where(ok, best_h, depth),
            torch.where(ok[:, None], d_best, normal))
