"""GJK boolean intersection, the portable path.

Port of ``gjkepa_tpu/ops/gjk.py``, lane-vectorised over (B,) queries where
the JAX package vmaps a per-pair ``lax.while_loop``: the reference's
non-standard GJK (``GCLIB_GJKEPA.f90``) with

  * the staged v1-v4 init over the deterministic direction table with up
    to ``init_max_iters`` (99) retries of v1/v2 (:82-170), the
    origin-on-segment fix of v3 and the fresh early-EPA seed of v4;
  * the always-tetra update step (:1070-1157): the face most beyond the
    origin (first maximum of the scores), its three vertices and a new
    support point;
  * termination by a flat or coplanar simplex, containment, a two-step
    cycle (:199-234), or the ``gjk_max_iters`` cap (:186);
  * a separating-plane lower bound from every probe (the miss path's
    distance).

Each loop runs while any lane is still in it, one host ``any()`` an
iteration; a lane leaves when its own condition fails, as in the vmapped
while loop.  Inactive lanes run nothing and report MISS_BROADPHASE.
Torch code on the device of the support's tensors, no kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import GJKEPAConfig
from ..types import Status
from .directions import DIRECTION_TABLE
from .geom import (SIMPLEX_FACES, cross3, dist_pf_sign, dot3, is_inside_pf,
                   norm3, point_in_simplex, utzvec, vec_pl)

__all__ = ["GJKResult", "run_gjk", "update_simplex"]

_RUNNING = -1


class GJKResult(NamedTuple):
    simplex: torch.Tensor   # (B, 4, 3) final simplex (valid on hit)
    status: torch.Tensor    # (B,) int32 Status code
    hit: torch.Tensor       # (B,) bool
    iters: torch.Tensor     # (B,) int32 GJK loop iterations
    sep_lb: torch.Tensor    # (B,) separation lower bound (miss path)


def update_simplex(support: Callable, simplex: torch.Tensor):
    """One always-tetra GJK step (update_simplex_GJK, ref :1070-1157) on
    (B, 4, 3) simplices: the four outward face normals (away from the
    centroid), each face scored by how far beyond it the origin lies,
    expansion through the first maximum.  Returns (new simplex, d, w)."""
    s = [simplex[:, i] for i in range(4)]
    m = (((s[0] + s[1]) + s[2]) + s[3]) / 4.0
    normals, scores = [], []
    for f0, f1, f2 in SIMPLEX_FACES:
        a, b, c = s[f0], s[f1], s[f2]
        n = utzvec(cross3(a - b, b - c))
        n = torch.where((dot3(n, a - m) < 0.0)[:, None], -n, n)
        normals.append(n)
        scores.append(-dot3(n, a))
    k = torch.argmax(torch.stack(scores, 1), dim=1)
    rows = torch.arange(simplex.shape[0], device=simplex.device)
    d = torch.stack(normals, 1)[rows, k]
    w = support(d).w
    faces = torch.tensor(SIMPLEX_FACES, device=simplex.device)[k]  # (B, 3)
    kept = simplex[rows[:, None], faces]
    return torch.cat([kept, w[:, None]], 1), d, w


def _sep_bound(best, d, w):
    """A unit direction d whose support w has <w, d> < 0 certifies a
    separation of at least -<w, d>."""
    return torch.maximum(best, -dot3(w, d))


def _coincide(a, b, eps):
    return (torch.abs(a - b) < eps).all(-1)


def run_gjk(support: Callable, cfg: GJKEPAConfig, active: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> GJKResult:
    """The init and iterate phases for every lane of ``active`` (B,) bool
    (``False`` lanes report MISS_BROADPHASE, ref :76-77).

    ``support(d)`` maps (B, 3) directions to a result whose ``w`` is the
    Minkowski support point (the ``SupportResult`` convention)."""
    b, dev = active.shape[0], active.device
    eps = cfg.eps_coincide
    table = torch.as_tensor(DIRECTION_TABLE, dtype=dtype, device=dev)
    zero3 = torch.zeros((b, 3), dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    # [1.1/1.2] v1, v2: probe table[it] and its negation, retried while
    # they coincide (ref :82-112)
    it = torch.zeros(b, **i32)
    s1, s2 = zero3, zero3
    sep = torch.zeros(b, dtype=dtype, device=dev)
    while True:
        run = active & (it < cfg.init_max_iters) & _coincide(s1, s2, eps)
        if not bool(run.any()):
            break
        d = table[(it % table.shape[0]).long()]
        r1, r2 = support(d).w, support(-d).w
        step = _sep_bound(_sep_bound(sep, d, r1), -d, r2)
        s1 = torch.where(run[:, None], r1, s1)
        s2 = torch.where(run[:, None], r2, s2)
        sep = torch.where(run, step, sep)
        it = torch.where(run, it + 1, it)
    init_failed = _coincide(s1, s2, eps)      # retries exhausted (:86-89)

    # [1.3] v3: support along the point-to-line direction (ref :115-127),
    # or perpendicular to the segment when the origin is on its line
    d3 = vec_pl(zero3, torch.stack([s1, s2], 1), cfg.eps_zero)
    seg = s2 - s1
    segsq = dot3(seg, seg)
    t3 = dot3(-s1, seg) / torch.clamp(segsq, min=cfg.eps_zero)
    rej = s1 + t3[:, None] * seg
    on_line = dot3(rej, rej) <= (eps * eps) * (1.0 + segsq)
    alt = utzvec(cross3(seg, table[0].expand(b, 3)), cfg.eps_zero)
    alt = torch.where((dot3(alt, alt) > 0.0)[:, None], alt,
                      utzvec(cross3(seg, table[1].expand(b, 3)),
                             cfg.eps_zero))
    d3 = torch.where(((dot3(d3, d3) > 0.0) & ~on_line)[:, None], d3, alt)
    s3 = support(d3).w
    sep = _sep_bound(sep, d3, s3)
    v3_degenerate = _coincide(s3, s1, eps) | _coincide(s3, s2, eps)

    # [1.4] v4 and the early-EPA, coplanar and containment checks
    # (ref :130-170)
    tri = torch.stack([s1, s2, s3], 1)
    d4 = utzvec(cross3(s2 - s1, s3 - s2), cfg.eps_zero)
    vo = -s3
    early_hit = ((torch.abs(dot3(vo, d4)) < eps)
                 & is_inside_pf(tri, zero3, eps_zero=cfg.eps_zero))
    d4_flipped = torch.where((dot3(vo, d4) < 0.0)[:, None], -d4, d4)
    s4 = support(d4_flipped).w
    sep = _sep_bound(sep, d4_flipped, s4)
    v4_coplanar = torch.abs(dist_pf_sign(s4, tri, cfg.eps_zero)) < eps
    # the early-EPA seed: a fresh support along the unflipped normal, the
    # opposite side when that one is coplanar
    s4e = support(d4).w
    s4e_coplanar = torch.abs(dist_pf_sign(s4e, tri, cfg.eps_zero)) < eps
    s4_early = torch.where(s4e_coplanar[:, None], support(-d4).w, s4e)
    simplex = torch.stack(
        [s1, s2, s3, torch.where(early_hit[:, None], s4_early, s4)], 1)
    in_tetra = point_in_simplex(zero3, simplex, eps, cfg.eps_zero)

    status = torch.full((b,), _RUNNING, **i32)
    status = torch.where(in_tetra, Status.HIT, status)
    status = torch.where(v4_coplanar, Status.MISS_INIT, status)
    status = torch.where(early_hit, Status.HIT, status)
    status = torch.where(v3_degenerate, Status.MISS_INIT, status)
    status = torch.where(init_failed, Status.MISS_INIT, status)
    status = torch.where(active, status, Status.MISS_BROADPHASE).to(torch.int32)

    # [2] the iterate loop (ref :178-236)
    prev = torch.zeros_like(simplex)     # the simplex before the current
    iters = torch.zeros(b, **i32)
    while True:
        run = (status == _RUNNING) & (iters < cfg.gjk_max_iters)
        if not bool(run.any()):
            break
        new, d, w = update_simplex(support, simplex)
        step = _sep_bound(sep, d, w)
        flat_tri = norm3(cross3(new[:, 1] - new[:, 0],
                                new[:, 2] - new[:, 1])) < eps
        coplanar4 = torch.abs(dist_pf_sign(new[:, 3], new[:, :3],
                                           cfg.eps_zero)) < eps
        contains = point_in_simplex(zero3, new, eps, cfg.eps_zero)
        # two-step cycle: every vertex matches its counterpart in one of
        # the last two simplices
        stalled = (_coincide(new, simplex, eps)
                   | _coincide(new, prev, eps)).all(1)
        st = status
        st = torch.where(stalled, Status.MISS_GJK, st)
        st = torch.where(contains, Status.HIT, st)
        st = torch.where(coplanar4, Status.MISS_GJK, st)
        st = torch.where(flat_tri, Status.MISS_GJK, st)
        keep = run[:, None, None]
        prev = torch.where(keep, simplex, prev)
        simplex = torch.where(keep, new, simplex)
        sep = torch.where(run, step, sep)
        status = torch.where(run, st, status).to(torch.int32)
        iters = torch.where(run, iters + 1, iters)

    # the cap without a verdict is a non-hit (ref :186-189)
    status = torch.where(status == _RUNNING, Status.MISS_GJK,
                         status).to(torch.int32)
    hit = status == Status.HIT
    sep = torch.where(hit | ~active, 0.0, torch.clamp(sep, min=0.0))
    return GJKResult(simplex, status, hit, iters, sep)
