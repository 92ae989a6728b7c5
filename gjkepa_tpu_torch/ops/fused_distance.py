"""The fused distance query over hull pairs: K8 and its two-phase dispatch.

Ports from ``gjkepa_tpu/ops/fused.py`` the kernel ``_distance_kernel_hulls``
(K8, :2867) with ``_make_hull_support_ab`` (:2778) and
``_closest_candidates`` (:2799), and the dispatch
``fused_gjk_distance_hulls`` (:3002-3135).  The CUDA kernel is
``csrc/distance_hulls.cu``; :func:`distance_hulls_plain` is its plain
PyTorch version and keeps its operation order: the 15 candidates in the
same order, folded one at a time with the first strict minimum winning,
``BIG = 3.4e38`` for invalid ones, ``eps_rel = 1e-6``.  The kernel runs a
team of T threads a pair over K11's team support (:func:`team_size`).  The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.

The dispatch, ``two_phase=True``: K8 runs every pair at the low cap
``phase1_iters``; ``hit_first_order`` of the unconverged lanes puts them
first, their count staying on the device; K8 runs again over those lanes at
the full cap, from scratch, and writes each one's row in place.  The
restart retraces the same deterministic iterations, so the result equals
the single-phase run bit for bit.  The TPU's B/8 prefix with its
``lax.cond`` tail, the done-flag input for filler lanes and the gather and
sort layouts are gone: a CUDA thread takes its lane from the order and
nothing else waits on it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..config import GJKEPAConfig
from ..spans import spanned
from .distance import SUBSETS, DistanceResult
from .fused import hit_first_order, mask_to_padding
from .fused_epa import check_tensors
from .fused_gjk import TEAMS, check_hulls, make_hull_support_ab
from .fused_gjk import team_size as k1_team_size
from .lane_geom import P3, fsqrt, pcoincide, pcross, pdot, pscale, pwhere

__all__ = ["DistanceRows", "distance_hulls", "distance_hulls_plain",
           "fused_gjk_distance_hulls", "team_size", "team_closest_plain",
           "RESTART_TEAM", "DEAL", "LAUNCHES"]

# Kernel launches made by distance_hulls (CUDA tensors only).
LAUNCHES = {"distance_hulls": 0}

BIG = 3.4e38            # distance of an invalid candidate (float32)
EPS_REL = 1e-6          # relative duality gap, and |v|^2 of intersection

# K8's team for a restart of the unconverged pairs (an ``order`` given:
# phase 2): the fastest of fused_gjk.TEAMS for phase 2 at c2 on an H100
# (PERF.md, Findings).  A launch over every pair
# (phase 1, one pass) takes K1's rule by hull size.
RESTART_TEAM = 32

# How K8 deals the 15 candidates out over a team (csrc/distance_hulls.cu
# deal()): thread t of a team of T takes slots t, t + T, ..., slot s
# holding candidate DEAL[s], so that runs of 4 slots hold one kind.
DEAL = (0, 1, 2, 3, 4, 5, 6, 7, 10, 11, 12, 13, 8, 9, 14)


class DistanceRows(NamedTuple):
    """K8's per-pair output (the JAX kernel's rows 0-9)."""

    distance: torch.Tensor      # (B,) f32, 0 when intersecting
    point_a: torch.Tensor       # (B, 3) f32 witness on A
    point_b: torch.Tensor       # (B, 3) f32 witness on B
    intersecting: torch.Tensor  # (B,) bool
    iters: torch.Tensor         # (B,) int32
    converged: torch.Tensor     # (B,) bool: stopped before the cap


def _candidates(w, n):
    """Yield (d2, bary 4-tuple) for the 15 sub-simplices of the 4-point
    simplex ``w`` (a tuple of P3) holding ``n`` points; an invalid
    candidate has d2 = BIG."""
    zero = torch.zeros_like(w[0].x)
    one = torch.ones_like(zero)
    for i in range(4):
        bary = [zero] * 4
        bary[i] = one
        yield torch.where(i < n, pdot(w[i], w[i]), BIG), bary
    for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        a, b = w[i], w[j]
        ab = b - a
        den = pdot(ab, ab)
        t = pdot(-a, ab) / torch.where(den > 0, den, 1.0)
        t = torch.minimum(torch.maximum(t, zero), one)
        p = a + pscale(ab, t)
        bary = [zero] * 4
        bary[i], bary[j] = 1.0 - t, t
        yield torch.where((j < n) & (den > 0), pdot(p, p), BIG), bary
    for i, j, k in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
        a, b, c = w[i], w[j], w[k]
        nrm = pcross(b - a, c - a)
        nn = pdot(nrm, nrm)
        p = pscale(nrm, pdot(a, nrm) / torch.where(nn > 0, nn, 1.0))
        v0, v1, v2 = b - a, c - a, p - a
        d00, d01, d11 = pdot(v0, v0), pdot(v0, v1), pdot(v1, v1)
        d20, d21 = pdot(v2, v0), pdot(v2, v1)
        den = d00 * d11 - d01 * d01
        dsafe = torch.where(torch.abs(den) > 0, den, 1.0)
        bv = (d11 * d20 - d01 * d21) / dsafe
        bw = (d00 * d21 - d01 * d20) / dsafe
        bu = 1.0 - bv - bw
        inside = (bu >= 0) & (bv >= 0) & (bw >= 0) & (torch.abs(den) > 0)
        bary = [zero] * 4
        bary[i], bary[j], bary[k] = bu, bv, bw
        yield torch.where((k < n) & inside, pdot(p, p), BIG), bary
    # the tetrahedron's interior, by Cramer's rule
    a, b, c, d = w
    e0, e1, e2 = b - a, c - a, d - a
    det = pdot(pcross(e0, e1), e2)
    dsafe = torch.where(torch.abs(det) > 0, det, 1.0)
    rhs = -a
    l0 = pdot(pcross(rhs, e1), e2) / dsafe
    l1 = pdot(pcross(e0, rhs), e2) / dsafe
    l2 = pdot(pcross(e0, e1), rhs) / dsafe
    u = 1.0 - l0 - l1 - l2
    inside = ((u >= 0) & (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
              & (torch.abs(det) > 0))
    yield torch.where((n >= 4) & inside, zero, BIG), [u, l0, l1, l2]


def team_closest_plain(d2: torch.Tensor, width: int) -> torch.Tensor:
    """K8's candidate reduction (``csrc/distance_hulls.cu`` team_closest)
    over (L, 15) candidate distances in torch: thread t of a ``width``
    team folds the candidates of slots t, t + width, ... (:data:`DEAL`),
    then log2(width) xor-shuffle steps, all under one total order on (key,
    d2): the class (0 candidate 0 with a NaN d2, 1 a number, 2 a later NaN,
    3 no candidate), in class 1 the smaller d2, then the smaller index.
    Returns the (L,) int64 index every thread ends with (held to the
    in-order fold with strict <, the plain version's)."""
    n, dev = d2.shape[0], d2.device
    k = torch.arange(15, device=dev)
    cls = torch.where(torch.isnan(d2), torch.where(k == 0, 0, 2), 1)
    slots = -(-15 // width) * width
    keys = torch.full((n, slots), 3 * 16 + 15, dtype=torch.int64, device=dev)
    vals = torch.zeros((n, slots), dtype=d2.dtype, device=dev)
    deal = torch.tensor(DEAL, device=dev)
    keys[:, :15] = (cls * 16 + k)[:, deal]
    vals[:, :15] = d2[:, deal]

    def before(ka, da, kb, db):
        ca, cb = ka >> 4, kb >> 4
        by_d2 = (ca == 1) & (da != db)
        return (ca < cb) | ((ca == cb) & torch.where(by_d2, da < db, ka < kb))

    # thread t owns slot t + width * m: row m of the (n, -1, width) view
    keys, vals = keys.view(n, -1, width), vals.view(n, -1, width)
    best_k, best_d = keys[:, 0], vals[:, 0]
    for m in range(1, keys.shape[1]):
        take = before(keys[:, m], vals[:, m], best_k, best_d)
        best_k = torch.where(take, keys[:, m], best_k)
        best_d = torch.where(take, vals[:, m], best_d)
    lane = torch.arange(width, device=dev)
    off = width // 2
    while off:
        ok, od = best_k[:, lane ^ off], best_d[:, lane ^ off]
        take = before(ok, od, best_k, best_d)
        best_k = torch.where(take, ok, best_k)
        best_d = torch.where(take, od, best_d)
        off //= 2
    return best_k[:, 0] & 15


def _distance_lanes(p1, p2, eps: float, max_iters: int):
    """Distance GJK over every pair of (A, N, 3) hulls, lane-vectorised."""
    support = make_hull_support_ab(p1, p2)
    n_lanes, dev = p1.shape[0], p1.device
    zero = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    pz = P3(zero, zero, zero)
    w0, a0, b0 = support(P3(torch.ones_like(zero), zero, zero))
    w, wa, wb = (w0, pz, pz, pz), (a0, pz, pz, pz), (b0, pz, pz, pz)
    n = torch.ones(n_lanes, dtype=torch.int32, device=dev)
    it = torch.zeros_like(n)
    done = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    inter = torch.zeros_like(done)
    d2, pa, pb = zero, pz, pz
    while True:
        run = ~done & (it < max_iters)
        if not bool(run.any()):
            break
        # fold the candidates in order: the first strict minimum wins
        best_d2 = best_k = bary = None
        for k, (cd2, cbary) in enumerate(_candidates(w, n)):
            if best_d2 is None:
                best_d2, bary = cd2, cbary
                best_k = torch.zeros_like(n)
                continue
            better = cd2 < best_d2
            best_d2 = torch.where(better, cd2, best_d2)
            best_k = torch.where(better, k, best_k)
            bary = [torch.where(better, x, y) for x, y in zip(cbary, bary)]
        vpt, pa_k, pb_k = pz, pz, pz
        for s in range(4):
            vpt = vpt + pscale(w[s], bary[s])
            pa_k = pa_k + pscale(wa[s], bary[s])
            pb_k = pb_k + pscale(wb[s], bary[s])
        v2 = pdot(vpt, vpt)
        now_inter = v2 < EPS_REL

        # reduce to the supporting sub-simplex (compacted to the front)
        new_w, new_a, new_b = [pz] * 4, [pz] * 4, [pz] * 4
        size = torch.zeros_like(n)
        for k, sub in enumerate(SUBSETS):
            sel = best_k == k
            size = torch.where(sel, len(sub), size)
            for s, vi in enumerate(sub):
                new_w[s] = pwhere(sel, w[vi], new_w[s])
                new_a[s] = pwhere(sel, wa[vi], new_a[s])
                new_b[s] = pwhere(sel, wb[vi], new_b[s])

        rw, ra, rb = support(-vpt)
        gap = v2 - pdot(vpt, rw)
        converged = now_inter | (gap <= EPS_REL * torch.clamp(v2, min=1.0))
        dup = torch.zeros_like(done)
        for s in range(4):
            dup = dup | ((s < size) & pcoincide(new_w[s], rw, eps))
        done_now = run & (converged | dup)
        grow = run & ~done_now
        for s in range(4):              # the new support goes to slot size
            here = (size == s) & grow
            new_w[s] = pwhere(here, rw, new_w[s])
            new_a[s] = pwhere(here, ra, new_a[s])
            new_b[s] = pwhere(here, rb, new_b[s])
        w, wa, wb = (tuple(pwhere(run, x, y) for x, y in zip(new, old))
                     for new, old in ((new_w, w), (new_a, wa), (new_b, wb)))
        n = torch.where(run, torch.where(grow, torch.clamp(size + 1, max=4),
                                         size), n)
        it = torch.where(run, it + 1, it)
        done = done | done_now
        d2 = torch.where(run, v2, d2)
        pa = pwhere(run, pa_k, pa)
        pb = pwhere(run, pb_k, pb)
        inter = torch.where(run, now_inter, inter)
    dist = torch.where(inter, 0.0, fsqrt(torch.clamp(d2, min=0.0)))
    return DistanceRows(dist, torch.stack(list(pa), 1),
                        torch.stack(list(pb), 1), inter, it, done)


def _check_order(p1, order, n_act) -> None:
    if (order is None) != (n_act is None):
        raise ValueError("order and n_act go together")
    if order is not None:
        check_tensors(p1, order=(order, torch.int32, (p1.shape[0],)),
                      n_act=(n_act, torch.int32, ()))


def _empty_rows(b, dev) -> DistanceRows:
    f32 = dict(dtype=torch.float32, device=dev)
    return DistanceRows(torch.empty(b, **f32), torch.empty((b, 3), **f32),
                        torch.empty((b, 3), **f32),
                        torch.empty(b, dtype=torch.bool, device=dev),
                        torch.empty(b, dtype=torch.int32, device=dev),
                        torch.empty(b, dtype=torch.bool, device=dev))


def _check_out(p1, out: DistanceRows) -> None:
    b = p1.shape[0]
    check_tensors(p1, distance=(out.distance, torch.float32, (b,)),
                  point_a=(out.point_a, torch.float32, (b, 3)),
                  point_b=(out.point_b, torch.float32, (b, 3)),
                  intersecting=(out.intersecting, torch.bool, (b,)),
                  iters=(out.iters, torch.int32, (b,)),
                  converged=(out.converged, torch.bool, (b,)))


def distance_hulls_plain(p1, p2, cfg: GJKEPAConfig, max_iters: int,
                         order=None, n_act=None,
                         out: DistanceRows | None = None) -> DistanceRows:
    """Plain PyTorch version of K8: distance GJK over pairs
    ``order[:n_act]`` (every pair without an order), each pair's row
    written to ``out`` (new tensors without it); other rows untouched."""
    check_hulls(p1, p2)
    _check_order(p1, order, n_act)
    if out is None:
        out = _empty_rows(p1.shape[0], p1.device)
    _check_out(p1, out)
    if order is None:
        lanes = torch.arange(p1.shape[0], device=p1.device)
    else:
        lanes = order[:int(n_act)].long()
    if lanes.numel():
        rows = _distance_lanes(p1[lanes], p2[lanes], cfg.eps_coincide,
                               max_iters)
        for dst, src in zip(out, rows):
            dst[lanes] = src
    return out


def team_size(n1: int, n2: int, restart: bool) -> int:
    """Threads of K8 that share one pair: :data:`RESTART_TEAM` for a
    restart of the unconverged pairs, K1's rule by hull size for a launch
    over every pair."""
    return RESTART_TEAM if restart else k1_team_size(n1, n2)


def _distance_hulls_cuda(p1, p2, cfg: GJKEPAConfig, max_iters: int,
                         order=None, n_act=None,
                         out: DistanceRows | None = None,
                         team: int | None = None) -> DistanceRows:
    """K8 on the card; ``team`` (threads a pair, one of TEAMS) defaults to
    :func:`team_size`."""
    b, n1, n2 = p1.shape[0], p1.shape[1], p2.shape[1]
    if team is None:
        team = team_size(n1, n2, restart=order is not None)
    if team not in TEAMS:
        raise ValueError(f"K8 team of {team} threads, expected one of {TEAMS}")
    if out is None:
        out = _empty_rows(b, p1.device)
    _check_out(p1, out)
    ptr = _build.ptr
    null = ctypes.c_void_p(None)
    _build.launch("distance_hulls", p1.device, LAUNCHES, ptr(p1), ptr(p2),
                  null if order is None else ptr(order),
                  null if n_act is None else ptr(n_act),
                  *(ptr(t) for t in out), b, n1, n2, team, cfg.eps_coincide,
                  max_iters)
    return out


@spanned("gjkepa.k8")
def distance_hulls(p1, p2, cfg: GJKEPAConfig, max_iters: int, order=None,
                   n_act=None, out: DistanceRows | None = None
                   ) -> DistanceRows:
    """K8 over (B, N, 3) float32 hull pairs ``order[:n_act]`` (``n_act`` a
    device scalar; every pair without an order), each pair's row written
    to ``out`` in place (new tensors without it).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/distance_hulls.cu``), which raises if it cannot build or
    launch."""
    check_hulls(p1, p2)
    _check_order(p1, order, n_act)
    if not _build.on_card(p1, "K8"):
        return distance_hulls_plain(p1, p2, cfg, max_iters, order, n_act,
                                    out)
    return _distance_hulls_cuda(p1, p2, cfg, max_iters, order, n_act, out)


@spanned("gjkepa.fused_gjk_distance_hulls")
def fused_gjk_distance_hulls(p1: torch.Tensor, p2: torch.Tensor,
                             mask1: torch.Tensor | None = None,
                             mask2: torch.Tensor | None = None,
                             cfg: GJKEPAConfig | None = None,
                             max_iters: int = 64, two_phase: bool = True,
                             phase1_iters: int = 10) -> DistanceResult:
    """Closest distance and witness points over (B, N, 3) float32 hull
    pairs (0 for intersecting pairs); ragged hulls via (B, N) bool masks or
    repeated-vertex padding.

    ``two_phase`` runs every pair at ``phase1_iters`` and restarts the
    unconverged ones at ``max_iters``: the same result as one pass at
    ``max_iters``, without every warp waiting on its slowest lane."""
    if cfg is None:
        cfg = GJKEPAConfig.for_f32()
    if p1.shape[0] == 0:
        raise ValueError("empty batch")
    p1 = mask_to_padding(p1, mask1).contiguous()
    p2 = mask_to_padding(p2, mask2).contiguous()
    if two_phase and phase1_iters < max_iters:
        out = distance_hulls(p1, p2, cfg, phase1_iters)
        order, n_unf = hit_first_order(~out.converged)
        distance_hulls(p1, p2, cfg, max_iters, order, n_unf, out=out)
    else:
        out = distance_hulls(p1, p2, cfg, max_iters)
    return DistanceResult(out.distance, out.point_a, out.point_b,
                          out.intersecting, out.iters)
