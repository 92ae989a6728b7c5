"""The fused analytic-shape query: K5, K6a, K6b, K7 and their dispatch.

Ports from ``gjkepa_tpu/ops/fused.py`` the shape kernels ``_cf_kernel_shapes``
(K5, :1880), ``_gjk_sub_kernel_shapes`` (K6a, :1910), ``_gjk_kernel_shapes``
(K6b, :1935) and ``_epa_cascade_kernel_shapes`` (K7, :2131) with
``_polish_direction`` (:752), and the dispatch ``fused_gjkepa_shapes``
(:2200-2530).  The CUDA kernels are ``csrc/cf_shapes.cu``,
``csrc/gjk_shapes.cu`` (K6a and K6b) and ``csrc/epa_shapes.cu``; each has
its plain PyTorch version here.  A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.

The kernels read shapes as packed (B, 16) float32 rows
(``ShapeBatch.packed``).  The dispatch, ``sort_hits=True`` (the split
pipeline):

  1. K5 over every pair in the caller's order: closed-form lanes get their
     exact row, every other lane the broadphase-miss row, and each lane its
     GJK activity ``act``;
  2. ``hit_first_order(act)``: the GJK lanes first, their count on the
     device;
  3. K6a over those lanes, a quad of threads a pair, writing back to their
     own pairs; its grid also writes the inactive row of every other pair
     (``order[n_act:]``), so no row is filled beforehand;
  4. ``hit_first_order`` of the GJK hits, then K7 over them, the other
     pairs passing their row through.

``sort_hits=False`` runs K6b over every pair in place of 1-3.  Both give
the same per-pair result.  Nothing waits on the host between the kernels.
The TPU-only machinery is gone: the pad to 128 pairs with displaced copies,
the ``C1 = B/8`` and ``C2 = C1/8`` caps with their ``lax.cond`` fallbacks
(the port takes the split pipeline at any density), the sort for the
scatter, the sort of EPA lanes by GJK iteration count (a block-straggler
measure; per-lane results do not depend on it), and the swapped layouts.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..config import GJKEPAConfig
from ..spans import spanned
from ..models.shapes import ShapeBatch
from ..types import Status
from .fused import FusedResult, hit_first_order, round_cfg, rup8
from .fused_epa import (EPARows, MAX_TIERS, check_stages, check_tensors,
                        run_cascade)
from .fused_gjk import INIT_DIRS, GJKRows, gjk_phase
from .lane_geom import P3, fsqrt, pcross, pdot, pnorm, putz, pwhere
from .shape_geom import (cf_kind_mask, closed_form_rows, make_shape_support,
                         shape_broadphase, shape_of)

__all__ = ["fused_gjkepa_shapes", "shape_stages", "retirement",
           "apply_retired", "CFRows",
           "ShapeGJKRows", "cf_shapes", "cf_shapes_plain", "gjk_sub_shapes",
           "gjk_sub_shapes_plain", "gjk_shapes", "gjk_shapes_plain",
           "epa_shapes", "epa_shapes_plain", "polish_direction", "LAUNCHES"]

# Kernel launches made by the wrappers below (CUDA tensors only).
LAUNCHES = {"cf_shapes": 0, "gjk_sub_shapes": 0, "gjk_shapes": 0,
            "epa_shapes": 0}

SMOOTH_EPA_CAP = 16     # capped EPA iterations before the polish
# The polish (fused.py:752): rounds of 8 ring probes, the first step, and
# the step's factor after each round.  csrc/shape_geom.cuh has the same.
POLISH_ROUNDS = 6
POLISH_SPREAD = 0.45
POLISH_SHRINK = 1.0 / 3.0


class CFRows(NamedTuple):
    """K5's per-pair output."""

    hit: torch.Tensor       # (B,) bool
    status: torch.Tensor    # (B,) int32
    depth: torch.Tensor     # (B,) f32
    normal: torch.Tensor    # (B, 3) f32
    distance: torch.Tensor  # (B,) f32
    act: torch.Tensor       # (B,) bool: the lane runs GJK


class ShapeGJKRows(NamedTuple):
    """K6b's per-pair output: the GJK rows plus the closed-form channel."""

    hit: torch.Tensor        # (B,) bool
    status: torch.Tensor     # (B,) int32
    iters: torch.Tensor      # (B,) int32
    sep: torch.Tensor        # (B,) f32
    simplex: torch.Tensor    # (B, 4, 3) f32
    final: torch.Tensor      # (B,) bool: closed-form lane
    cf_depth: torch.Tensor   # (B,) f32
    cf_normal: torch.Tensor  # (B, 3) f32


def shape_stages(cfg: GJKEPAConfig) -> list[tuple[GJKEPAConfig, int]]:
    """The shapes EPA ladder (fused.py:2263-2268): at most 16 iterations,
    F = rup8(max(2*cap+10, 48)) faces, visible bound 8 then 16.  Empty for
    the boolean-only mode (epa_max_iters == 0)."""
    if cfg.epa_max_iters == 0:
        return []
    cap = min(SMOOTH_EPA_CAP, cfg.epa_max_iters)
    c = cfg.replace(epa_max_iters=cap,
                    epa_max_faces=rup8(max(2 * cap + 10, 48)))
    return [(c, 8), (c, 16)]


# -- checks and routing -------------------------------------------------------

def _check_rows(sa, sb, retired) -> None:
    b = sa.shape[0]
    check_tensors(sa, sa=(sa, torch.float32, (b, 16)),
                  sb=(sb, torch.float32, (b, 16)),
                  retired=(retired, torch.bool, (b,)))
    if sa.data_ptr() % 16 or sb.data_ptr() % 16:
        raise ValueError("shape rows must be 16-byte aligned (the kernels "
                         "read them as float4)")


def gjk_args(cfg: GJKEPAConfig):
    """The GJK kernels' config arguments, in their C order."""
    return (cfg.eps_coincide, cfg.eps_zero,
            cfg.eps_coincide * cfg.eps_coincide,  # rounded once, as gjk_phase
            cfg.broadphase_tol, cfg.gjk_max_iters)


def empty_gjk_rows(b, dev) -> GJKRows:
    """GJK rows of lanes that never run: the inactive row, all zeros
    (status MISS_BROADPHASE)."""
    return GJKRows(torch.zeros(b, dtype=torch.bool, device=dev),
                   torch.zeros(b, dtype=torch.int32, device=dev),
                   torch.zeros(b, dtype=torch.int32, device=dev),
                   torch.zeros(b, dtype=torch.float32, device=dev),
                   torch.zeros((b, 4, 3), dtype=torch.float32, device=dev))


def _stack(p: P3) -> torch.Tensor:
    return torch.stack([p.x, p.y, p.z], dim=1)


# -- K5 -----------------------------------------------------------------------

def cf_shapes_plain(sa, sb, retired, cfg: GJKEPAConfig) -> CFRows:
    """Plain PyTorch version of K5."""
    _check_rows(sa, sb, retired)
    A, B = shape_of(sa), shape_of(sb)
    cf = closed_form_rows(A, B, cfg.broadphase_tol)
    fin = cf.final
    status = torch.where(fin, cf.status, Status.MISS_BROADPHASE).to(torch.int32)
    # depth and normal are zero off the closed-form hits already
    return CFRows(status == Status.HIT, status, cf.depth, _stack(cf.normal),
                  torch.where(fin, torch.clamp(cf.gap, min=0.0), 0.0),
                  ~fin & ~retired & shape_broadphase(A, B, cfg.broadphase_tol))


@spanned("gjkepa.k5")
def cf_shapes(sa, sb, retired, cfg: GJKEPAConfig) -> CFRows:
    """K5 over (B, 16) packed shape rows, in the caller's order."""
    _check_rows(sa, sb, retired)
    if not _build.on_card(sa, "K5"):
        return cf_shapes_plain(sa, sb, retired, cfg)
    b, dev = sa.shape[0], sa.device
    out = CFRows(torch.empty(b, dtype=torch.bool, device=dev),
                 torch.empty(b, dtype=torch.int32, device=dev),
                 torch.empty(b, dtype=torch.float32, device=dev),
                 torch.empty((b, 3), dtype=torch.float32, device=dev),
                 torch.empty(b, dtype=torch.float32, device=dev),
                 torch.empty(b, dtype=torch.bool, device=dev))
    ptr = _build.ptr
    _build.launch("cf_shapes", dev, LAUNCHES, ptr(sa), ptr(sb), ptr(retired),
                  *(ptr(t) for t in out), b, cfg.broadphase_tol)
    return out


# -- K6a / K6b ----------------------------------------------------------------

def _check_order(sa, order, n_act) -> None:
    check_tensors(sa, order=(order, torch.int32, (sa.shape[0],)),
                  n_act=(n_act, torch.int32, ()))


def gjk_sub_shapes_plain(sa, sb, retired, order, n_act,
                         cfg: GJKEPAConfig) -> GJKRows:
    """Plain PyTorch version of K6a: GJK over pairs ``order[:n_act]``, the
    other pairs left with the inactive row."""
    _check_rows(sa, sb, retired)
    _check_order(sa, order, n_act)
    out = empty_gjk_rows(sa.shape[0], sa.device)
    lanes = order[:int(n_act)].long()
    if lanes.numel() == 0:
        return out
    A, B = shape_of(sa[lanes]), shape_of(sb[lanes])
    active = (shape_broadphase(A, B, cfg.broadphase_tol)
              & ~cf_kind_mask(A.kind, B.kind) & ~retired[lanes])
    s, status, it, sep = gjk_phase(make_shape_support(A, B), active, cfg)
    out.hit[lanes] = status == Status.HIT
    out.status[lanes] = status
    out.iters[lanes] = it
    out.sep[lanes] = sep
    out.simplex[lanes] = torch.stack([_stack(v) for v in s], dim=1)
    return out


def _unwritten_gjk_rows(b, dev) -> GJKRows:
    """GJK rows for a kernel that writes every one of them: no fills."""
    return GJKRows(torch.empty(b, dtype=torch.bool, device=dev),
                   torch.empty(b, dtype=torch.int32, device=dev),
                   torch.empty(b, dtype=torch.int32, device=dev),
                   torch.empty(b, dtype=torch.float32, device=dev),
                   torch.empty((b, 4, 3), dtype=torch.float32, device=dev))


@spanned("gjkepa.k6a")
def gjk_sub_shapes(sa, sb, retired, order, n_act,
                   cfg: GJKEPAConfig) -> GJKRows:
    """K6a: GJK over the compacted lanes ``order[:n_act]`` (``n_act`` a
    device scalar), written back to their own pairs, a quad of threads a
    pair; the kernel writes the inactive row of pairs ``order[n_act:]``.
    ``order`` is a permutation of the pairs (``hit_first_order``'s), so
    every row is written once."""
    _check_rows(sa, sb, retired)
    _check_order(sa, order, n_act)
    if not _build.on_card(sa, "K6a"):
        return gjk_sub_shapes_plain(sa, sb, retired, order, n_act, cfg)
    out = _unwritten_gjk_rows(sa.shape[0], sa.device)
    ptr = _build.ptr
    _build.launch("gjk_sub_shapes", sa.device, LAUNCHES, ptr(sa), ptr(sb),
                  ptr(retired), ptr(order), ptr(n_act),
                  INIT_DIRS.ctypes.data_as(ctypes.c_void_p),
                  *(ptr(t) for t in out), sa.shape[0], *gjk_args(cfg))
    return out


def gjk_shapes_plain(sa, sb, retired, cfg: GJKEPAConfig) -> ShapeGJKRows:
    """Plain PyTorch version of K6b."""
    _check_rows(sa, sb, retired)
    A, B = shape_of(sa), shape_of(sb)
    cf = closed_form_rows(A, B, cfg.broadphase_tol)
    active = shape_broadphase(A, B, cfg.broadphase_tol) & ~cf.final & ~retired
    s, status, it, sep = gjk_phase(make_shape_support(A, B), active, cfg)
    status = torch.where(cf.final, cf.status, status)
    sep = torch.where(cf.final, torch.clamp(cf.gap, min=0.0), sep)
    return ShapeGJKRows(status == Status.HIT, status, it, sep,
                        torch.stack([_stack(v) for v in s], dim=1), cf.final,
                        cf.depth, _stack(cf.normal))


@spanned("gjkepa.k6b")
def gjk_shapes(sa, sb, retired, cfg: GJKEPAConfig) -> ShapeGJKRows:
    """K6b: closed forms and GJK over every pair, in the caller's order."""
    _check_rows(sa, sb, retired)
    if not _build.on_card(sa, "K6b"):
        return gjk_shapes_plain(sa, sb, retired, cfg)
    b, dev = sa.shape[0], sa.device
    g = _unwritten_gjk_rows(b, dev)     # the kernel writes every row
    out = ShapeGJKRows(*g, torch.empty(b, dtype=torch.bool, device=dev),
                       torch.empty(b, dtype=torch.float32, device=dev),
                       torch.empty((b, 3), dtype=torch.float32, device=dev))
    ptr = _build.ptr
    _build.launch("gjk_shapes", dev, LAUNCHES, ptr(sa), ptr(sb), ptr(retired),
                  INIT_DIRS.ctypes.data_as(ctypes.c_void_p),
                  *(ptr(t) for t in out), b, *gjk_args(cfg))
    return out


# -- K7 -----------------------------------------------------------------------

def polish_direction(support, depth, normal: P3, status, ok):
    """Fixed-cost refinement of (depth, normal) after the capped EPA
    (``_polish_direction`` with ``promote_capacity=True``).

    Depth is min over unit d of h(d) = <support(d), d>.  A 3x3 tangent-grid
    descent around the normal probes the 8 ring points of each of
    ``POLISH_ROUNDS`` rounds (the centre skipped, ``k2 = k + (k >= 4)``),
    starting at step ``POLISH_SPREAD`` and multiplying it by
    ``POLISH_SHRINK`` after the 8th; a probe replaces the best on strict
    ``<``.
    Lanes with ``~ok`` or a non-unit normal pass through; polished lanes
    report HIT.  Returns (depth, normal P3, status)."""
    ok = ok & (pnorm(normal) > 0.5)
    small_x = torch.abs(normal.x) < 0.9
    zero = torch.zeros_like(depth)
    helper = P3(torch.where(small_x, 1.0, 0.0), torch.where(small_x, 0.0, 1.0),
                zero)
    u = putz(pcross(normal, helper), 1e-20)
    v = pcross(normal, u)

    def h_at(a, b):
        # |n + a u + b v|^2 = 1 + a^2 + b^2 exactly (orthonormal frame)
        inv = 1.0 / fsqrt(1.0 + a * a + b * b)
        d = P3((normal.x + a * u.x + b * v.x) * inv,
               (normal.y + a * u.y + b * v.y) * inv,
               (normal.z + a * u.z + b * v.z) * inv)
        return pdot(support(d), d), d

    a0, b0 = zero, zero
    best_h, _ = h_at(a0, b0)
    s = torch.full_like(depth, POLISH_SPREAD)
    for r in range(8 * POLISH_ROUNDS):
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
            s = s * POLISH_SHRINK
    _, d_best = h_at(a0, b0)
    return (torch.where(ok, best_h, depth), pwhere(ok, d_best, normal),
            torch.where(ok, Status.HIT, status).to(torch.int32))


def _check_epa(sa, sb, simplex, status, depth, normal, order, n_act) -> None:
    b = sa.shape[0]
    check_tensors(sa, sa=(sa, torch.float32, (b, 16)),
                  sb=(sb, torch.float32, (b, 16)),
                  simplex=(simplex, torch.float32, (b, 4, 3)),
                  status=(status, torch.int32, (b,)),
                  depth=(depth, torch.float32, (b,)),
                  normal=(normal, torch.float32, (b, 3)))
    _check_order(sa, order, n_act)


def _passthrough(status, depth, normal) -> EPARows:
    return EPARows(depth.clone(), normal.clone(), torch.zeros_like(status),
                   status.clone())


def epa_shapes_plain(sa, sb, simplex, status, depth, normal, order, n_act,
                     stages) -> EPARows:
    """Plain PyTorch version of K7: the capped ladder, the polish and the
    capacity merge over pairs ``order[:n_act]``; every other pair passes
    (depth, normal, 0, status) through."""
    _check_epa(sa, sb, simplex, status, depth, normal, order, n_act)
    check_stages(stages)
    out = _passthrough(status, depth, normal)
    lanes = order[:int(n_act)].long()
    if lanes.numel() == 0:
        return out
    qa, qb = sa[lanes], sb[lanes]

    def support_of(idx):
        if idx is None:
            return make_shape_support(shape_of(qa), shape_of(qb))
        return make_shape_support(shape_of(qa[idx]), shape_of(qb[idx]))

    d, n, it, st = run_cascade(support_of, simplex[lanes], stages)
    d, n, st = polish_direction(support_of(None), d, n, st,
                                torch.ones_like(lanes, dtype=torch.bool))
    # a capacity exit the polish did not take is degenerate to callers
    st = torch.where(st == Status.HIT_EPA_CAPACITY, Status.HIT_EPA_DEGENERATE,
                     st)
    out.depth[lanes] = d
    out.normal[lanes] = _stack(n)
    out.iters[lanes] = it
    out.status[lanes] = st
    return out


@spanned("gjkepa.k7")
def epa_shapes(sa, sb, simplex, status, depth, normal, order, n_act,
               stages) -> EPARows:
    """K7 over pairs ``order[:n_act]`` (``n_act`` a device scalar), a warp
    a hit with its polytope in shared memory.  Raises, naming the bytes,
    for a face capacity whose store does not fit in a block's shared
    memory (the shape ladder's 48 faces take 4,416 B a warp)."""
    _check_epa(sa, sb, simplex, status, depth, normal, order, n_act)
    check_stages(stages)
    if not _build.on_card(sa, "K7"):
        return epa_shapes_plain(sa, sb, simplex, status, depth, normal, order,
                                n_act, stages)
    lib = _build.load()
    b, dev = sa.shape[0], sa.device
    cfg = stages[0][0]
    f_max = max(c.epa_max_faces for c, _ in stages)
    tier_f = (ctypes.c_int * MAX_TIERS)(*[c.epa_max_faces for c, _ in stages])
    tier_k = (ctypes.c_int * MAX_TIERS)(*[k for _, k in stages])
    out = _passthrough(status, depth, normal)
    ptr = _build.ptr
    _build.launch("epa_shapes", dev, LAUNCHES, ptr(sa), ptr(sb), ptr(simplex),
                  ptr(order), ptr(n_act), *(ptr(t) for t in out), b,
                  len(stages), tier_f, tier_k, f_max, cfg.eps_coincide,
                  cfg.eps_zero, cfg.epa_max_iters,
                  explain=_build.smem_refusal(lib.epa_shapes_smem_bytes,
                                              f_max, dev))
    return out


# -- dispatch -----------------------------------------------------------------

def _dot3(u, v):
    return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]


@spanned("gjkepa.broadphase")
def retirement(a: ShapeBatch, b: ShapeBatch):
    """The capsule-envelope retirement (fused.py:2304-2350).

    A cylinder lies inside the capsule of the same radius and half-height,
    and the capsule-capsule gap is exact, so for {capsule, cylinder}^2 pairs
    without a closed form a positive envelope gap is a certified miss.  The
    1e-4 margin keeps razor-edge lanes in GJK, so a true hit never retires.
    Decided once here; the kernels read the bit.  Returns (retired (B,)
    bool, env_dist (B,) f32)."""
    ka, kb = a.kind, b.kind
    pa, pb = a.params.to(torch.float32), b.params.to(torch.float32)
    r1, l1, r2, l2 = pa[:, 0], pa[:, 1], pb[:, 0], pb[:, 1]
    pos_a, pos_b = a.pos.to(torch.float32), b.pos.to(torch.float32)
    u1 = a.rot.to(torch.float32)[:, :, 2]
    u2 = b.rot.to(torch.float32)[:, :, 2]
    rv = pos_a - pos_b
    bb, cc, ff = _dot3(u1, u2), _dot3(u1, rv), _dot3(u2, rv)
    den = 1.0 - bb * bb
    s0 = torch.where(den > 1e-12,
                     (ff * bb - cc) / torch.where(den > 1e-12, den, 1.0), 0.0)
    s = torch.minimum(torch.maximum(s0, -l1), l1)
    t = torch.minimum(torch.maximum(s * bb + ff, -l2), l2)
    s = torch.minimum(torch.maximum(t * bb - cc, -l1), l1)
    dv = (pos_b + u2 * t[:, None]) - (pos_a + u1 * s[:, None])
    env_gap = fsqrt(_dot3(dv, dv)) - r1 - r2
    swept_both = (((ka == 2) | (ka == 3)) & ((kb == 2) | (kb == 3))
                  & ~cf_kind_mask(ka, kb))
    retired = swept_both & (env_gap > 1e-4 + 1e-4 * (r1 + r2))
    return retired, torch.clamp(env_gap, min=0.0)


def apply_retired(res: FusedResult, retired, env_dist) -> FusedResult:
    zi = torch.zeros_like(res.gjk_iters)
    return FusedResult(
        hit=res.hit & ~retired,
        status=torch.where(retired, Status.MISS_BROADPHASE,
                           res.status).to(torch.int32),
        depth=torch.where(retired, 0.0, res.depth),
        normal=torch.where(retired[:, None], 0.0, res.normal),
        gjk_iters=torch.where(retired, zi, res.gjk_iters),
        epa_iters=torch.where(retired, zi, res.epa_iters),
        distance=torch.where(retired, env_dist, res.distance))


@spanned("gjkepa.fused_gjkepa_shapes")
def fused_gjkepa_shapes(a: ShapeBatch, b: ShapeBatch,
                        cfg: GJKEPAConfig | None = None,
                        sort_hits: bool = True) -> FusedResult:
    """Batch query over analytic shape pairs: hit/status/depth/normal,
    iteration counters and the miss-distance lower bound.

    ``sort_hits=True`` runs the split pipeline (K5, K6a over the GJK lanes,
    K7 over the hits); ``sort_hits=False`` runs K6b over every pair, then
    K7.  Both give the same result; on CPU tensors the plain versions run."""
    cfg = round_cfg(cfg)
    n = a.kind.shape[0]
    if n == 0:
        raise ValueError("empty batch")
    if b.kind.shape[0] != n:
        raise ValueError(f"batch sizes differ: {n} vs {b.kind.shape[0]}")
    for name, t in (*zip(("a." + f for f in a._fields), a),
                    *zip(("b." + f for f in b._fields), b)):
        if t.device != a.kind.device:
            raise ValueError(f"{name} is on {t.device}, a.kind on "
                             f"{a.kind.device}")
    sa, sb = a.packed(), b.packed()
    retired, env_dist = retirement(a, b)
    if sort_hits:
        c = cf_shapes(sa, sb, retired, cfg)
        order, n_act = hit_first_order(c.act)
        g = gjk_sub_shapes(sa, sb, retired, order, n_act, cfg)
        # pairs outside the subset hold K6a's inactive row; K5's is theirs
        hit = torch.where(c.act, g.hit, c.hit)
        status = torch.where(c.act, g.status, c.status)
        depth, normal = c.depth, c.normal
        distance = torch.where(c.act, g.sep, c.distance)
        epa_lanes = g.hit
    else:
        g = gjk_shapes(sa, sb, retired, cfg)
        hit, status, distance = g.hit, g.status, g.sep
        depth, normal = g.cf_depth, g.cf_normal
        epa_lanes = g.hit & ~g.final
    stages = shape_stages(cfg)
    if stages:
        order, n_act = hit_first_order(epa_lanes)
        e = epa_shapes(sa, sb, g.simplex, status, depth, normal, order, n_act,
                       stages)
        depth, normal, epa_iters, status = e
    else:       # boolean-only: closed-form lanes keep their depth and normal
        epa_iters = torch.zeros_like(g.iters)
    return apply_retired(FusedResult(hit, status, depth, normal, g.iters,
                                      epa_iters, distance), retired, env_dist)
