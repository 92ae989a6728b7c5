"""The fused hull-vs-shape query: K9, K10 and their dispatch.

Ports from ``gjkepa_tpu/ops/fused.py`` the mixed kernels
``_gjk_kernel_hull_shape`` (K9, :2571) and ``_epa_cascade_kernel_hull_shape``
(K10, :2588) with ``_make_hull_shape_support`` (:2544) and
``_hull_shape_broadphase`` (:2561), and the dispatch
``fused_gjkepa_hull_shapes`` (:2620-2758).  The CUDA kernels are
``csrc/gjk_hull_shape.cu`` (a team of :func:`team_size` threads a pair) and
``csrc/epa_hull_shape.cu`` (a warp a hit, the polytope in shared memory)
over the team support of ``csrc/hull_shape.cuh``; each has its plain
PyTorch version here.  A wrapper takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.

Side A is a (B, N, 3) float32 hull, side B an analytic shape
(:class:`ShapeBatch`, read by the kernels as packed (B, 16) rows).  The
dispatch:

  1. the sphere-envelope retirement, decided once in torch: the hull lies in
     its bounding sphere, and sphere-vs-shape has a closed form for every
     kind, so a positive envelope gap above a margin certifies a miss and
     is that lane's distance;
  2. with ``sort_hits`` the lanes a bounding-sphere predicate marks active
     go first (``hit_first_order``); K9 runs every lane through that order,
     so the order only packs the active lanes into full warps and never
     decides which lanes run GJK (``sort_hits=False``: the caller's order);
  3. ``hit_first_order`` of the GJK hits, then K10 over them (capped EPA,
     the polish, capacity exits reported degenerate); every other lane
     keeps zeros and its GJK status.

Gone with the TPU: the batch padding with displaced shapes, ``_auto_block``,
the B/4 EPA prefix with its ``lax.cond`` tail and the swapped layouts.
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
from .fused import FusedResult, hit_first_order, mask_to_padding, round_cfg
from .fused_epa import EPARows, MAX_TIERS, check_stages, check_tensors
from .fused_epa import _passthrough as _miss_rows
from .fused_epa import run_cascade
from .fused_gjk import (INIT_DIRS, TEAMS, GJKRows, gjk_phase, hull_sphere,
                        hull_vertex)
from .fused_gjk import team_size as k1_team_size
from .fused_shapes import (empty_gjk_rows, gjk_args, polish_direction,
                           shape_stages)
from .lane_geom import P3, fsqrt, pnorm
from .shape_geom import (Shape, shape_of, shape_radius, shape_support_side,
                         sphere_gap)

__all__ = ["fused_gjkepa_hull_shapes", "hull_shape_retirement",
           "make_hull_shape_support", "hull_shape_broadphase",
           "gjk_hull_shape", "gjk_hull_shape_plain", "team_size",
           "epa_hull_shape", "epa_hull_shape_plain", "LAUNCHES"]

# Kernel launches made by the wrappers below (CUDA tensors only).
LAUNCHES = {"gjk_hull_shape": 0, "epa_hull_shape": 0}


def make_hull_shape_support(p1: torch.Tensor, sb: Shape):
    """Minkowski support: the hull's first maximum of <v, d> minus the
    shape's support along -d."""

    def support(d: P3) -> P3:
        return hull_vertex(p1, d) - shape_support_side(sb, -d)

    return support


def hull_shape_broadphase(p1: torch.Tensor, sb: Shape, tol):
    """The hull's bounding sphere against the shape's bounding radius."""
    c1, r1 = hull_sphere(p1)
    return pnorm(c1 - sb.pos) <= r1 + shape_radius(sb) + tol


class Envelope(NamedTuple):
    """The sphere-envelope retirement of each pair."""

    retired: torch.Tensor   # (B,) bool: a certified miss, skips GJK
    distance: torch.Tensor  # (B,) f32 envelope gap, the retired distance
    centre: torch.Tensor    # (B, 3) f32 hull centroid
    radius: torch.Tensor    # (B,) f32 largest centroid-vertex distance


@spanned("gjkepa.broadphase")
def hull_shape_retirement(p1: torch.Tensor, sb: torch.Tensor,
                          cfg: GJKEPAConfig) -> Envelope:
    """The sphere-envelope retirement (fused.py:2656-2681).

    The hull's centroid (its vertices summed in order, then divided, so the
    CPU and the card round alike) and radius sqrt(max |v - c|^2) make a
    virtual sphere; its exact gap to the shape (packed rows ``sb``) is the
    gap ``closed_form_rows`` gives a sphere (``sphere_gap``: the branches a
    sphere takes, without the others' ~1,200 launches).  A gap above
    1e-4 (1 + r + p0 + p1) retires the lane."""
    b, n = p1.shape[:2]
    c = p1[:, 0]
    for i in range(1, n):
        c = c + p1[:, i]
    c = c / n
    d = p1 - c[:, None]
    r = fsqrt((d[:, :, 0] * d[:, :, 0] + d[:, :, 1] * d[:, :, 1]
               + d[:, :, 2] * d[:, :, 2]).amax(dim=1))
    virt = torch.cat([torch.zeros((b, 1), dtype=torch.float32,
                                  device=p1.device), r[:, None],
                      torch.zeros((b, 2), dtype=torch.float32,
                                  device=p1.device), c,
                      torch.eye(3, dtype=torch.float32,
                                device=p1.device).reshape(1, 9).expand(b, 9)],
                     dim=1)
    gap = sphere_gap(shape_of(virt), shape_of(sb))
    scale = r + sb[:, 1] + sb[:, 2]
    return Envelope(gap > 1e-4 + 1e-4 * scale, gap, c, r)


# -- checks and routing -------------------------------------------------------

def _check_inputs(p1, sb, **tensors) -> None:
    """Raise on hulls, shape rows or other inputs (keywords as for
    ``check_tensors``) the kernels do not take."""
    if p1.dtype != torch.float32 or p1.ndim != 3 or p1.shape[2] != 3 \
            or p1.shape[1] < 1:
        raise ValueError(f"p1 must be float32 (B, N, 3), got {p1.dtype} "
                         f"{tuple(p1.shape)}")
    check_tensors(p1, p1=(p1, torch.float32, tuple(p1.shape)),
                  sb=(sb, torch.float32, (p1.shape[0], 16)), **tensors)
    if sb.data_ptr() % 16:
        raise ValueError("shape rows must be 16-byte aligned (the kernels "
                         "read them as float4)")


def _stack(p: P3) -> torch.Tensor:
    return torch.stack([p.x, p.y, p.z], dim=1)


# -- K9 -----------------------------------------------------------------------

def _check_k9(p1, sb, retired, order) -> None:
    b = p1.shape[0]
    _check_inputs(p1, sb, retired=(retired, torch.bool, (b,)),
                  order=(order, torch.int32, (b,)))


def gjk_hull_shape_plain(p1, sb, retired, order, cfg: GJKEPAConfig
                         ) -> GJKRows:
    """Plain PyTorch version of K9: GJK over every pair, taken in the order
    ``order`` (a permutation of the B pairs) and written to its own row."""
    _check_k9(p1, sb, retired, order)
    lanes = order.long()
    q1, qs = p1[lanes], shape_of(sb[lanes])
    active = (hull_shape_broadphase(q1, qs, cfg.broadphase_tol)
              & ~retired[lanes])
    s, status, it, sep = gjk_phase(make_hull_shape_support(q1, qs), active,
                                   cfg)
    out = empty_gjk_rows(p1.shape[0], p1.device)
    out.hit[lanes] = status == Status.HIT
    out.status[lanes] = status
    out.iters[lanes] = it
    out.sep[lanes] = sep
    out.simplex[lanes] = torch.stack([_stack(v) for v in s], dim=1)
    return out


def team_size(n1: int) -> int:
    """Threads of K9 that share one pair (a divisor of the 32-thread warp):
    K1's crossovers (``fused_gjk.TEAM_MAX_VERTICES``) by the hull's size.
    On an H100 they came within 1.5% of K9's fastest team at 24, 256 and
    1,024 vertices (PERF.md, Findings)."""
    return k1_team_size(n1, n1)


def _gjk_hull_shape_cuda(p1, sb, retired, order, cfg: GJKEPAConfig,
                         team: int | None = None) -> GJKRows:
    """K9 on the card; ``team`` (threads a pair, one of TEAMS) defaults to
    :func:`team_size`."""
    b, n1 = p1.shape[:2]
    if team is None:
        team = team_size(n1)
    if team not in TEAMS:
        raise ValueError(f"K9 team of {team} threads, expected one of {TEAMS}")
    out = empty_gjk_rows(b, p1.device)
    ptr = _build.ptr
    _build.launch("gjk_hull_shape", p1.device, LAUNCHES, ptr(p1), ptr(sb),
                  ptr(retired), ptr(order),
                  INIT_DIRS.ctypes.data_as(ctypes.c_void_p),
                  *(ptr(t) for t in out), b, n1, team, *gjk_args(cfg))
    return out


@spanned("gjkepa.k9")
def gjk_hull_shape(p1, sb, retired, order, cfg: GJKEPAConfig) -> GJKRows:
    """K9: GJK over every hull-shape pair, team j taking pair
    ``order[j]``."""
    _check_k9(p1, sb, retired, order)
    if not _build.on_card(p1, "K9"):
        return gjk_hull_shape_plain(p1, sb, retired, order, cfg)
    return _gjk_hull_shape_cuda(p1, sb, retired, order, cfg)


# -- K10 ----------------------------------------------------------------------

def _check_epa(p1, sb, simplex, status, order, n_act) -> None:
    b = p1.shape[0]
    _check_inputs(p1, sb, simplex=(simplex, torch.float32, (b, 4, 3)),
                  status=(status, torch.int32, (b,)),
                  order=(order, torch.int32, (b,)),
                  n_act=(n_act, torch.int32, ()))


def epa_hull_shape_plain(p1, sb, simplex, status, order, n_act,
                         stages) -> EPARows:
    """Plain PyTorch version of K10: the capped ladder, the polish and the
    capacity merge over pairs ``order[:n_act]``; every other pair keeps
    zero depth, normal and iterations with its GJK status."""
    _check_epa(p1, sb, simplex, status, order, n_act)
    check_stages(stages)
    out = _miss_rows(status, p1.shape[0], p1.device)
    lanes = order[:int(n_act)].long()
    if lanes.numel() == 0:
        return out
    q1, qs = p1[lanes], sb[lanes]

    def support_of(idx):
        if idx is None:
            return make_hull_shape_support(q1, shape_of(qs))
        return make_hull_shape_support(q1[idx], shape_of(qs[idx]))

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


@spanned("gjkepa.k10")
def epa_hull_shape(p1, sb, simplex, status, order, n_act, stages) -> EPARows:
    """K10 over pairs ``order[:n_act]`` (``n_act`` a device scalar), a warp
    a hit with its polytope in shared memory.  Raises, naming the bytes,
    for a face capacity whose store does not fit in a block's shared
    memory (the shape ladder's 48 faces take 4,416 B a warp)."""
    _check_epa(p1, sb, simplex, status, order, n_act)
    check_stages(stages)
    if not _build.on_card(p1, "K10"):
        return epa_hull_shape_plain(p1, sb, simplex, status, order, n_act,
                                    stages)
    lib = _build.load()
    b, dev = p1.shape[0], p1.device
    cfg = stages[0][0]
    f_max = max(c.epa_max_faces for c, _ in stages)
    tier_f = (ctypes.c_int * MAX_TIERS)(*[c.epa_max_faces for c, _ in stages])
    tier_k = (ctypes.c_int * MAX_TIERS)(*[k for _, k in stages])
    out = _miss_rows(status, b, dev)
    ptr = _build.ptr
    _build.launch("epa_hull_shape", dev, LAUNCHES, ptr(p1), ptr(sb),
                  ptr(simplex), ptr(order), ptr(n_act), *(ptr(t) for t in out),
                  b, p1.shape[1], len(stages), tier_f, tier_k, f_max,
                  cfg.eps_coincide, cfg.eps_zero, cfg.epa_max_iters,
                  explain=_build.smem_refusal(lib.epa_hull_shape_smem_bytes,
                                              f_max, dev))
    return out


# -- dispatch -----------------------------------------------------------------

@spanned("gjkepa.fused_gjkepa_hull_shapes")
def fused_gjkepa_hull_shapes(p1: torch.Tensor, shapes: ShapeBatch,
                             mask1: torch.Tensor | None = None,
                             cfg: GJKEPAConfig | None = None,
                             sort_hits: bool = True) -> FusedResult:
    """Batch query, convex hull (side A) against analytic shape (side B)
    per pair: hit/status/depth/normal, iteration counters and the miss
    distance lower bound.

    Args:
      p1: (B, N, 3) float32 hull vertices.
      shapes: :class:`ShapeBatch` of length B.
      mask1: optional (B, N) bool validity mask, equivalent to padding by
        repeating a real vertex.
      sort_hits: group the lanes a bounding-sphere test marks active before
        K9; the result is the same either way.
    """
    cfg = round_cfg(cfg)
    b = p1.shape[0]
    if b == 0:
        raise ValueError("empty batch")
    if shapes.kind.shape[0] != b:
        raise ValueError(f"batch sizes differ: {b} vs {shapes.kind.shape[0]}")
    for name, t in (("mask1", mask1),
                    *zip(("shapes." + f for f in shapes._fields), shapes)):
        if t is not None and t.device != p1.device:
            raise ValueError(f"{name} is on {t.device}, p1 on {p1.device}")
    p1 = mask_to_padding(p1, mask1).contiguous()
    sb = shapes.packed()
    env = hull_shape_retirement(p1, sb, cfg)
    if sort_hits:
        gap = pnorm(P3(*(env.centre - sb[:, 4:7]).unbind(1)))
        act = ((gap <= env.radius + shape_radius(shape_of(sb))
                + cfg.broadphase_tol) & ~env.retired)
        order, _ = hit_first_order(act)
    else:
        order = torch.arange(b, dtype=torch.int32, device=p1.device)
    g = gjk_hull_shape(p1, sb, env.retired, order, cfg)
    stages = shape_stages(cfg)
    if stages:
        order, n_act = hit_first_order(g.hit)
        depth, normal, epa_iters, status = epa_hull_shape(
            p1, sb, g.simplex, g.status, order, n_act, stages)
    else:       # boolean-only: no EPA
        depth, normal, epa_iters, status = _miss_rows(g.status, b, p1.device)
    return FusedResult(g.hit, status, depth, normal, g.iters, epa_iters,
                       torch.where(env.retired, env.distance, g.sep))
