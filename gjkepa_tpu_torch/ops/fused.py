"""Two-phase hull dispatch: K1 over every pair, K2 over the hits.

Ports the hull part of ``gjkepa_tpu/ops/fused.py``: ``FusedResult``
(:1124), ``_round_cfg`` (:1134), ``_cascade_plan`` (:1147),
``_mask_to_padding`` (:1388) and ``fused_gjkepa_hulls`` (:1507) with its
two-phase dispatch ``_run_two_phase`` (:1188-1385) re-expressed for CUDA:

  * K1 (:mod:`.fused_gjk`) runs over all B pairs;
  * a stable hit-first lane order comes from one cumsum (:1276-1281);
  * K2 (:mod:`.fused_epa`) gets that order and the hit count as a device
    scalar, so nothing waits on the host between the two kernels.

Hulls with n1 + n2 > 4096 vertices take the large-hull path instead, as in
the JAX package (:1533-1540): K12 and K13 of :mod:`.fused_streamed`, a
warp a pair, after a broadphase on the tile-padded hulls.

The TPU-only machinery is gone: the B/8 EPA prefix with its ``lax.cond``
fallback, the swapaxes layouts, the sort-for-scatter trick and the batch
padding (a CUDA kernel masks its own ragged edge).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GJKEPAConfig
from ..spans import span, spanned
from .fused_epa import epa_cascade
from .fused_gjk import GJKRows, gjk_hulls
# The JAX module's lane-vector helpers (fused.py:99-133), here from
# lane_geom, so that each has its counterpart under the same name.
from .lane_geom import (pcoincide, pcross, pdot, pnorm, pscale,  # noqa: F401
                        putz, pwhere)

__all__ = ["FusedResult", "fused_gjkepa_hulls", "fused_gjkepa_shapes",
           "fused_gjk_distance_hulls", "fused_gjkepa_hull_shapes",
           "cascade_plan", "round_cfg", "mask_to_padding", "hit_first_order",
           "hulls_result", "pdot", "pcross", "pscale", "pnorm", "putz",
           "pwhere", "pcoincide"]


class FusedResult(NamedTuple):
    hit: torch.Tensor        # (B,) bool
    status: torch.Tensor     # (B,) int32
    depth: torch.Tensor      # (B,) f32
    normal: torch.Tensor     # (B, 3) f32
    gjk_iters: torch.Tensor  # (B,) int32
    epa_iters: torch.Tensor  # (B,) int32
    distance: torch.Tensor   # (B,) f32 separation lower bound (miss lanes)


def rup8(x: int) -> int:
    return ((x + 7) // 8) * 8


def round_cfg(cfg: GJKEPAConfig | None) -> GJKEPAConfig:
    """Default to ``for_f32()`` and round the EPA caps up to multiples of 8,
    as the JAX path does (a larger cap only allows more expansion)."""
    if cfg is None:
        cfg = GJKEPAConfig.for_f32()
    if cfg.epa_max_verts % 8 or cfg.epa_max_faces % 8:
        cfg = cfg.replace(epa_max_verts=rup8(cfg.epa_max_verts),
                          epa_max_faces=rup8(cfg.epa_max_faces))
    return cfg


def cascade_plan(cfg: GJKEPAConfig) -> list[tuple[GJKEPAConfig, int]]:
    """EPA tier ladder: (cfg with the tier's face capacity, visible bound).

    Tier 1 (F=48, K=8) covers most contacts; F=88 lets slow curved
    contacts finish; the final tier is sized for the worst case
    (2*epa_max_iters+10 faces, K=16).  ``epa_max_iters == 0`` is the
    boolean-only mode: no EPA at all."""
    if cfg.epa_max_iters == 0:
        return []
    full_f = rup8(max(2 * cfg.epa_max_iters + 10, cfg.epa_max_faces))
    stages = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((48, 8), (88, 8)) if f < full_f]
    stages.append((cfg.replace(epa_max_faces=full_f), 16))
    return stages


def mask_to_padding(p: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Replace masked-out vertices with the hull's first valid vertex.

    A repeated vertex adds no geometry, and since padding rows sit after
    the valid rows the first-max support picks the same index as the
    masked form."""
    if mask is None:
        return p
    if mask.shape != p.shape[:2] or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool {tuple(p.shape[:2])}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != p.device:
        raise ValueError(f"mask on {mask.device}, hulls on {p.device}")
    first = torch.argmax(mask.to(torch.uint8), dim=1)       # first valid row
    fv = torch.gather(p, 1, first[:, None, None].expand(-1, 1, 3))
    return torch.where(mask[:, :, None], p, fv)


@spanned("gjkepa.order")
def hit_first_order(act: torch.Tensor):
    """Stable permutation putting the `act` lanes first, and their count.

    dest[i] = c-1 for active lanes and n_act + (i - c) for the rest, with
    c the inclusive prefix count; ``order`` is its inverse.  Returns int32
    ``order`` (B,) and ``n_act`` () on the device of `act`, no host sync."""
    b = act.shape[0]
    c = torch.cumsum(act.to(torch.int32), dim=0, dtype=torch.int32)
    i = torch.arange(b, dtype=torch.int32, device=act.device)
    n_act = c[-1]
    dest = torch.where(act, c - 1, n_act + i - c)
    order = torch.empty_like(i).scatter_(0, dest.long(), i)
    return order, n_act.contiguous()


def hulls_result(g: GJKRows, stages, epa) -> FusedResult:
    """The query's result from GJK rows ``g``: ``epa(order, n_act,
    stages)`` (K2 or K13) over the hit lanes, or no EPA at all in the
    boolean-only mode (no stages)."""
    if not stages:           # boolean-only: the miss path never enters EPA
        with span("gjkepa.fill"):
            zero = torch.zeros_like(g.sep)
            normal = torch.zeros_like(g.simplex[:, 0])
            epa_iters = torch.zeros_like(g.iters)
        return FusedResult(g.hit, g.status, zero, normal, g.iters, epa_iters,
                           g.sep)
    # hull pairs have no closed-form lanes, so every hit enters EPA
    order, n_act = hit_first_order(g.hit)
    e = epa(order, n_act, stages)
    return FusedResult(g.hit, e.status, e.depth, e.normal, g.iters, e.iters,
                       g.sep)


@spanned("gjkepa.fused_gjkepa_hulls")
def fused_gjkepa_hulls(p1: torch.Tensor, p2: torch.Tensor,
                       mask1: torch.Tensor | None = None,
                       mask2: torch.Tensor | None = None,
                       cfg: GJKEPAConfig | None = None,
                       use_broadphase: bool = True) -> FusedResult:
    """Batch query over hull pairs: hit/status/depth/normal, iteration
    counters and the miss-distance lower bound.

    Args:
      p1, p2: (B, N, 3) float32 vertex buffers on one device.
      mask1, mask2: optional (B, N) bool validity masks; equivalent to
        padding by repeating a real vertex.
      use_broadphase: False skips the bounding-sphere test, so every pair
        runs GJK and a miss gets GJK's verdict and separation bound.

    Pairs with n1 + n2 > 4096 vertices take the large-hull path (K12, K13;
    :func:`.fused_streamed.fused_hulls_streamed`), the rest K1 and K2.
    The JAX package's ``sort_hits`` orders lanes only (the result is the
    same either way): the port always moves the hits first.
    """
    cfg = round_cfg(cfg)
    if p1.shape[0] == 0:
        raise ValueError("empty batch")
    p1 = mask_to_padding(p1, mask1).contiguous()
    p2 = mask_to_padding(p2, mask2).contiguous()
    if streams(p1.shape[1], p2.shape[1]):
        return fused_hulls_streamed(p1, p2, cfg,
                                    use_broadphase=use_broadphase)
    g = gjk_hulls(p1, p2, cfg, use_broadphase)
    return hulls_result(g, cascade_plan(cfg), lambda *a: epa_cascade(
        p1, p2, g.simplex, g.status, *a))


# The shape, distance, hull-vs-shape and large-hull queries build on the
# pieces above (ops/fused_shapes.py, ops/fused_distance.py,
# ops/fused_hull_shapes.py, ops/fused_streamed.py).
from .fused_shapes import fused_gjkepa_shapes  # noqa: E402
from .fused_distance import fused_gjk_distance_hulls  # noqa: E402
from .fused_hull_shapes import fused_gjkepa_hull_shapes  # noqa: E402
from .fused_streamed import fused_hulls_streamed, streams  # noqa: E402
