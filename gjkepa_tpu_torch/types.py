"""Result and status types of narrow-phase queries.

Port of ``gjkepa_tpu/types.py:18-57``.  The reference reports failures
interactively and silently returns non-hit after its iteration caps; every
query here instead returns a per-query ``status`` code for those branches,
plus iteration counters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Status:
    """Per-query status codes (int32)."""

    MISS_BROADPHASE = 0   # rejected by bounding-sphere envelope (:76-77)
    MISS_INIT = 1         # init phase gave up, or v3/v4 degenerate
    MISS_GJK = 2          # GJK declared non-hit: degenerate simplex,
    #                       stagnation, or iteration cap
    HIT = 3               # origin contained; EPA converged
    HIT_EPA_CAP = 4       # hit, but EPA hit its iteration cap (:299-303)
    HIT_EPA_DEGENERATE = 5  # hit, but EPA could not expand
    # Internal cascade code, never in a public result: the EPA kernel ran
    # out of capacity (face buffer / visible-set bound), which a larger
    # cascade tier can fix.  Left over after the final tier it becomes
    # HIT_EPA_DEGENERATE.
    HIT_EPA_CAPACITY = 6


class CollisionResult(NamedTuple):
    """Full narrow-phase result over a batch of B pairs.

    Same field names, shapes and dtypes as the JAX package's result.
    """

    hit: torch.Tensor               # (B,) bool     — collision_       (:47)
    colli_type: torch.Tensor        # (B,) int32    — colliType_ 0/1/2 (:48)
    nearest_points: torch.Tensor    # (B, 2, 3) f32 — nearest_points_  (:49)
    normal: torch.Tensor            # (B, 3) f32    — collision_normal_ (:50)
    contact_point: torch.Tensor     # (B, 3) f32    — collision_point_ (:51)
    depth: torch.Tensor             # (B,) f32      — penetration_depth_ (:52)
    # -- extensions (absent in the reference) --------------------------------
    distance: torch.Tensor          # (B,) f32      — separation lower bound
    status: torch.Tensor            # (B,) int32    — Status code
    gjk_iters: torch.Tensor         # (B,) int32
    epa_iters: torch.Tensor         # (B,) int32
