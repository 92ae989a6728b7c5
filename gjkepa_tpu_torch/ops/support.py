"""Closed-form supports of the analytic primitives, in the local frame.

Port of the analytic half of ``gjkepa_tpu/ops/support.py`` (:84-108),
row-vectorised: ``d`` is (B, 3) and the parameters are (B,), one shape per
row.  Each returns a maximiser of <d, x> over the shape; on a zero
direction component any maximiser would do, and the sign tests keep the
JAX package's ``>=`` (the +half-extent side).  The hull half of that file
belongs to the portable path and is not ported here.
"""

from __future__ import annotations

import torch

from .lane_geom import fsqrt

__all__ = ["sphere_support", "box_support", "capsule_support",
           "cylinder_support"]


def _safe_unit(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """v / |v| row by row, zero where |v| <= eps."""
    n = fsqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    big = (n > eps)[:, None]
    return torch.where(big, v / torch.where(big, n[:, None], 1.0), 0.0)


def sphere_support(d: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    return radius[:, None] * _safe_unit(d)


def box_support(d: torch.Tensor, half_extents: torch.Tensor) -> torch.Tensor:
    return torch.where(d >= 0.0, half_extents, -half_extents)


def capsule_support(d: torch.Tensor, radius: torch.Tensor,
                    half_len: torch.Tensor) -> torch.Tensor:
    """Capsule along local z: segment (0,0,-h)..(0,0,+h) swept by radius."""
    end = torch.where(d[:, 2] >= 0.0, half_len, -half_len)
    s = radius[:, None] * _safe_unit(d)
    return torch.stack([s[:, 0], s[:, 1], s[:, 2] + end], dim=1)


def cylinder_support(d: torch.Tensor, radius: torch.Tensor,
                     half_height: torch.Tensor) -> torch.Tensor:
    """Cylinder along local z."""
    dp = torch.stack([d[:, 0], d[:, 1], torch.zeros_like(d[:, 2])], dim=1)
    rim = radius[:, None] * _safe_unit(dp)
    cap = torch.where(d[:, 2] >= 0.0, half_height, -half_height)
    return torch.stack([rim[:, 0], rim[:, 1], rim[:, 2] + cap], dim=1)
