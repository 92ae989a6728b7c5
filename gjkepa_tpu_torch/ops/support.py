"""Support maps: padded hulls and the analytic primitives.

Port of ``gjkepa_tpu/ops/support.py``, row-vectorised: ``d`` is (B, 3),
one query per row.  The hull support (:42-74) is the first maximum of
<d, v> over a padded (B, N, 3) vertex buffer, masked rows excluded (ties go
to the lower index, as the reference's strict-``>`` scan); it returns the
witness on each side with the Minkowski point.  The analytic supports
(:84-108) take (B,) parameters and return a maximiser of <d, x> over the
shape in its local frame; on a zero direction component any maximiser would
do, and the sign tests keep the JAX package's ``>=`` (the +half-extent
side).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lane_geom import fsqrt

__all__ = ["SupportResult", "hull_support_point", "minkowski_support_hulls",
           "make_hull_support",
           "sphere_support", "box_support", "capsule_support",
           "cylinder_support"]


class SupportResult(NamedTuple):
    """Support of the Minkowski difference A - B along each row's dir."""

    w: torch.Tensor   # (B, 3) support point of A - B
    a: torch.Tensor   # (B, 3) witness on A
    b: torch.Tensor   # (B, 3) witness on B


def hull_support_point(verts: torch.Tensor, d: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 3): the first vertex of each (N, 3) row maximising <d, v>."""
    dots = (verts[:, :, 0] * d[:, 0:1] + verts[:, :, 1] * d[:, 1:2]
            + verts[:, :, 2] * d[:, 2:3])
    if mask is not None:
        dots = torch.where(mask, dots, -torch.inf)
    i = torch.argmax(dots, dim=1)
    return torch.gather(verts, 1, i[:, None, None].expand(-1, 1, 3))[:, 0]


def minkowski_support_hulls(p1, p2, d, mask1=None, mask2=None
                            ) -> SupportResult:
    """support_mapping(p1, p2, d) = argmax<d, p1> - argmax<-d, p2> row by
    row (ref :1030-1062)."""
    a = hull_support_point(p1, d, mask1)
    b = hull_support_point(p2, -d, mask2)
    return SupportResult(a - b, a, b)


def make_hull_support(p1, p2, mask1=None, mask2=None):
    """Minkowski support over two padded hull batches (B, N, 3), with
    optional (B, N) bool validity masks."""

    def support(d: torch.Tensor) -> SupportResult:
        return minkowski_support_hulls(p1, p2, d, mask1, mask2)

    return support


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
