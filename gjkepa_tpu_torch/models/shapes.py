"""Analytic shape batches: sphere, box, capsule, cylinder.

Port of ``gjkepa_tpu/models/shapes.py``.  A :class:`ShapeBatch` is a
struct of arrays, one shape per row, with the JAX package's layout; the
support maps run over all rows at once (the kind picks a branch per row by
``torch.where``, where the JAX package vmaps a ``lax.switch``).

World-frame support: ``s_world(d) = R @ s_local(R^T d) + t``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.support import (SupportResult, box_support, capsule_support,
                           cylinder_support, sphere_support)

__all__ = [
    "SPHERE", "BOX", "CAPSULE", "CYLINDER", "SupportResult",
    "ShapeBatch", "spheres", "boxes", "capsules", "cylinders", "concat_shapes",
    "shape_support_world", "make_shape_pair_support",
]

SPHERE = 0
BOX = 1
CAPSULE = 2
CYLINDER = 3


class ShapeBatch(NamedTuple):
    """SoA batch of analytic shapes.

    params layout by kind:
      SPHERE:   [radius, 0, 0]
      BOX:      half_extents (3,)
      CAPSULE:  [radius, half_length, 0]   (axis = local z)
      CYLINDER: [radius, half_height, 0]   (axis = local z)
    """

    kind: torch.Tensor    # (B,)    int32
    params: torch.Tensor  # (B, 3)  float
    pos: torch.Tensor     # (B, 3)  float world position
    rot: torch.Tensor     # (B, 3, 3) float local->world rotation

    def __len__(self):
        return self.kind.shape[0]

    @classmethod
    def from_numpy(cls, kind, params, pos, rot, device="cuda",
                   dtype=torch.float32) -> "ShapeBatch":
        """Carry a batch across from arrays (e.g. a JAX ``ShapeBatch``'s
        fields through ``np.asarray``) onto ``device``: the card unless the
        caller names another (``device="cpu"`` for the plain versions)."""
        def t(x, dt):           # a copy: the source may be read-only
            return torch.from_numpy(np.array(x)).to(device=device, dtype=dt)
        return cls(t(kind, torch.int32), t(params, dtype), t(pos, dtype),
                   t(rot, dtype))

    def packed(self) -> torch.Tensor:
        """(B, 16) float32 rows ``[kind, params(3), pos(3), rot(9) row-major]``:
        the layout the shape kernels read (``_pack_rows``, fused.py:2163)."""
        b = self.kind.shape[0]
        return torch.cat([self.kind.to(torch.float32)[:, None],
                          self.params.to(torch.float32),
                          self.pos.to(torch.float32),
                          self.rot.to(torch.float32).reshape(b, 9)],
                         dim=1).contiguous()


def _mk(kind, params, pos, rot, dtype, device) -> ShapeBatch:
    params = torch.as_tensor(params, dtype=dtype, device=device)
    b = params.shape[0]
    pos = (torch.zeros((b, 3), dtype=dtype, device=device) if pos is None
           else torch.as_tensor(pos, dtype=dtype, device=device))
    if rot is None:
        rot = torch.eye(3, dtype=dtype, device=device).expand(b, 3, 3)
    rot = torch.as_tensor(rot, dtype=dtype, device=device).contiguous()
    return ShapeBatch(torch.full((b,), kind, dtype=torch.int32, device=device),
                      params, pos, rot)


def _col(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(-1, 1)


def spheres(radius, pos=None, rot=None, dtype=torch.float32,
            device="cuda"):
    r = _col(radius, dtype, device)
    return _mk(SPHERE, torch.cat([r, torch.zeros_like(r).expand(-1, 2)], 1),
               pos, rot, dtype, r.device)


def boxes(half_extents, pos=None, rot=None, dtype=torch.float32,
          device="cuda"):
    h = torch.as_tensor(half_extents, dtype=dtype, device=device).reshape(-1, 3)
    return _mk(BOX, h, pos, rot, dtype, h.device)


def capsules(radius, half_length, pos=None, rot=None, dtype=torch.float32,
             device="cuda"):
    r = _col(radius, dtype, device)
    h = _col(half_length, dtype, r.device)
    return _mk(CAPSULE, torch.cat([r, h, torch.zeros_like(r)], 1), pos, rot,
               dtype, r.device)


def cylinders(radius, half_height, pos=None, rot=None, dtype=torch.float32,
              device="cuda"):
    r = _col(radius, dtype, device)
    h = _col(half_height, dtype, r.device)
    return _mk(CYLINDER, torch.cat([r, h, torch.zeros_like(r)], 1), pos, rot,
               dtype, r.device)


def concat_shapes(*batches: ShapeBatch) -> ShapeBatch:
    return ShapeBatch(*(torch.cat(parts) for parts in zip(*batches)))


def rot_t_apply(rot, d):
    """R^T d row by row, each sum left to right."""
    return torch.stack([rot[:, 0, j] * d[:, 0] + rot[:, 1, j] * d[:, 1]
                        + rot[:, 2, j] * d[:, 2] for j in range(3)], dim=1)


def rot_apply(rot, s, pos):
    """R s + t row by row, each sum left to right."""
    return torch.stack([rot[:, i, 0] * s[:, 0] + rot[:, i, 1] * s[:, 1]
                        + rot[:, i, 2] * s[:, 2] + pos[:, i]
                        for i in range(3)], dim=1)


def _support_local(kind, d, params):
    p0, p1 = params[:, 0], params[:, 1]
    out = sphere_support(d, p0)
    for k, s in ((BOX, box_support(d, params)),
                 (CAPSULE, capsule_support(d, p0, p1)),
                 (CYLINDER, cylinder_support(d, p0, p1))):
        out = torch.where((kind == k)[:, None], s, out)
    return out


def shape_support_world(kind, params, pos, rot, d):
    """Support points of (B,) shapes in world frame along (B, 3) world
    directions (``>=`` on every sign test)."""
    return rot_apply(rot, _support_local(kind, rot_t_apply(rot, d), params),
                     pos)


def make_shape_pair_support(a: ShapeBatch, b: ShapeBatch):
    """Minkowski support over the rows of two shape batches."""

    def support(d: torch.Tensor) -> SupportResult:
        wa = shape_support_world(a.kind, a.params, a.pos, a.rot, d)
        wb = shape_support_world(b.kind, b.params, b.pos, b.rot, -d)
        return SupportResult(wa - wb, wa, wb)

    return support
