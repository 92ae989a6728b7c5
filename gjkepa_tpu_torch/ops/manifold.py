"""Support polygons of analytic shapes (the part contact derivation needs).

Port of ``gjkepa_tpu/ops/manifold.py:59-145``, ``_first_k`` and
``_shape_support_polygon`` only, row-vectorised: one shape per row.  The
manifold clipping of that module is not part of this port yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.shapes import BOX, CAPSULE, SPHERE, rot_apply, rot_t_apply
from .lane_geom import fsqrt

__all__ = ["first_k", "shape_support_polygon", "POLY_CAP"]

POLY_CAP = 8       # support-polygon capacity per side

# box corner signs, (sx, sy, sz) with sx outermost (the candidate order)
_SIGNS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
          for sz in (-1.0, 1.0)]
# 8 cap-rim grid angles, as the JAX package computes them
_RIM = [(float(np.cos(a)), float(np.sin(a)))
        for a in np.linspace(0.0, 2 * np.pi, 8, endpoint=False)]


def first_k(sel: torch.Tensor, pts: torch.Tensor, k: int):
    """Compact the selected rows of pts (B, N, 3) into k slots, rank order.

    Returns (points (B, k, 3), valid (B, k), overflow (B,): more than k
    rows selected)."""
    cum = torch.cumsum(sel.to(torch.int32), dim=1)
    n_sel = cum[:, -1]
    slots = [torch.where((sel & (cum == slot + 1))[:, :, None], pts, 0.0)
             .sum(dim=1) for slot in range(k)]
    valid = torch.arange(k, device=sel.device)[None, :] < n_sel[:, None]
    return torch.stack(slots, dim=1), valid, n_sel > k


def shape_support_polygon(kind, params, pos, rot, n, tol, k: int = POLY_CAP):
    """Closed-form support-polygon candidates of (B,) shapes along (B, 3)
    world directions n: a fixed list of 21 local candidates (sphere point;
    8 box corners; 2 capsule ends; 8 cap-rim grid points and the exact
    lateral rim point on both caps of a cylinder), of which the shape's
    kind keeps those within tol of its support maximum, first k in
    candidate order.  Returns (world points (B, k, 3), valid (B, k),
    overflow (B,))."""
    dl = rot_t_apply(rot, n)
    r0, p1 = params[:, 0], params[:, 1]

    def pt(x, y, z):
        return torch.stack([x, y, z], dim=1)

    nrm = fsqrt(dl[:, 0] * dl[:, 0] + dl[:, 1] * dl[:, 1] + dl[:, 2] * dl[:, 2])
    nl = dl / torch.clamp(nrm, min=1e-20)[:, None]
    sph = r0[:, None] * nl
    cands = [sph]                                                  # sphere
    cands += [pt(sx * params[:, 0], sy * params[:, 1], sz * params[:, 2])
              for sx, sy, sz in _SIGNS]                             # box
    cands += [pt(sph[:, 0], sph[:, 1], sph[:, 2] + p1),
              pt(sph[:, 0], sph[:, 1], sph[:, 2] - p1)]             # capsule
    rho = fsqrt(dl[:, 0] * dl[:, 0] + dl[:, 1] * dl[:, 1])
    co = torch.where(rho > 1e-12, dl[:, 0] / torch.clamp(rho, min=1e-20), 1.0)
    si = torch.where(rho > 1e-12, dl[:, 1] / torch.clamp(rho, min=1e-20), 0.0)
    cap_z = torch.where(dl[:, 2] >= 0, 1.0, -1.0) * p1
    r64 = r0.double()
    for c, s in _RIM:               # r0 * cos taken in float64, rounded once
        cands.append(pt((r64 * c).to(r0.dtype), (r64 * s).to(r0.dtype), cap_z))
    cands += [pt(r0 * co, r0 * si, p1), pt(r0 * co, r0 * si, -p1)]  # cylinder
    local = torch.stack(cands, dim=1)                               # (B, 21, 3)

    idx = torch.arange(local.shape[1], device=dl.device)[None, :]
    kk = kind[:, None]
    kind_ok = torch.where(kk == SPHERE, idx == 0,
                          torch.where(kk == BOX, (idx >= 1) & (idx <= 8),
                                      torch.where(kk == CAPSULE,
                                                  (idx >= 9) & (idx <= 10),
                                                  idx >= 11)))
    dots = (local[:, :, 0] * dl[:, 0:1] + local[:, :, 1] * dl[:, 1:2]
            + local[:, :, 2] * dl[:, 2:3])
    m = torch.where(kind_ok, dots, -math.inf).amax(dim=1, keepdim=True)
    sel = kind_ok & (dots >= m - tol)
    pts, valid, over = first_k(sel, local, k)
    world = torch.stack([rot_apply(rot, pts[:, j], pos) for j in range(k)],
                        dim=1)
    return world, valid, over
