"""Contact derivation for analytic shape pairs (ref :329-343 on shapes).

Port of ``gjkepa_tpu/ops/contact_shapes.py``, row-vectorised over the
batch, through the version-2 case tree of :mod:`.contact`
(``collision_point_v2_sets``, ``gjkepa_tpu/ops/contact.py:142-196``), as
in the JAX package.  Analytic shapes have no vertex arrays, so
the support SETS feeding the reference's case trees are the closed-form
candidate sets of :func:`.manifold.shape_support_polygon` (box corners,
capsule ends, cylinder rim samples, the sphere point), front-compacted in
candidate order, and go through the same version-2 (n1, n2) dispatch, with
``contact_rows``'s FOOT_LL and edge-face case (SORT_CLOCK, IS_INSIDE_PF,
FOOT_PL).

Versions on shapes, as in the JAX package:

  * 2: the case tree on the candidate sets;
  * 1: single/multi from the set sizes; midpoint / lone point / mean of
    A's set;
  * 3: B's support point along -normal (``>=`` ties, the last vertex of
    the reference's sloppy scan) with A's centre z; normal rewritten to
    its XY projection.

Nearest points take the cloud tie rule (strict ``>`` on box faces, the
first corner in candidate order).  Contact type: both sets within TOL_FF
of the support maximum have >= 3 members -> 2, else 1.
"""

from __future__ import annotations

import torch

from ..config import GJKEPAConfig
from ..models.shapes import (BOX, ShapeBatch, rot_apply, rot_t_apply,
                             shape_support_world)
from .contact import _centroid, collision_point_v2_sets
from .lane_geom import fsqrt
from .manifold import shape_support_polygon

__all__ = ["derive_contact_shapes_batch", "collision_point_v2_sets"]

_K = 8  # candidate-set capacity (box face = 4, cylinder cap rim = 8)


def _support_first(kind, params, pos, rot, d):
    """Support point with the cloud tie rule: strict > on box faces."""
    w = shape_support_world(kind, params, pos, rot, d)
    wbox = rot_apply(rot, torch.where(rot_t_apply(rot, d) > 0.0, params,
                                      -params), pos)
    return torch.where((kind == BOX)[:, None], wbox, w)


def derive_contact_shapes_batch(a: ShapeBatch, b: ShapeBatch, normal,
                                cfg: GJKEPAConfig):
    """Contact derivation for (B,) analytic shape pairs from (B, 3) normals
    (A -> B): (nearest_points (B, 2, 3), contact_point (B, 3), normal
    (B, 3), colli_type (B,) int32), meaningful on hit lanes only."""
    npts = torch.stack([_support_first(*a, normal),
                        _support_first(*b, -normal)], dim=1)
    sa, va, _ = shape_support_polygon(*a, normal, cfg.support_set_tol, _K)
    sb, vb, _ = shape_support_polygon(*b, -normal, cfg.support_set_tol, _K)
    n1 = va.sum(dim=1)
    n2 = vb.sum(dim=1)

    if cfg.version == 2:
        cpoint = collision_point_v2_sets(sa, n1, sb, n2, cfg)
        out_normal = normal
    elif cfg.version == 1:
        single1, single2 = n1 == 1, n2 == 1
        case1 = 0.5 * (sa[:, 0] + sb[:, 0])
        case2 = torch.where(single1[:, None], sa[:, 0], sb[:, 0])
        cpoint = torch.where((single1 & single2)[:, None], case1,
                             torch.where((single1 ^ single2)[:, None], case2,
                                         _centroid(sa, n1)))
        out_normal = normal
    elif cfg.version == 3:
        wb = shape_support_world(*b, -normal)
        cpoint = torch.stack([wb[:, 0], wb[:, 1], a.pos[:, 2]], dim=1)
        nn = torch.stack([normal[:, 0], normal[:, 1],
                          torch.zeros_like(normal[:, 2])], dim=1)
        nrm = fsqrt(nn[:, 0] * nn[:, 0] + nn[:, 1] * nn[:, 1])
        out_normal = nn / torch.where(nrm > 0.0, nrm, 1.0)[:, None]
    else:
        raise ValueError(f"unknown contact-point version {cfg.version!r} "
                         "(reference supports 1, 2, 3; ref :329-340)")

    _, ta, _ = shape_support_polygon(*a, out_normal, cfg.face_contact_tol, _K)
    _, tb, _ = shape_support_polygon(*b, -out_normal, cfg.face_contact_tol, _K)
    ctype = torch.where((ta.sum(dim=1) >= 3) & (tb.sum(dim=1) >= 3), 2, 1)
    return npts, cpoint, out_normal, ctype.to(torch.int32)
