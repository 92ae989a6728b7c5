"""Contact derivation for analytic shape pairs (ref :329-343 on shapes).

Port of ``gjkepa_tpu/ops/contact_shapes.py``, with the version-2 case tree
``collision_point_v2_sets`` of ``gjkepa_tpu/ops/contact.py:142-196``,
row-vectorised over the batch.  Analytic shapes have no vertex arrays, so
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
from .contact_rows import _foot_ll, case_04_rows
from .lane_geom import fsqrt
from .manifold import shape_support_polygon

__all__ = ["derive_contact_shapes", "collision_point_v2_sets"]

_K = 8  # candidate-set capacity (box face = 4, cylinder cap rim = 8)


def _support_first(kind, params, pos, rot, d):
    """Support point with the cloud tie rule: strict > on box faces."""
    w = shape_support_world(kind, params, pos, rot, d)
    wbox = rot_apply(rot, torch.where(rot_t_apply(rot, d) > 0.0, params,
                                      -params), pos)
    return torch.where((kind == BOX)[:, None], wbox, w)


def _xyz(p):
    """(B, 3) -> an (x, y, z) triple of (B,) tensors."""
    return p[:, 0], p[:, 1], p[:, 2]


def _centroid(s, n):
    k = torch.arange(s.shape[1], device=s.device)[None, :] < n[:, None]
    return (torch.where(k[:, :, None], s, 0.0).sum(dim=1)
            / torch.clamp(n, min=1).to(s.dtype)[:, None])


def collision_point_v2_sets(s1, n1, s2, n2, cfg: GJKEPAConfig):
    """The version-2 (n1, n2) case dispatch (ref :477-502) over
    front-compacted (B, K, 3) support sets with n1/n2 members."""
    epz = cfg.eps_zero
    a0, a1 = _xyz(s1[:, 0]), _xyz(s1[:, 1])
    b0, b1 = _xyz(s2[:, 0]), _xyz(s2[:, 1])
    c01 = (s1[:, 0] + s2[:, 0]) * 0.5                      # vertex-vertex
    f1, f2 = _foot_ll(a0, a1, b0, b1, epz)                 # edge-edge
    c03 = torch.stack([(u + v) * 0.5 for u, v in zip(f1, f2)], dim=1)

    def case_04(poly, n_poly, e0, e1):
        """Edge-face: poly is the >= 3 set, (e0, e1) the edge.  The sets
        are front-compacted, so their member mask is the first n rows; the
        coincidence test of SORT_CLOCK is the JAX package's 1e-12
        (``sort_clock_indices``)."""
        members = (torch.arange(poly.shape[1], device=poly.device)[:, None]
                   < n_poly[None, :])
        rows = tuple(poly[:, :, j].T for j in range(3))
        first3 = tuple(_xyz(poly[:, i]) for i in range(3))
        return torch.stack(case_04_rows(
            *rows, members, n_poly, _xyz(_centroid(poly, n_poly)), first3,
            e0, e1, epz, 1e-12), dim=1)

    c04_p1poly = case_04(s1, n1, b0, b1)                   # n1 >= 3, n2 == 2
    c04_p2poly = case_04(s2, n2, a0, a1)                   # n1 == 2, n2 >= 3
    c05 = _centroid(s1, n1)                                # face-face

    def sel(cond, t, f):
        return torch.where(cond[:, None], t, f)

    return sel((n1 == 1) & (n2 == 1), c01,
               sel((n1 == 1) & (n2 >= 2), s1[:, 0],
                   sel((n1 >= 2) & (n2 == 1), s2[:, 0],
                       sel((n1 == 2) & (n2 == 2), c03,
                           sel((n1 == 2) & (n2 >= 3), c04_p2poly,
                               sel((n1 >= 3) & (n2 == 2), c04_p1poly,
                                   c05))))))


def derive_contact_shapes(a: ShapeBatch, b: ShapeBatch, normal,
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
