"""Contact derivation from the EPA normal, the portable path.

Port of ``gjkepa_tpu/ops/contact.py``: the reference's contact
post-processing (``GCLIB_GJKEPA.f90``) over (B, N, 3) vertex buffers with
optional (B, N) masks, one pair a row, where the JAX package writes one
pair and vmaps it:

  * :func:`nearest_points` (get_nearest_points, :813-855): the first
    support vertex of A along +normal and of B along -normal;
  * :func:`collision_type` (get_info_collisionType, :353-413): 2 (face-face)
    iff both support sets within TOL_FF hold >= 3 vertices, else 1;
  * :func:`collision_point_v1` (get_collisionPoint_01, :700-806) with the
    reference's sloppy sequential top-2 scan, vertices in index order;
  * :func:`collision_point_v2` (get_collisionPoint_02, :457-696): support
    sets at ``support_set_tol``, front-compacted in vertex order, through
    the (n1, n2) case tree :func:`collision_point_v2_sets`;
  * :func:`collision_point_v3` (get_collisionPoint_03, :426-452), which
    also rewrites the normal to its XY projection.

The JAX package's batch-row form of the same contract is
:func:`.contact_rows.derive_contact_rows` (the fused path's); the case
tree here runs on its helpers (FOOT_LL, and case_04's SORT_CLOCK and
IS_INSIDE_PF on member rows) with the per-pair function's SORT_CLOCK
coincidence test at 1e-12, and ``contact_shapes`` feeds it the
closed-form candidate sets, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..config import GJKEPAConfig
from .contact_rows import _foot_ll, case_04_rows
from .geom import dot3, norm3

__all__ = ["nearest_points", "collision_type", "collision_point_v1",
           "collision_point_v2", "collision_point_v2_sets",
           "collision_point_v3"]


def _masked_dots(p, mask, d):
    dots = dot3(p, d[:, None])
    return torch.where(mask, dots, -torch.inf) if mask is not None else dots


def _support_set_mask(p, mask, d, tol):
    """All vertices within ``tol`` of the support max (AddAllSupports,
    ref :509-529)."""
    dots = _masked_dots(p, mask, d)
    return dots > dots.amax(1, keepdim=True) - tol, dots


def _rows(p, idx):
    """p[i, idx[i]] for each row i: (B, 3)."""
    return torch.gather(p, 1, idx[:, None, None].expand(-1, 1, 3))[:, 0]


def _compact(p, set_mask):
    """Front-compact the members, in vertex order (list append order)."""
    order = torch.argsort((~set_mask).to(torch.int8), dim=1, stable=True)
    return (torch.gather(p, 1, order[..., None].expand(-1, -1, 3)),
            set_mask.sum(1))


def nearest_points(p1, p2, normal, mask1=None, mask2=None):
    """(B, 2, 3): p1's support vertex along +normal, p2's along -normal
    (ref :813-855)."""
    i1 = torch.argmax(_masked_dots(p1, mask1, normal), 1)
    i2 = torch.argmax(_masked_dots(p2, mask2, -normal), 1)
    return torch.stack([_rows(p1, i1), _rows(p2, i2)], 1)


def collision_type(p1, p2, normal, tol_ff, mask1=None, mask2=None):
    """(B,) int32: 2 iff both support sets within ``tol_ff`` of the support
    max have >= 3 vertices, else 1 (ref :353-413)."""
    m1, _ = _support_set_mask(p1, mask1, normal, tol_ff)
    m2, _ = _support_set_mask(p2, mask2, -normal, tol_ff)
    return torch.where((m1.sum(1) >= 3) & (m2.sum(1) >= 3), 2,
                       1).to(torch.int32)


def _sloppy_top2_scan(p, mask, d, eps):
    """The reference's stateful top-2 scan (ref :722-747): visiting the
    vertices in index order, a dot within eps of (or above) the running
    max shifts the index pair.  Returns (i1, i2) with the reference's
    found-on-the-first-hit fix (:732)."""
    dots = _masked_dots(p, mask, d)
    b = p.shape[0]
    max_dot = torch.full((b,), -torch.inf, dtype=p.dtype, device=p.device)
    i1 = torch.full((b,), -1, dtype=torch.int64, device=p.device)
    i2 = i1
    for i in range(p.shape[1]):
        upd = dots[:, i] > max_dot - eps
        if mask is not None:
            upd = upd & mask[:, i]
        max_dot, i1, i2 = (torch.where(upd, dots[:, i], max_dot),
                           torch.where(upd, i, i1), torch.where(upd, i1, i2))
    return i1, torch.where(i2 < 0, i1, i2)


def _at(p, i):
    """p[i] with a negative index counted from the end, as JAX indexes."""
    return _rows(p, torch.where(i < 0, i + p.shape[1], i))


def collision_point_v1(p1, p2, normal, cfg: GJKEPAConfig, mask1=None,
                       mask2=None):
    """Version 1, "experimental" (ref :700-806): the midpoint of the two
    lone vertices, the lone vertex of one side, or the mean of A's vertices
    within ``support_set_tol`` of its max."""
    eps = cfg.eps_coincide
    a1, a2 = _sloppy_top2_scan(p1, mask1, normal, eps)
    b1, b2 = _sloppy_top2_scan(p2, mask2, -normal, eps)
    single1, single2 = a1 == a2, b1 == b2
    pa, pb = _at(p1, a1), _at(p2, b1)
    case1 = (pa + pb) * 0.5
    case2 = torch.where(single1[:, None], pa, pb)
    set1, _ = _support_set_mask(p1, mask1, normal, cfg.support_set_tol)
    case3 = _centroid(*_compact(p1, set1))
    return torch.where((single1 & single2)[:, None], case1,
                       torch.where((single1 ^ single2)[:, None], case2,
                                   case3))


def collision_point_v2(p1, p2, normal, cfg: GJKEPAConfig, mask1=None,
                       mask2=None):
    """Version 2, "general" (ref :457-696): the (n1, n2) case tree over the
    support sets at ``support_set_tol``."""
    tol = cfg.support_set_tol
    set1, _ = _support_set_mask(p1, mask1, normal, tol)
    set2, _ = _support_set_mask(p2, mask2, -normal, tol)
    return collision_point_v2_sets(*_compact(p1, set1), *_compact(p2, set2),
                                   cfg)


def _at_least3(s):
    """Rows past the last repeat it, up to 3: JAX clamps an index past a
    short set (hulls of 1 or 2 vertices) to its last row; the cases that
    read such rows are never selected for those sets."""
    k = s.shape[1]
    return s if k >= 3 else torch.cat([s] + [s[:, -1:]] * (3 - k), 1)


def _xyz(p):
    """(B, 3) -> an (x, y, z) triple of (B,) tensors."""
    return p[:, 0], p[:, 1], p[:, 2]


def _centroid(s, n):
    k = torch.arange(s.shape[1], device=s.device)[None, :] < n[:, None]
    return (torch.where(k[:, :, None], s, 0.0).sum(dim=1)
            / torch.clamp(n, min=1).to(s.dtype)[:, None])


def collision_point_v2_sets(s1, n1, s2, n2, cfg: GJKEPAConfig):
    """The version-2 (n1, n2) case dispatch (ref :477-502) over
    front-compacted (B, K, 3) support sets with n1/n2 members in collection
    order (hull support sets here, the closed-form candidate sets of
    ``contact_shapes``)."""
    epz = cfg.eps_zero
    s1, s2 = _at_least3(s1), _at_least3(s2)
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


def collision_point_v3(p1, p2, normal, cfg: GJKEPAConfig, mask1=None,
                       mask2=None):
    """Version 3, "stator-rotor special" (ref :426-452): p2's support vertex
    along -normal (the last within eps of the running max) with z replaced
    by p1's mean z; the normal rewritten to its XY projection,
    renormalised.  Returns (point, normal)."""
    dots = _masked_dots(p2, mask2, -normal)
    max_dot = torch.full_like(dots[:, 0], -torch.inf)
    idx = torch.zeros(p2.shape[0], dtype=torch.int64, device=p2.device)
    for i in range(p2.shape[1]):
        upd = dots[:, i] > max_dot - cfg.eps_coincide
        max_dot = torch.where(upd, dots[:, i], max_dot)
        idx = torch.where(upd, i, idx)
    point = _rows(p2, idx)
    if mask1 is not None:
        zmean = (torch.where(mask1, p1[..., 2], 0.0).sum(1)
                 / torch.clamp(mask1.sum(1), min=1))
    else:
        zmean = p1[..., 2].mean(1)
    point = torch.cat([point[:, :2], zmean.to(p1.dtype)[:, None]], 1)
    flat = torch.cat([normal[:, :2], torch.zeros_like(normal[:, 2:])], 1)
    nrm = norm3(flat)
    return point, flat / torch.where(nrm > 0.0, nrm, 1.0)[:, None]
