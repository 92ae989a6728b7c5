"""Contact manifolds: up to four contact points a pair.

Port of ``gjkepa_tpu/ops/manifold.py``, row-vectorised over (B,) pairs
where the JAX package vmaps one pair.  For each hit:

  1. each body's *support polygon* along the contact normal: the vertices
     within ``tol`` of its support maximum (+n for A, -n for B), hulls by
     their vertices, analytic shapes by a fixed candidate set (box
     corners, capsule ends, cylinder rim samples), the first ``poly_cap``
     in rank order, with a flag where more were in tol;
  2. the reference side (more support vertices), both polygons projected
     into the contact tangent plane and sorted counter-clockwise;
  3. the incident polygon clipped by the reference one (masked
     Sutherland-Hodgman over fixed capacities, every emitted vertex placed
     by its prefix-sum rank);
  4. each clipped point's depth below the reference plane along n;
  5. the standard reduction to 4 points: the deepest, the farthest from
     it, then the largest and the smallest signed area.

A vertex or edge contact (fewer than 3 reference vertices) or a clip that
empties out keeps the query's single point and depth, the reference's own
output.  The JAX package's one-hot sums and its 16-way ``where`` chain
were TPU layout choices: here the permutations are scatters and the
selections gathers.  Torch code, no kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import GJKEPAConfig
from ..models.shapes import BOX, CAPSULE, SPHERE, rot_apply, rot_t_apply
from .geom import cross3, dot3, norm3
from .lane_geom import fsqrt

__all__ = ["ManifoldResult", "manifold_batch", "manifold_shapes_batch",
           "manifold_hull_shape_batch", "first_k", "hull_support_polygon",
           "shape_support_polygon", "ccw_sort_apply", "clip_polygon",
           "reduce4", "POLY_CAP"]

POLY_CAP = 8       # support-polygon capacity per side

# box corner signs, (sx, sy, sz) with sx outermost (the candidate order)
_SIGNS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
          for sz in (-1.0, 1.0)]
# 8 cap-rim grid angles, as the JAX package computes them
_RIM = [(float(np.cos(a)), float(np.sin(a)))
        for a in np.linspace(0.0, 2 * np.pi, 8, endpoint=False)]


class ManifoldResult(NamedTuple):
    points: torch.Tensor    # (B, 4, 3) contact points (world)
    depths: torch.Tensor    # (B, 4) per-point penetration depths (>= 0)
    mask: torch.Tensor      # (B, 4) validity
    # (B,) True on a hit where a support polygon had more vertices within
    # tol than ``poly_cap`` slots: it was cut in rank order, so the
    # manifold may under-cover the contact region (re-run with a larger
    # poly_cap)
    overflow: torch.Tensor


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


def hull_support_polygon(p, mask, n, tol, k: int = POLY_CAP):
    """The vertices of hulls p (B, N, 3) (optional (B, N) masks) within tol
    of their support maximum along (B, 3) directions n: (points (B, k, 3),
    valid (B, k), overflow (B,))."""
    dots = dot3(p, n[:, None, :])
    if mask is not None:
        dots = torch.where(mask, dots, -math.inf)
    sel = dots >= dots.amax(dim=1, keepdim=True) - tol
    if mask is not None:
        sel = sel & mask
    return first_k(sel, p, k)


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


def _place(rank: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b, rank[b, i]] = x[b, i] for (B, K) ranks that permute 0..K-1."""
    idx = rank.view(rank.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.empty_like(x).scatter_(1, idx, x)


def ccw_sort_apply(p2, valid, *extras):
    """Reorder the valid 2-D points (B, K, 2) counter-clockwise around
    their centroid, invalid slots last, and apply the same permutation to
    each (B, K) or (B, K, d) tensor of ``extras``.  A point's rank counts
    the points of smaller angle, ties broken by slot.  Returns (p2, valid,
    *extras) sorted."""
    cnt = torch.clamp(valid.sum(1), min=1).to(p2.dtype)
    c = torch.where(valid[..., None], p2, 0.0).sum(1) / cnt[:, None]
    ang = torch.atan2(p2[..., 1] - c[:, 1:2], p2[..., 0] - c[:, 0:1])
    ang = torch.where(valid, ang, 3.0e38)
    iota = torch.arange(p2.shape[1], device=p2.device)
    less = ((ang[:, None, :] < ang[:, :, None])
            | ((ang[:, None, :] == ang[:, :, None])
               & (iota[None, :] < iota[:, None])))
    rank = less.sum(2)
    return tuple(_place(rank, x) for x in (p2, valid, *extras))


def clip_polygon(ref2, ref_valid, inc2, inc_z, inc_valid, cap: int):
    """Masked Sutherland-Hodgman: clip the incident polygons (inc2 (B, Ki,
    2) with heights inc_z (B, Ki)) by the convex counter-clockwise
    reference polygons ref2 (B, Kr, 2), one reference edge at a time, the
    edge e < n_ref of each row.  z interpolates linearly at the crossings.
    ``cap`` >= Ki + Kr slots hold the result (a convex clip adds at most a
    vertex an edge).  Returns (pts (B, cap, 2), z (B, cap), valid (B,
    cap))."""
    b, ki = inc2.shape[:2]
    dev = inc2.device
    n_ref = ref_valid.sum(1)
    pts = torch.zeros((b, cap, 2), dtype=inc2.dtype, device=dev)
    z = torch.zeros((b, cap), dtype=inc_z.dtype, device=dev)
    valid = torch.zeros((b, cap), dtype=torch.bool, device=dev)
    pts[:, :ki] = inc2
    z[:, :ki] = inc_z
    valid[:, :ki] = inc_valid
    iota = torch.arange(cap, device=dev)
    nxt = torch.roll(iota, -1)
    trash = 2 * cap                       # the slot of entries that emit none

    def at(x, i):                         # x[b, i[b]]
        return torch.gather(x, 1, i[:, None, None].expand(-1, 1, 2))[:, 0]

    for e in range(ref2.shape[1]):
        cnt = valid.sum(1)
        a = at(ref2, torch.clamp(n_ref - 1, min=0, max=e))
        bb = at(ref2, torch.where(e + 1 >= n_ref, 0, e + 1))
        eab = bb - a
        # the next vertex in the polygon: slot cnt-1 wraps to slot 0
        wrap = iota[None, :] == (cnt - 1)[:, None]
        p_nxt = torch.where(wrap[..., None], pts[:, :1], pts[:, nxt])
        z_nxt = torch.where(wrap, z[:, :1], z[:, nxt])
        d_cur = (eab[:, 0:1] * (pts[..., 1] - a[:, 1:2])
                 - eab[:, 1:2] * (pts[..., 0] - a[:, 0:1]))
        d_nxt = (eab[:, 0:1] * (p_nxt[..., 1] - a[:, 1:2])
                 - eab[:, 1:2] * (p_nxt[..., 0] - a[:, 0:1]))
        in_cur, in_nxt = d_cur >= 0.0, d_nxt >= 0.0
        live = iota[None, :] < cnt[:, None]
        den = d_cur - d_nxt
        t = torch.clamp(d_cur / torch.where(torch.abs(den) > 1e-20, den, 1e-20),
                        0.0, 1.0)
        p_x = pts + t[..., None] * (p_nxt - pts)
        z_x = z + t * (z_nxt - z)

        emit_self = live & in_cur
        emit_cross = live & (in_cur ^ in_nxt)
        contrib = emit_self.long() + emit_cross.long()
        cum = torch.cumsum(contrib, 1)
        slot_self = torch.where(emit_self, cum - contrib, trash)
        slot_cross = torch.where(emit_cross, cum - contrib + emit_self.long(),
                                 trash)
        # every slot below cap gets at most one source; slots from cap up
        # drop, as in the JAX package
        dest = torch.cat([slot_self, slot_cross], 1)
        new_p = torch.zeros((b, trash + 1, 2), dtype=pts.dtype, device=dev)
        new_p.scatter_(1, dest[..., None].expand(-1, -1, 2),
                       torch.cat([pts, p_x], 1))
        new_z = torch.zeros((b, trash + 1), dtype=z.dtype, device=dev)
        new_z.scatter_(1, dest, torch.cat([z, z_x], 1))
        edge_on = (e < n_ref)[:, None]
        pts = torch.where(edge_on[..., None], new_p[:, :cap], pts)
        z = torch.where(edge_on, new_z[:, :cap], z)
        valid = torch.where(edge_on, iota[None, :] < cum[:, -1:], valid)
    return pts, z, valid


def reduce4(p2, depths, valid):
    """The 4-point reduction of (B, K) candidates: the deepest, the
    farthest from it, then the largest and the smallest signed area
    against that edge, each the first maximum over the valid slots not yet
    taken.  Returns (slots (B, 4), keep (B, 4): the first min(n_valid, 4)
    slots)."""
    iota = torch.arange(p2.shape[1], device=p2.device)[None, :]
    k0 = torch.argmax(torch.where(valid, depths, -math.inf), dim=1)
    pt0 = torch.gather(p2, 1, k0[:, None, None].expand(-1, 1, 2))
    taken = iota == k0[:, None]
    d1 = fsqrt(((p2 - pt0) * (p2 - pt0)).sum(2))
    k1 = torch.argmax(torch.where(valid & ~taken, d1, -math.inf), dim=1)
    pt1 = torch.gather(p2, 1, k1[:, None, None].expand(-1, 1, 2))
    taken = taken | (iota == k1[:, None])
    e01 = pt1 - pt0
    v = p2 - pt0
    ar = e01[..., 0] * v[..., 1] - e01[..., 1] * v[..., 0]
    k2 = torch.argmax(torch.where(valid & ~taken, ar, -math.inf), dim=1)
    taken = taken | (iota == k2[:, None])
    k3 = torch.argmax(torch.where(valid & ~taken, -ar, -math.inf), dim=1)
    n_valid = valid.sum(1)
    keep = (torch.arange(4, device=p2.device)[None, :]
            < torch.clamp(n_valid, max=4)[:, None])
    return torch.stack([k0, k1, k2, k3], 1), keep


def _manifold_rows(pa, va, pb, vb, n, depth, fallback_pt, tol_inside,
                   clip_cap: int):
    """Manifolds of (B,) pairs from their support polygons pa/pb (world,
    masked by va/vb): (points (B, 4, 3), depths (B, 4), keep (B, 4))."""
    small_x = torch.abs(n[:, 0]) < 0.9
    one, zero = torch.ones_like(depth), torch.zeros_like(depth)
    helper = torch.stack([torch.where(small_x, one, zero),
                          torch.where(small_x, zero, one), zero], 1)
    u = cross3(n, helper)
    u = u / torch.clamp(norm3(u), min=1e-20)[:, None]
    v = cross3(n, u)

    def project(p):
        return (torch.stack([dot3(p, u[:, None]), dot3(p, v[:, None])], 2),
                dot3(p, n[:, None]))

    a2, az = project(pa)
    b2, bz = project(pb)
    n_a, n_b = va.sum(1), vb.sum(1)
    ref_is_a = n_a >= n_b
    ra, ra3 = ref_is_a[:, None], ref_is_a[:, None, None]
    ref2, refv = torch.where(ra3, a2, b2), torch.where(ra, va, vb)
    inc2 = torch.where(ra3, b2, a2)
    incz, incv = torch.where(ra, bz, az), torch.where(ra, vb, va)
    # the reference plane's height along n: A's max (the face at its
    # support maximum) or B's min
    ref_z = torch.where(ref_is_a,
                        torch.where(va, az, -math.inf).amax(1),
                        torch.where(vb, bz, math.inf).amin(1))

    ref2s, refvs = ccw_sort_apply(ref2, refv)
    inc2s, incvs, inczs = ccw_sort_apply(inc2, incv, incz)
    cp2, cz, cvalid = clip_polygon(ref2s, refvs, inc2s, inczs, incvs,
                                   clip_cap)

    # per-point depth: the incident height against the reference plane
    pdepth = torch.where(ra, ref_z[:, None] - cz, cz - ref_z[:, None])
    cvalid = cvalid & (pdepth > -tol_inside)
    pdepth = torch.clamp(pdepth, min=0.0)

    slots, keep = reduce4(cp2, pdepth, cvalid)
    pts2 = torch.gather(cp2, 1, slots[..., None].expand(-1, -1, 2))
    zs = torch.gather(cz, 1, slots)
    points = (pts2[..., 0:1] * u[:, None] + pts2[..., 1:2] * v[:, None]
              + zs[..., None] * n[:, None])
    depths = torch.gather(pdepth, 1, slots)

    # the fallbacks: the reference is no face (< 3 vertices) or the clip
    # emptied out
    degenerate = (torch.maximum(n_a, n_b) < 3) | ~cvalid.any(1)
    first = torch.arange(4, device=n.device) == 0
    points = torch.where((degenerate[:, None] & first)[..., None],
                         fallback_pt[:, None], points)
    depths = torch.where(degenerate[:, None] & first, depth[:, None], depths)
    keep = torch.where(degenerate[:, None], first, keep)
    return points, depths, keep


def _result(sa, va, ova, sb, vb, ovb, normal, depth, hit, cpt, tol,
            poly_cap) -> ManifoldResult:
    pts, dps, keep = _manifold_rows(sa, va, sb, vb, normal, depth, cpt,
                                    tol, 2 * poly_cap)
    return ManifoldResult(pts, dps, keep & hit[:, None], (ova | ovb) & hit)


def _tol(cfg: GJKEPAConfig | None, tol: float | None) -> float:
    cfg = cfg or GJKEPAConfig.for_f32()
    return cfg.support_set_tol if tol is None else tol


def manifold_batch(p1, p2, normal, depth, hit, contact_point,
                   mask1=None, mask2=None,
                   cfg: GJKEPAConfig | None = None,
                   tol: float | None = None,
                   poly_cap: int = POLY_CAP) -> ManifoldResult:
    """Up-to-4-point contact manifolds for hull pairs.

    Args:
      p1, p2: (B, N, 3) padded vertex buffers; mask1, mask2 optional (B, N)
        bool validity masks.
      normal, depth, hit, contact_point: outputs of a narrow-phase query
        (``gjkepa_batch`` / ``gjkepa_batch_fused``); the normal points from
        A to B.
      tol: the support-set clustering tolerance (default
        ``cfg.support_set_tol``, the reference's 0.1 rule, ref :471-529;
        ``cfg`` defaults to :meth:`GJKEPAConfig.for_f32`).
      poly_cap: support-polygon capacity per side (the clip costs ~cap^2;
        4 fits quads, e.g. boxes).
    """
    tol = _tol(cfg, tol)
    sa, va, ova = hull_support_polygon(p1, mask1, normal, tol, poly_cap)
    sb, vb, ovb = hull_support_polygon(p2, mask2, -normal, tol, poly_cap)
    return _result(sa, va, ova, sb, vb, ovb, normal, depth, hit,
                   contact_point, tol, poly_cap)


def manifold_shapes_batch(a, b, normal, depth, hit, contact_point,
                          cfg: GJKEPAConfig | None = None,
                          tol: float | None = None,
                          poly_cap: int = POLY_CAP) -> ManifoldResult:
    """Up-to-4-point contact manifolds for analytic shape pairs (two
    :class:`ShapeBatch`, pair i is (a[i], b[i])); the rest as
    :func:`manifold_batch` (cylinder caps want the full 8 slots, boxes
    4)."""
    tol = _tol(cfg, tol)
    sa, va, ova = shape_support_polygon(a.kind, a.params, a.pos, a.rot,
                                        normal, tol, poly_cap)
    sb, vb, ovb = shape_support_polygon(b.kind, b.params, b.pos, b.rot,
                                        -normal, tol, poly_cap)
    return _result(sa, va, ova, sb, vb, ovb, normal, depth, hit,
                   contact_point, tol, poly_cap)


def manifold_hull_shape_batch(p1, shapes, normal, depth, hit,
                              contact_point=None, mask1=None,
                              cfg: GJKEPAConfig | None = None,
                              tol: float | None = None,
                              poly_cap: int = POLY_CAP) -> ManifoldResult:
    """Up-to-4-point contact manifolds for hull-vs-shape pairs: side A
    (B, N, 3) hulls (optional (B, N) masks), side B a :class:`ShapeBatch`,
    e.g. the outputs of :func:`fused_gjkepa_hull_shapes`.
    ``contact_point``, the fallback point of a degenerate clip, defaults
    to the centroid of A's support polygon (a :class:`FusedResult` has no
    contact point); the rest as :func:`manifold_batch`."""
    tol = _tol(cfg, tol)
    sa, va, ova = hull_support_polygon(p1, mask1, normal, tol, poly_cap)
    sb, vb, ovb = shape_support_polygon(shapes.kind, shapes.params,
                                        shapes.pos, shapes.rot, -normal, tol,
                                        poly_cap)
    if contact_point is None:
        contact_point = (torch.where(va[..., None], sa, 0.0).sum(1)
                         / torch.clamp(va.sum(1), min=1)[:, None])
    return _result(sa, va, ova, sb, vb, ovb, normal, depth, hit,
                   contact_point, tol, poly_cap)
