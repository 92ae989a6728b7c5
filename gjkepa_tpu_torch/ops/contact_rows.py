"""Batch-row contact derivation: nearest points, contact point and type.

Port of ``gjkepa_tpu/ops/contact_rows.py`` (versions 1, 2 and 3, with and
without vertex masks): the reference's contact post-processing
(``GCLIB_GJKEPA.f90`` get_nearest_points :813-855, get_info_collisionType
:353-413, get_collisionPoint_01/02/03 :700/:457/:426) over the whole batch.
It is tensor code on the device of its inputs, not a kernel: the JAX
package left it to XLA as well.  Per-vertex quantities are (N, B) tensors
and per-pair quantities (B,), as in the JAX module, so the two read line
for line.

All reference quirks are kept: the 0.1 support clustering, the angular
SORT_CLOCK equivalence (point 0 pinned first, input order on
all-coincident, a stable sort), IS_INSIDE_PF's XOY->XOZ fallback with the
1e-12 zero clamp and first-element sign-flip test, FOOT_LL's parallel
fallback, and version 1/3's sloppy sequential top-2 scans (the running
max may drop within eps; vertices visited in index order).
"""

from __future__ import annotations

import math

import torch

from ..config import GJKEPAConfig
from .lane_geom import fsqrt

__all__ = ["derive_contact_rows", "case_04_rows"]


def _nth_member(mask, rank, k, arrs):
    """Coordinates of the k-th set member in index order ((B,) each)."""
    sel = mask & (rank == k)
    return [torch.where(sel, a, 0.0).sum(dim=0) for a in arrs]


def _utz3(x, y, z, eps):
    n = fsqrt(x * x + y * y + z * z)
    bad = n < eps
    inv = 1.0 / torch.where(bad, 1.0, n)
    return (torch.where(bad, 0.0, x * inv), torch.where(bad, 0.0, y * inv),
            torch.where(bad, 0.0, z * inv))


def _foot_pl(px, py, pz, ax, ay, az, bx, by, bz, eps):
    """Foot of the perpendicular from point p to line (a, b) (FOOT_PL)."""
    ux, uy, uz = _utz3(bx - ax, by - ay, bz - az, eps)
    t = (px - ax) * ux + (py - ay) * uy + (pz - az) * uz
    return ax + t * ux, ay + t * uy, az + t * uz


def _dot3(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _foot_ll(p1, q1, p2, q2, eps):
    """Closest points between lines (p1,q1) and (p2,q2) (FOOT_LL,
    ref :1446-1487); each argument an (x, y, z) triple of (B,) tensors."""
    d1 = tuple(b - a for a, b in zip(p1, q1))
    d2 = tuple(b - a for a, b in zip(p2, q2))
    r = tuple(a - b for a, b in zip(p1, p2))
    a = _dot3(d1, d1)
    b = _dot3(d1, d2)
    c = _dot3(d1, r)
    e = _dot3(d2, d2)
    f = _dot3(d2, r)
    d = a * e - b * b
    parallel = torch.abs(d) < eps
    safe = torch.where(parallel, 1.0, d)
    s = (b * f - c * e) / safe
    t = (a * f - b * c) / safe
    f1 = tuple(pp + s * dd for pp, dd in zip(p1, d1))
    f2 = tuple(pp + t * dd for pp, dd in zip(p2, d2))
    mid1 = tuple((pp + qq) * 0.5 for pp, qq in zip(p1, q1))
    foot = _foot_pl(*mid1, *p2, *q2, eps)
    out1 = tuple(torch.where(parallel, m, ff) for m, ff in zip(mid1, f1))
    out2 = tuple(torch.where(parallel, ff2, ff) for ff2, ff in zip(foot, f2))
    return out1, out2


def _polygon_crosses_rows(xs, ys, px, py, valid, n_valid):
    """Cyclic edge crosses of the front-sorted polygon rows (ref
    :1289-1298); zero on padding rows."""
    n = xs.shape[0]
    ridx = torch.arange(n, device=xs.device)[:, None]
    xs_roll = torch.cat([xs[1:], xs[:1]], dim=0)
    ys_roll = torch.cat([ys[1:], ys[:1]], dim=0)
    wrap = ridx == (n_valid[None, :] - 1)
    xs_n = torch.where(wrap, xs[0:1, :], xs_roll)
    ys_n = torch.where(wrap, ys[0:1, :], ys_roll)
    c = (xs_n - xs) * (py[None, :] - ys) - (ys_n - ys) * (px[None, :] - xs)
    return torch.where(valid, c, 0.0)


def _is_inside_pf_rows(sx, sy, sz, px, py, pz, valid, n_valid, eps_zero):
    """IS_INSIDE_PF (ref :1271-1337) on sorted polygon rows."""
    cxy = _polygon_crosses_rows(sx, sy, px, py, valid, n_valid)
    cxy = torch.where(torch.abs(cxy) < eps_zero, 0.0, cxy)
    use_xz = ~torch.any(cxy > 1e-15, dim=0)
    cxz = _polygon_crosses_rows(sx, sz, px, pz, valid, n_valid)
    c = torch.where(use_xz[None, :], cxz, cxy)
    flips = (c[0:1, :] * c) < 0.0
    return ~torch.any(flips & valid, dim=0)


def _extract(x, y, z, idx):
    """Rows idx ((B,) int) of three (N, B) tensors."""
    return tuple(torch.gather(a, 0, idx[None, :])[0] for a in (x, y, z))


def case_04_rows(sx, sy, sz, st, nn, cen, first3, edge0, edge1, epz,
                 same_eps):
    """Version-2 case_04, edge-face (ref :575-669), over (N, B) point rows
    with member mask ``st`` (n members, centroid ``cen``, members 0-2
    ``first3``) against the edge (edge0, edge1): the foot of the centroid
    on the edge if neither end is inside the polygon, else the edge's
    midpoint.  SORT_CLOCK (ref :1513-1575) orders the polygon: CCW angle
    from member 0 around the centroid, member 0 pinned first, input order
    when all members coincide within ``same_eps``, padding rows last."""
    fdt, dev = sx.dtype, sx.device
    (p0x, p0y, p0z), (p1x, p1y, p1z), (p2x, p2y, p2z) = first3
    e1 = (p1x - p0x, p1y - p0y, p1z - p0z)
    e2 = (p2x - p0x, p2y - p0y, p2z - p0z)
    nplx = e1[1] * e2[2] - e1[2] * e2[1]
    nply = e1[2] * e2[0] - e1[0] * e2[2]
    nplz = e1[0] * e2[1] - e1[1] * e2[0]
    v0x, v0y, v0z = p0x - cen[0], p0y - cen[1], p0z - cen[2]
    # w = normal x v0
    wx = nply * v0z - nplz * v0y
    wy = nplz * v0x - nplx * v0z
    wz = nplx * v0y - nply * v0x
    vx = sx - cen[0][None, :]
    vy = sy - cen[1][None, :]
    vz = sz - cen[2][None, :]
    yy = vx * wx[None, :] + vy * wy[None, :] + vz * wz[None, :]
    xx = vx * v0x[None, :] + vy * v0y[None, :] + vz * v0z[None, :]
    two_pi = 2.0 * math.pi
    ang = torch.remainder(torch.atan2(yy, xx) + two_pi, two_pi)
    rk = torch.cumsum(st.to(torch.int32), dim=0) - 1
    ang = torch.where(st & (rk == 0), -1.0, ang)       # member 0 first
    # all-coincident: keep input (compacted) order (:1521)
    same = ~torch.any(
        st & ((torch.abs(sx - p0x[None, :]) > same_eps)
              | (torch.abs(sy - p0y[None, :]) > same_eps)
              | (torch.abs(sz - p0z[None, :]) > same_eps)), dim=0)
    ang = torch.where(same[None, :], rk.to(fdt), ang)
    ang = torch.where(st, ang, math.inf)               # padding last
    order = torch.argsort(ang, dim=0, stable=True)
    ssx, ssy, ssz = (torch.gather(a, 0, order) for a in (sx, sy, sz))
    valid_rows = (torch.arange(sx.shape[0], device=dev)[:, None]
                  < nn[None, :])
    in0 = _is_inside_pf_rows(ssx, ssy, ssz, *edge0, valid_rows, nn,
                             epz)
    in1 = _is_inside_pf_rows(ssx, ssy, ssz, *edge1, valid_rows, nn,
                             epz)
    cnt_in = in0.to(torch.int32) + in1.to(torch.int32)
    foot = _foot_pl(*cen, *edge0, *edge1, epz)         # case_04_1
    mid = tuple((u + v) * 0.5 for u, v in zip(edge0, edge1))
    return tuple(torch.where(cnt_in == 0, f, m)
                 for f, m in zip(foot, mid))


def derive_contact_rows(p1, p2, normal, cfg: GJKEPAConfig,
                        mask1=None, mask2=None):
    """Batched contact post-processing: (B,N1,3),(B,N2,3),(B,3) ->
    (npts (B,2,3), cpoint (B,3), normal (B,3), ctype (B,) int32)."""
    fdt = p1.dtype
    eps = cfg.eps_coincide
    epz = cfg.eps_zero
    b = p1.shape[0]
    dev = p1.device

    def rows(p):
        return p[:, :, 0].T, p[:, :, 1].T, p[:, :, 2].T

    x1, y1, z1 = rows(p1)
    x2, y2, z2 = rows(p2)
    m1 = None if mask1 is None else mask1.T
    m2 = None if mask2 is None else mask2.T
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]

    def dots_of(x, y, z, m, dx, dy, dz):
        d = x * dx[None, :] + y * dy[None, :] + z * dz[None, :]
        return torch.where(m, d, -math.inf) if m is not None else d

    dots1 = dots_of(x1, y1, z1, m1, nx, ny, nz)
    dots2 = dots_of(x2, y2, z2, m2, -nx, -ny, -nz)

    # -- nearest points (ref :813-855) --------------------------------------
    np1 = _extract(x1, y1, z1, torch.argmax(dots1, dim=0))
    np2 = _extract(x2, y2, z2, torch.argmax(dots2, dim=0))
    npts = torch.stack([torch.stack(np1, dim=1), torch.stack(np2, dim=1)],
                       dim=1)

    # -- support sets at the 0.1 clustering tol (ref :471-472, :509-529) ----
    def support_set(dots, m):
        s = dots > dots.amax(dim=0, keepdim=True) - cfg.support_set_tol
        return s & m if m is not None else s

    set1 = support_set(dots1, m1)
    set2 = support_set(dots2, m2)
    n1 = set1.sum(dim=0)
    n2 = set2.sum(dim=0)
    rank1 = torch.cumsum(set1.to(torch.int32), dim=0) - 1
    rank2 = torch.cumsum(set2.to(torch.int32), dim=0) - 1
    a0, a1, a2 = (_nth_member(set1, rank1, k, (x1, y1, z1)) for k in range(3))
    b0, b1, b2 = (_nth_member(set2, rank2, k, (x2, y2, z2)) for k in range(3))

    def centroid(st, x, y, z, n):
        c = torch.clamp(n, min=1).to(fdt)
        return tuple(torch.where(st, a, 0.0).sum(dim=0) / c for a in (x, y, z))

    cen1 = centroid(set1, x1, y1, z1, n1)
    cen2 = centroid(set2, x2, y2, z2, n2)

    version = cfg.version
    if version == 2:
        # case_01: vertex-vertex midpoint (:531-541)
        c01 = tuple((a + bb) * 0.5 for a, bb in zip(a0, b0))
        # case_03: edge-edge -> midpoint of line-line feet (:554-572)
        f1, f2 = _foot_ll(a0, a1, b0, b1, epz)
        c03 = tuple((u + v) * 0.5 for u, v in zip(f1, f2))

        c04_p1poly = case_04_rows(x1, y1, z1, set1, n1, cen1, (a0, a1, a2),
                                  b0, b1, epz, epz)
        c04_p2poly = case_04_rows(x2, y2, z2, set2, n2, cen2, (b0, b1, b2),
                                  a0, a1, epz, epz)
        c05 = cen1                                             # (:672-694)

        def sel(cond, t, f):
            return tuple(torch.where(cond, a, bb) for a, bb in zip(t, f))

        res = sel((n1 == 1) & (n2 == 1), c01,
                  sel((n1 == 1) & (n2 >= 2), a0,
                      sel((n1 >= 2) & (n2 == 1), b0,
                          sel((n1 == 2) & (n2 == 2), c03,
                              sel((n1 == 2) & (n2 >= 3), c04_p2poly,
                                  sel((n1 >= 3) & (n2 == 2), c04_p1poly,
                                      c05))))))
        cpoint = torch.stack(res, dim=1)
        out_normal = normal
    elif version == 1:
        # sloppy sequential top-2 scans (ref :722-747), all lanes at once
        def scan2(dots, m):
            mx = torch.full((b,), -math.inf, dtype=fdt, device=dev)
            i1 = torch.full((b,), -1, dtype=torch.int64, device=dev)
            i2 = i1
            for i in range(dots.shape[0]):
                di = dots[i]
                upd = di > mx - eps
                if m is not None:
                    upd = upd & m[i]
                mx, i1, i2 = (torch.where(upd, di, mx), torch.where(upd, i, i1),
                              torch.where(upd, i1, i2))
            return i1, torch.where(i2 < 0, i1, i2)

        a_1, a_2 = scan2(dots1, m1)
        b_1, b_2 = scan2(dots2, m2)
        single1 = a_1 == a_2
        single2 = b_1 == b_2
        # a lane with no selected vertex (all masked) extracts zeros
        pa = tuple(torch.where(a_1 >= 0, v, 0.0)
                   for v in _extract(x1, y1, z1, a_1.clamp(min=0)))
        pb = tuple(torch.where(b_1 >= 0, v, 0.0)
                   for v in _extract(x2, y2, z2, b_1.clamp(min=0)))
        case1 = tuple((u + v) * 0.5 for u, v in zip(pa, pb))
        case2 = tuple(torch.where(single1, u, v) for u, v in zip(pa, pb))
        case3 = cen1                                            # 0.1-set mean
        res = tuple(
            torch.where(single1 & single2, c1,
                        torch.where(single1 ^ single2, c2, c3))
            for c1, c2, c3 in zip(case1, case2, case3))
        cpoint = torch.stack(res, dim=1)
        out_normal = normal
    elif version == 3:
        mx = torch.full((b,), -math.inf, dtype=fdt, device=dev)
        idx = torch.zeros((b,), dtype=torch.int64, device=dev)
        for i in range(dots2.shape[0]):
            upd = dots2[i] > mx - eps
            mx = torch.where(upd, dots2[i], mx)
            idx = torch.where(upd, i, idx)
        px_, py_, _ = _extract(x2, y2, z2, idx)
        if m1 is not None:
            zmean = (torch.where(m1, z1, 0.0).sum(dim=0)
                     / torch.clamp(m1.sum(dim=0), min=1))
        else:
            zmean = z1.mean(dim=0)
        cpoint = torch.stack([px_, py_, zmean.to(fdt)], dim=1)
        nl = fsqrt(nx * nx + ny * ny)
        inv = 1.0 / torch.where(nl > 0.0, nl, 1.0)
        out_normal = torch.stack(
            [torch.where(nl > 0.0, nx * inv, nx),
             torch.where(nl > 0.0, ny * inv, ny), torch.zeros_like(nx)], dim=1)
    else:
        raise ValueError(f"unknown contact-point version {version!r} "
                         "(reference supports 1, 2, 3; ref :329-340)")

    # -- contact type (ref :353-413), with the (possibly rewritten) normal --
    onx, ony, onz = out_normal[:, 0], out_normal[:, 1], out_normal[:, 2]
    td1 = dots_of(x1, y1, z1, m1, onx, ony, onz)
    td2 = dots_of(x2, y2, z2, m2, -onx, -ony, -onz)
    tset1 = td1 > td1.amax(dim=0, keepdim=True) - cfg.face_contact_tol
    tset2 = td2 > td2.amax(dim=0, keepdim=True) - cfg.face_contact_tol
    if m1 is not None:
        tset1 = tset1 & m1
    if m2 is not None:
        tset2 = tset2 & m2
    cc = tset1.sum(dim=0)
    dd = tset2.sum(dim=0)
    ctype = torch.where((cc >= 3) & (dd >= 3), 2, 1).to(torch.int32)
    return npts, cpoint, out_normal, ctype
