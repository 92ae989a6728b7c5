"""Analytic-shape device functions, plain versions: K3 and K4.

Ports ``gjkepa_tpu/ops/fused.py:1598-1864``: the packed-shape support map
(K3: ``_shape_support_side``, ``_make_shape_support``, ``_shape_radius``,
``_shape_broadphase``) and the in-kernel closed forms (K4:
``_closed_form_rows``, ``_cf_kind_mask``).  They are device functions of
the shape kernels K5-K7, not kernels of their own; their CUDA twins are in
``csrc/shape_geom.cuh`` and keep the same operation order.

A shape is a packed (B, 16) float32 row ``[kind, p0, p1, p2, pos(3),
rot(9) row-major]`` (``ShapeBatch.packed``); here it is taken apart into
16 (B,) columns, so every formula reads as scalar code over the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import Status
from .lane_geom import P3, fsqrt, pcross, pdot, pnorm, pscale, pwhere

__all__ = ["Shape", "shape_of", "shape_support_side", "make_shape_support",
           "shape_radius", "shape_broadphase", "closed_form_rows",
           "sphere_gap", "cf_kind_mask", "ClosedForm"]

BIG = 3.4e38


class Shape(NamedTuple):
    """One packed shape row per lane, as (B,) columns."""

    kind: torch.Tensor
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    pos: P3
    r: tuple          # r00, r01, r02, r10, r11, r12, r20, r21, r22


def shape_of(packed: torch.Tensor) -> Shape:
    c = packed.unbind(1)
    return Shape(c[0], c[1], c[2], c[3], P3(c[4], c[5], c[6]), c[7:16])


def _to_local(s: Shape, d: P3) -> P3:
    """R^T d."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = s.r
    return P3(r00 * d.x + r10 * d.y + r20 * d.z,
              r01 * d.x + r11 * d.y + r21 * d.z,
              r02 * d.x + r12 * d.y + r22 * d.z)


def _to_world(s: Shape, v: P3) -> P3:
    """R v (no translation)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = s.r
    return P3(r00 * v.x + r01 * v.y + r02 * v.z,
              r10 * v.x + r11 * v.y + r12 * v.z,
              r20 * v.x + r21 * v.y + r22 * v.z)


def _safe_inv(n):
    return torch.where(n > 1e-20, 1.0 / torch.where(n > 1e-20, n, 1.0), 0.0)


def shape_support_side(s: Shape, d: P3) -> P3:
    """World support point of one side along (B,) directions d (K3)."""
    dl = _to_local(s, d)
    sph = pscale(dl, _safe_inv(pnorm(dl)) * s.p0)
    box = P3(torch.where(dl.x >= 0.0, s.p0, -s.p0),
             torch.where(dl.y >= 0.0, s.p1, -s.p1),
             torch.where(dl.z >= 0.0, s.p2, -s.p2))
    cap_end = torch.where(dl.z >= 0.0, s.p1, -s.p1)
    cap = P3(sph.x, sph.y, sph.z + cap_end)
    invp = _safe_inv(fsqrt(dl.x * dl.x + dl.y * dl.y))
    cyl = P3(s.p0 * dl.x * invp, s.p0 * dl.y * invp, cap_end)
    sl = pwhere(s.kind < 0.5, sph,
                pwhere(s.kind < 1.5, box, pwhere(s.kind < 2.5, cap, cyl)))
    w = _to_world(s, sl)
    return P3(w.x + s.pos.x, w.y + s.pos.y, w.z + s.pos.z)


def make_shape_support(sa: Shape, sb: Shape):
    """Minkowski support over two packed shape sides (K3)."""

    def support(d: P3) -> P3:
        return shape_support_side(sa, d) - shape_support_side(sb, -d)

    return support


def shape_radius(s: Shape):
    """Conservative bounding radius (K3)."""
    rbox = fsqrt(s.p0 * s.p0 + s.p1 * s.p1 + s.p2 * s.p2)
    return torch.where(s.kind < 0.5, s.p0,
                       torch.where(s.kind < 1.5, rbox, s.p0 + s.p1))


def shape_broadphase(sa: Shape, sb: Shape, tol):
    """Bounding-sphere overlap of the two sides (K3)."""
    return (pnorm(sa.pos - sb.pos)
            <= shape_radius(sa) + shape_radius(sb) + tol)


def cf_kind_mask(ka, kb):
    """The closed-form pair kinds of closed_form_rows (K4), from the kind
    codes (float packed columns or int32 ``ShapeBatch.kind``):
    {sphere, capsule}^2, sphere-box, box-box, sphere-cylinder."""
    is_ss1 = (ka < 0.5) | ((ka > 1.5) & (ka < 2.5))
    is_ss2 = (kb < 0.5) | ((kb > 1.5) & (kb < 2.5))
    s_b = (ka < 0.5) & (torch.abs(kb - 1.0) < 0.5)
    b_s = (torch.abs(ka - 1.0) < 0.5) & (kb < 0.5)
    s_c = (ka < 0.5) & (kb > 2.5)
    c_s = (ka > 2.5) & (kb < 0.5)
    b_b = (torch.abs(ka - 1.0) < 0.5) & (torch.abs(kb - 1.0) < 0.5)
    return (is_ss1 & is_ss2) | s_b | b_s | s_c | c_s | b_b


class ClosedForm(NamedTuple):
    final: torch.Tensor    # (B,) bool: the pair kind has a closed form
    depth: torch.Tensor    # (B,) f32, 0 unless a closed-form hit
    normal: P3             # A -> B, zero unless a closed-form hit
    gap: torch.Tensor      # (B,) f32 separation (closed-form lanes)
    status: torch.Tensor   # (B,) int32 (closed-form lanes)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _sign(c):
    return torch.where(c >= 0.0, 1.0, -1.0)


def _sphere_vs_box(c_sph: P3, r_sph, box: Shape):
    d = c_sph - box.pos
    dl = _to_local(box, d)
    hx, hy, hz = box.p0, box.p1, box.p2
    cl = P3(_clip(dl.x, -hx, hx), _clip(dl.y, -hy, hy), _clip(dl.z, -hz, hz))
    delta = dl - cl
    d_out = pnorm(delta)
    outside = d_out > 1e-12
    n_out = pscale(delta, -1.0 / torch.clamp(d_out, min=1e-20))
    penx = hx - torch.abs(dl.x)
    peny = hy - torch.abs(dl.y)
    penz = hz - torch.abs(dl.z)
    m = torch.minimum(penx, torch.minimum(peny, penz))
    ax_x = (penx <= peny) & (penx <= penz)
    ax_y = ~ax_x & (peny <= penz)
    ax_z = ~ax_x & ~ax_y
    n_in = P3(-torch.where(ax_x, _sign(dl.x), 0.0),
              -torch.where(ax_y, _sign(dl.y), 0.0),
              -torch.where(ax_z, _sign(dl.z), 0.0))
    depth = torch.where(outside, r_sph - d_out, r_sph + m)
    nw = _to_world(box, pwhere(outside, n_out, n_in))
    return depth, nw, torch.clamp(d_out - r_sph, min=0.0)


def _sphere_vs_cyl(c_sph: P3, r_sph, cyl: Shape):
    rc, hc = cyl.p0, cyl.p1
    dl = _to_local(cyl, c_sph - cyl.pos)
    rho = fsqrt(dl.x * dl.x + dl.y * dl.y)
    inv_rho = 1.0 / torch.clamp(rho, min=1e-20)
    # exactly 1.0 inside (clip semantics, fused.py:1770-1772)
    scale = torch.where(rho > rc, rc * inv_rho, 1.0)
    qz = _clip(dl.z, -hc, hc)
    delta = P3(dl.x - dl.x * scale, dl.y - dl.y * scale, dl.z - qz)
    d_out = pnorm(delta)
    outside = d_out > 1e-12
    n_out = pscale(delta, -1.0 / torch.clamp(d_out, min=1e-20))
    pen_lat = rc - rho
    pen_cap = hc - torch.abs(dl.z)
    use_lat = pen_lat <= pen_cap
    lx = torch.where(rho > 1e-12, dl.x * inv_rho, 1.0)
    ly = torch.where(rho > 1e-12, dl.y * inv_rho, 0.0)
    n_in = P3(torch.where(use_lat, -lx, 0.0), torch.where(use_lat, -ly, 0.0),
              torch.where(use_lat, 0.0, -_sign(dl.z)))
    depth = torch.where(outside, r_sph - d_out,
                        r_sph + torch.minimum(pen_lat, pen_cap))
    nw = _to_world(cyl, pwhere(outside, n_out, n_in))
    return depth, nw, torch.clamp(d_out - r_sph, min=0.0)


def _box_box_sat(sa: Shape, sb: Shape):
    """SAT over the 15 axes: ax(3), bx(3), cross(ax_i, bx_j) i-major; the
    strict < keeps the first minimal axis."""
    ha = (sa.p0, sa.p1, sa.p2)
    hb = (sb.p0, sb.p1, sb.p2)
    ax = [P3(sa.r[j], sa.r[3 + j], sa.r[6 + j]) for j in range(3)]
    bx = [P3(sb.r[j], sb.r[3 + j], sb.r[6 + j]) for j in range(3)]
    t = sb.pos - sa.pos
    best = torch.full_like(sa.p0, BIG)
    zero = torch.zeros_like(sa.p0)
    bn = P3(zero, zero, zero)
    sep = torch.full_like(sa.p0, -BIG)
    for L in ax + bx + [pcross(ax[i], bx[j]) for i in range(3)
                        for j in range(3)]:
        ln2 = pdot(L, L)
        valid = ln2 > 1e-12
        inv = 1.0 / fsqrt(torch.where(valid, ln2, 1.0))
        s = pdot(t, L) * inv
        ra = (ha[0] * torch.abs(pdot(ax[0], L))
              + ha[1] * torch.abs(pdot(ax[1], L))
              + ha[2] * torch.abs(pdot(ax[2], L))) * inv
        rb = (hb[0] * torch.abs(pdot(bx[0], L))
              + hb[1] * torch.abs(pdot(bx[1], L))
              + hb[2] * torch.abs(pdot(bx[2], L))) * inv
        ov = ra + rb - torch.abs(s)
        sep = torch.maximum(sep, torch.where(valid, -ov, -BIG))
        ovv = torch.where(valid, ov, BIG)
        better = ovv < best
        best = torch.where(better, ovv, best)
        bn = pwhere(better, pscale(L, inv * _sign(s)), bn)
    return best, bn, torch.clamp(sep, min=0.0)


def _swept_pair(sa: Shape, sb: Shape):
    """{sphere, capsule}^2: the segment-segment closest points (clamps
    s -> t -> s) and the radii; (depth, normal A -> B, gap)."""
    k1, k2 = sa.kind, sb.kind
    r1, r2 = sa.p0, sb.p0
    pos1, pos2 = sa.pos, sb.pos
    l1 = torch.where((k1 > 1.5) & (k1 < 2.5), sa.p1, 0.0)
    l2 = torch.where((k2 > 1.5) & (k2 < 2.5), sb.p1, 0.0)
    u1 = P3(sa.r[2], sa.r[5], sa.r[8])          # R column 2 (local z)
    u2 = P3(sb.r[2], sb.r[5], sb.r[8])
    rv = pos1 - pos2
    bb = pdot(u1, u2)
    cc = pdot(u1, rv)
    ff = pdot(u2, rv)
    den = 1.0 - bb * bb
    s0 = torch.where(den > 1e-12,
                     (ff * bb - cc) / torch.where(den > 1e-12, den, 1.0), 0.0)
    s = _clip(s0, -l1, l1)
    t = _clip(s * bb + ff, -l2, l2)
    s = _clip(t * bb - cc, -l1, l1)
    dvec = (pos2 + pscale(u2, t)) - (pos1 + pscale(u1, s))
    dist = pnorm(dvec)
    inv = 1.0 / torch.clamp(dist, min=1e-20)
    zero = torch.zeros_like(dist)
    n_ss = pwhere(dist > 1e-12, pscale(dvec, inv),
                  P3(zero, zero, torch.ones_like(dist)))
    return r1 + r2 - dist, n_ss, dist - (r1 + r2)


def sphere_gap(sa: Shape, sb: Shape):
    """``closed_form_rows(sa, sb, tol).gap`` where every side-A row is a
    sphere, from the three branches a sphere can take: the swept pair (B a
    sphere or capsule), the point-box clamp and the point-cylinder clamp."""
    k2 = sb.kind
    _, _, g_ss = _swept_pair(sa, sb)
    _, _, g_sb = _sphere_vs_box(sa.pos, sa.p0, sb)
    _, _, g_sc = _sphere_vs_cyl(sa.pos, sa.p0, sb)
    is_ss2 = (k2 < 0.5) | ((k2 > 1.5) & (k2 < 2.5))
    return torch.where(is_ss2, g_ss, torch.where(k2 > 2.5, g_sc, g_sb))


def closed_form_rows(sa: Shape, sb: Shape, tol) -> ClosedForm:
    """Exact answers for the pair kinds with closed forms (K4): swept-sphere
    segment-segment for {sphere, capsule}^2, point-box clamp, point-solid
    cylinder clamp, box-box SAT.  Normal points A -> B."""
    k1, k2 = sa.kind, sb.kind
    r1, r2 = sa.p0, sb.p0
    is_ss1 = (k1 < 0.5) | ((k1 > 1.5) & (k1 < 2.5))
    is_ss2 = (k2 < 0.5) | ((k2 > 1.5) & (k2 < 2.5))
    both_swept = is_ss1 & is_ss2
    s_b = (k1 < 0.5) & (torch.abs(k2 - 1.0) < 0.5)
    b_s = (torch.abs(k1 - 1.0) < 0.5) & (k2 < 0.5)
    s_c = (k1 < 0.5) & (k2 > 2.5)
    c_s = (k1 > 2.5) & (k2 < 0.5)
    b_b = (torch.abs(k1 - 1.0) < 0.5) & (torch.abs(k2 - 1.0) < 0.5)
    final = both_swept | s_b | b_s | s_c | c_s | b_b
    pos1, pos2 = sa.pos, sb.pos
    depth_ss, n_ss, gap_ss = _swept_pair(sa, sb)
    zero = torch.zeros_like(depth_ss)

    d_sb, n_sb, g_sb = _sphere_vs_box(pos1, r1, sb)
    d_bs, n_bs, g_bs = _sphere_vs_box(pos2, r2, sa)
    n_bs = -n_bs
    d_sc, n_sc, g_sc = _sphere_vs_cyl(pos1, r1, sb)
    d_cs, n_cs, g_cs = _sphere_vs_cyl(pos2, r2, sa)
    n_cs = -n_cs
    d_bb, n_bb, g_bb = _box_box_sat(sa, sb)

    depth = torch.where(both_swept, depth_ss, torch.where(s_b, d_sb, d_bs))
    normal = pwhere(both_swept, n_ss, pwhere(s_b, n_sb, n_bs))
    gap = torch.where(both_swept, gap_ss, torch.where(s_b, g_sb, g_bs))
    depth = torch.where(s_c, d_sc, torch.where(c_s, d_cs, depth))
    normal = pwhere(s_c, n_sc, pwhere(c_s, n_cs, normal))
    gap = torch.where(s_c, g_sc, torch.where(c_s, g_cs, gap))
    depth = torch.where(b_b, d_bb, depth)
    normal = pwhere(b_b, n_bb, normal)
    gap = torch.where(b_b, g_bb, gap)
    hit = final & (depth > 0.0)
    depth = torch.where(hit, depth, 0.0)
    normal = pwhere(hit, normal, P3(zero, zero, zero))
    status = torch.where(hit, Status.HIT,
                         torch.where(gap > tol, Status.MISS_BROADPHASE,
                                     Status.MISS_GJK)).to(torch.int32)
    return ClosedForm(final, depth, normal, gap, status)
