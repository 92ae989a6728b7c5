"""Pure 3-D geometry primitives of the portable path (M1-M12).

Port of ``gjkepa_tpu/ops/geom.py:37-268``: the reference's private math
tools (``GCLIB_GJKEPA.f90:1193-1689``) as functions on ``(..., 3)`` tensors
with any leading batch dimensions, where the JAX package writes one query
and vmaps it.  Each keeps the JAX function's operations in its order
(divisions stay divisions), so the two round alike; where the reference
halts on degenerate input, the result is a well-defined zero.

The fused paths' plain versions keep their own lane form
(:mod:`.lane_geom`, the P3 lanes of the kernels); the two share
:func:`.lane_geom.fsqrt`, a correctly rounded square root.
"""

from __future__ import annotations

import math

import torch

from .lane_geom import fsqrt

__all__ = ["cross3", "counting_argsort", "utzvec", "uninml", "dist_pf_sign",
           "vec_pl", "foot_pl", "foot_ll", "is_inside_pf", "point_in_simplex",
           "overlap", "sort_clock_indices", "SIMPLEX_FACES", "norm3", "dot3"]

# Face index table of the always-4-vertex simplex (ref idFc, :1227-1229):
# vertex i lies on face i, which the reference uses for orientation.
SIMPLEX_FACES = ((0, 2, 3), (0, 1, 3), (0, 1, 2), (1, 2, 3))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over the last axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(v: torch.Tensor) -> torch.Tensor:
    return fsqrt(dot3(v, v))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-D cross product (CROSS_PRODUCT_3D, ref :1201-1212)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def utzvec(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Safe normalize: zero vector if ||v|| < eps (UTZVEC, ref :1343-1352)."""
    n = norm3(v)[..., None]
    small = n < eps
    return torch.where(small, 0.0, v / torch.where(small, 1.0, n))


def uninml(tri: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit normal of the plane through the 3 points of ``tri`` (..., 3, 3)
    (UNINML, ref :1382-1394); zero when the cross product has no component
    above ``eps`` (the reference's component-wise test)."""
    c = cross3(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 1, :])
    ok = (torch.abs(c) > eps).any(-1, keepdim=True)
    return torch.where(ok, c / torch.where(ok, norm3(c)[..., None], 1.0), 0.0)


def dist_pf_sign(point: torch.Tensor, tri: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Signed point-plane distance (DIST_PF_SIGN, ref :1357-1377); a
    degenerate plane gives 0 where the reference STOPs."""
    return dot3(point - tri[..., 0, :], uninml(tri, eps))


def vec_pl(point: torch.Tensor, line: torch.Tensor,
           eps: float = 1e-12) -> torch.Tensor:
    """Unit vector from ``point`` toward its foot on ``line`` (..., 2, 3)
    (VEC_PL, ref :1423-1440): UTZVEC(foot - point)."""
    a, b = line[..., 0, :], line[..., 1, :]
    ab = b - a
    ac = point - a
    nrm = norm3(ab)
    safe = torch.where(nrm < eps, 1.0, nrm)
    foot = a + (dot3(ac, ab) / safe)[..., None] * (ab / safe[..., None])
    return utzvec(foot - point, eps)


def foot_pl(point: torch.Tensor, line: torch.Tensor,
            eps: float = 1e-12) -> torch.Tensor:
    """Foot of the perpendicular from point to line (FOOT_PL, ref
    :1492-1505)."""
    u = utzvec(line[..., 1, :] - line[..., 0, :], eps)
    return line[..., 0, :] + dot3(point - line[..., 0, :], u)[..., None] * u


def foot_ll(line1: torch.Tensor, line2: torch.Tensor,
            eps: float = 1e-12) -> torch.Tensor:
    """Closest points between two 3-D lines (FOOT_LL, ref :1446-1487):
    (..., 2, 3), one point on each line.  Parallel lines give the midpoint
    of line1 and its foot on line2 (:1474-1476)."""
    p1, q1 = line1[..., 0, :], line1[..., 1, :]
    p2, q2 = line2[..., 0, :], line2[..., 1, :]
    d1, d2 = q1 - p1, q2 - p2
    r = p1 - p2
    a = dot3(d1, d1)
    b = dot3(d1, d2)
    c = dot3(d1, r)
    e = dot3(d2, d2)
    f = dot3(d2, r)
    d = a * e - b * b
    parallel = torch.abs(d) < eps
    safe_d = torch.where(parallel, 1.0, d)
    s = (b * f - c * e) / safe_d
    t = (a * f - b * c) / safe_d
    skew = torch.stack([p1 + s[..., None] * d1, p2 + t[..., None] * d2], -2)
    mid1 = (p1 + q1) * 0.5
    par = torch.stack([mid1, foot_pl(mid1, line2, eps)], -2)
    return torch.where(parallel[..., None, None], par, skew)


def _polygon_crosses(xs, ys, px, py, valid, n_valid):
    """Cyclic edge crosses of a front-compacted planar polygon projection
    ((..., K) coordinates, the last valid vertex wrapping to vertex 0)."""
    k = xs.shape[-1]
    idx = torch.arange(k, device=xs.device)
    nxt = torch.where(idx + 1 >= n_valid[..., None], 0, idx + 1)
    xs_n = torch.gather(xs, -1, nxt.expand(xs.shape))
    ys_n = torch.gather(ys, -1, nxt.expand(ys.shape))
    c = (xs_n - xs) * (py[..., None] - ys) - (ys_n - ys) * (px[..., None] - xs)
    return torch.where(valid, c, 0.0)


def is_inside_pf(verts: torch.Tensor, point: torch.Tensor, n_valid=None,
                 eps_zero: float = 1e-12) -> torch.Tensor:
    """Point-in-planar-polygon test (IS_INSIDE_PF, ref :1271-1337).

    ``verts`` (..., K, 3) holds the polygon in order in its first
    ``n_valid`` rows (an int or a (...) tensor); the rest is padding.  The
    reference's semantics: crosses on the XOY projection, |c| < eps_zero
    clamped to 0; if no cross exceeds 1e-15 (the all-negative case too)
    the XOZ projection decides; outside iff a cross has the strictly
    opposite sign of the first vertex's."""
    k = verts.shape[-2]
    lead = verts.shape[:-2]
    if n_valid is None:
        n_valid = k
    n_valid = torch.as_tensor(n_valid, device=verts.device).expand(lead)
    valid = torch.arange(k, device=verts.device) < n_valid[..., None]
    x, y, z = verts[..., 0], verts[..., 1], verts[..., 2]
    cxy = _polygon_crosses(x, y, point[..., 0], point[..., 1], valid, n_valid)
    cxy = torch.where(torch.abs(cxy) < eps_zero, 0.0, cxy)
    use_xz = ~(cxy > 1e-15).any(-1, keepdim=True)
    cxz = _polygon_crosses(x, z, point[..., 0], point[..., 2], valid, n_valid)
    c = torch.where(use_xz, cxz, cxy)
    flips = (c[..., :1] * c) < 0.0
    return ~(flips & valid).any(-1)


def point_in_simplex(p: torch.Tensor, simplex: torch.Tensor,
                     eps_coincide: float = 1e-8,
                     eps_zero: float = 1e-12) -> torch.Tensor:
    """Point-in-tetrahedron with the on-face fallback (isPointInSimplex,
    ref :1217-1265): inside all four face planes, oriented against the
    centroid, or on a face plane (|dist| < eps_coincide) and inside that
    face's triangle.  ``simplex`` is (..., 4, 3)."""
    s = [simplex[..., i, :] for i in range(4)]
    m = (((s[0] + s[1]) + s[2]) + s[3]) / 4.0
    all_pos, on_face = None, None
    for i, (f0, f1, f2) in enumerate(SIMPLEX_FACES):
        a, b, c = s[f0], s[f1], s[f2]
        nml = utzvec(cross3(a - b, b - c), eps_zero)
        nml = torch.where((dot3(nml, s[i] - m) < 0.0)[..., None], -nml, nml)
        dist = dot3(s[i] - p, nml)
        inside2d = is_inside_pf(torch.stack([a, b, c], -2), p,
                                eps_zero=eps_zero)
        onf = (torch.abs(dist) < eps_coincide) & inside2d
        pos = dist > 0.0
        all_pos = pos if all_pos is None else all_pos & pos
        on_face = onf if on_face is None else on_face | onf
    return on_face | all_pos


def overlap(points: torch.Tensor, valid: torch.Tensor | None = None,
            eps: float = 1e-12) -> torch.Tensor:
    """True iff all (valid) points of (..., K, 3) coincide within eps
    (OVERLAP, ref :1399-1418)."""
    diff = torch.abs(points - points[..., :1, :]) > eps
    if valid is not None:
        diff = diff & valid[..., None]
    return ~diff.any(-1).any(-1)


def counting_argsort(x: torch.Tensor) -> torch.Tensor:
    """Stable argsort along the last axis (the JAX package counts ranks,
    a TPU workaround; the permutation is the same)."""
    return torch.argsort(x, dim=-1, stable=True)


def sort_clock_indices(points: torch.Tensor, n_valid) -> torch.Tensor:
    """Counter-clockwise order of front-compacted coplanar points (SORT_CLOCK,
    ref :1513-1575) as a permutation of the last-but-one axis: the CCW
    angle from point 0 around the centroid, point 0 first, padding last,
    input order when all valid points coincide (:1521)."""
    k = points.shape[-2]
    lead = points.shape[:-2]
    dev = points.device
    n_valid = torch.as_tensor(n_valid, device=dev).expand(lead)
    valid = torch.arange(k, device=dev) < n_valid[..., None]
    nf = torch.clamp(n_valid, min=1).to(points.dtype)
    centroid = (torch.where(valid[..., None], points, 0.0).sum(-2)
                / nf[..., None])
    normal = cross3(points[..., 1, :] - points[..., 0, :],
                    points[..., 2, :] - points[..., 0, :])
    v0 = points[..., 0, :] - centroid
    v = points - centroid[..., None, :]
    w = cross3(normal, v0)
    y = dot3(v, w[..., None, :])
    x = dot3(v, v0[..., None, :])
    two_pi = 2.0 * math.pi
    ang = torch.remainder(torch.atan2(y, x) + two_pi, two_pi)
    ang = torch.cat([torch.full_like(ang[..., :1], -1.0), ang[..., 1:]], -1)
    ang = torch.where(valid, ang, math.inf)
    order = counting_argsort(ang)
    same = overlap(points, valid)
    ident = torch.arange(k, device=dev).expand(order.shape)
    return torch.where(same[..., None], ident, order)
