"""Lane-vectorised geometry: the plain versions' building blocks.

Port of ``gjkepa_tpu/ops/fused.py:69-235``.  Every per-pair scalar is a
(B,) tensor and every 3-vector a :class:`P3` of three (B,) tensors, so the
code reads like scalar code while each op runs over the whole batch.  The
arithmetic keeps the JAX kernel's operation order (it decides the last
bit, and with it ties in the discrete verdicts); the CUDA device functions
in ``csrc/lane_geom.cuh`` keep the same order.

The TPU lowering workarounds of the original (lane-varying zeros, int32
boolean carries, block-level ``lax.cond`` skips) are gone: they changed
no per-lane result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the always-tetra face tables (ref :1093-1118, :1227-1229)
FACE_IDX = ((0, 2, 3), (0, 1, 3), (0, 1, 2), (1, 2, 3))


class P3(NamedTuple):
    """A batch of 3-vectors: three (B,) tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return P3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return P3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return P3(-self.x, -self.y, -self.z)


def pzero_like(t: torch.Tensor) -> P3:
    z = torch.zeros_like(t)
    return P3(z, z, z)


def pdot(a: P3, b: P3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def pcross(a: P3, b: P3) -> P3:
    return P3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def pscale(a: P3, s) -> P3:
    return P3(a.x * s, a.y * s, a.z * s)


def fsqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.

    PyTorch's vectorised CPU sqrt is not correctly rounded for float32
    (0.65% of random inputs differ by one ulp), while XLA's and the card's
    are; a float32 sqrt taken in float64 and rounded once is exact."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def pnorm(a: P3):
    return fsqrt(pdot(a, a))


def putz(a: P3, eps) -> P3:
    """utzvec: zero vector if norm < eps (ref :1343-1352)."""
    n = pnorm(a)
    small = n < eps
    s = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, n))
    return pscale(a, s)


def pwhere(m, a: P3, b: P3) -> P3:
    return P3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
              torch.where(m, a.z, b.z))


def pcoincide(a: P3, b: P3, eps):
    """ALL(|a-b| < eps): the reference's vertex-coincidence test."""
    return ((torch.abs(a.x - b.x) < eps) & (torch.abs(a.y - b.y) < eps)
            & (torch.abs(a.z - b.z) < eps))


def pmean4(s) -> P3:
    """Centroid of a 4-tuple of P3s, summed left to right."""
    return P3((s[0].x + s[1].x + s[2].x + s[3].x) * 0.25,
              (s[0].y + s[1].y + s[2].y + s[3].y) * 0.25,
              (s[0].z + s[1].z + s[2].z + s[3].z) * 0.25)


def uninml(a: P3, b: P3, c: P3, eps_zero) -> P3:
    """Plane unit normal; zero when degenerate, component-wise test
    matching UNINML (ref :1382-1394)."""
    cr = pcross(b - a, c - b)
    ok = ((torch.abs(cr.x) > eps_zero) | (torch.abs(cr.y) > eps_zero)
          | (torch.abs(cr.z) > eps_zero))
    n = pnorm(cr)
    s = torch.where(ok, 1.0 / torch.where(ok, n, 1.0), 0.0)
    return pscale(cr, s)


def dist_pf_sign(p: P3, a: P3, b: P3, c: P3, eps_zero):
    return pdot(p - a, uninml(a, b, c, eps_zero))


def _tri_edge_cross(ax, ay, bx, by, px, py):
    """z-component of (B-A) x (P-A) for one polygon edge."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def is_inside_tri(a: P3, b: P3, c: P3, p: P3, eps_zero):
    """IS_INSIDE_PF for a triangle (ref :1271-1337).

    XOY edge crosses, |c|<eps_zero clamped to 0, the all-nonpositive quirk
    falling through to the XOZ projection, sign-flip-vs-first-element test.
    """
    def crosses(ax_, ay_, bx_, by_, cx_, cy_, px_, py_):
        return (_tri_edge_cross(ax_, ay_, bx_, by_, px_, py_),
                _tri_edge_cross(bx_, by_, cx_, cy_, px_, py_),
                _tri_edge_cross(cx_, cy_, ax_, ay_, px_, py_))

    cx0, cx1, cx2 = crosses(a.x, a.y, b.x, b.y, c.x, c.y, p.x, p.y)
    cx0 = torch.where(torch.abs(cx0) < eps_zero, 0.0, cx0)
    cx1 = torch.where(torch.abs(cx1) < eps_zero, 0.0, cx1)
    cx2 = torch.where(torch.abs(cx2) < eps_zero, 0.0, cx2)
    use_xz = ~((cx0 > 1e-15) | (cx1 > 1e-15) | (cx2 > 1e-15))
    cz0, cz1, cz2 = crosses(a.x, a.z, b.x, b.z, c.x, c.z, p.x, p.z)
    c0 = torch.where(use_xz, cz0, cx0)
    c1 = torch.where(use_xz, cz1, cx1)
    c2 = torch.where(use_xz, cz2, cx2)
    outside = (c0 * c1 < 0.0) | (c0 * c2 < 0.0)
    return ~outside


def point_in_simplex(p: P3, s, eps_coincide, eps_zero):
    """isPointInSimplex (ref :1217-1265); `s` is a tuple of 4 P3 vertices.

    Strictly inside all four oriented face planes, or on a face plane and
    inside that face's triangle."""
    m = pmean4(s)
    all_pos = None
    on_face = None
    for i, (f0, f1, f2) in enumerate(FACE_IDX):
        a, b, c = s[f0], s[f1], s[f2]
        nml = putz(pcross(a - b, b - c), eps_zero)
        flip = pdot(nml, s[i] - m) < 0.0
        nml = pwhere(flip, -nml, nml)
        dist = pdot(s[i] - p, nml)
        onf = (torch.abs(dist) < eps_coincide) & is_inside_tri(a, b, c, p,
                                                               eps_zero)
        pos = dist > 0.0
        all_pos = pos if all_pos is None else (all_pos & pos)
        on_face = onf if on_face is None else (on_face | onf)
    return on_face | all_pos


def vec_pl(p: P3, a: P3, b: P3, eps_zero) -> P3:
    """VEC_PL (ref :1423-1440): unit vector from p to its foot on line ab."""
    ab = b - a
    n = pnorm(ab)
    safe = torch.where(n < eps_zero, 1.0, n)
    t = pdot(p - a, ab) / safe
    foot = a + pscale(ab, t / safe)
    return putz(foot - p, eps_zero)
