"""Bounding-sphere broadphase of the portable path.

Port of ``gjkepa_tpu/ops/broadphase.py:26-39``: the reference's only
broadphase, a centroid and max-radius bounding sphere per hull with a
fixed inflation (RoughCollisionDetection_SphericalEnvelope,
``GCLIB_GJKEPA.f90:1165-1188``), over (B, N, 3) hulls with optional
(B, N) masks.  The sim's candidate-pair generators
(``grid_candidate_pairs``, ``swept_candidate_pairs``) come with the sim.
"""

from __future__ import annotations

import torch

from .geom import norm3

__all__ = ["bounding_spheres", "sphere_envelope_overlap"]


def _masked_mean(p, mask):
    if mask is None:
        return p.mean(1)
    cnt = torch.clamp(mask.sum(1), min=1).to(p.dtype)
    return torch.where(mask[..., None], p, 0.0).sum(1) / cnt[:, None]


def bounding_spheres(p, mask=None):
    """Centroid (B, 3) and max radius (B,) of each vertex cloud (ref
    :1174-1182)."""
    c = _masked_mean(p, mask)
    d = norm3(p - c[:, None])
    if mask is not None:
        d = torch.where(mask, d, 0.0)
    return c, d.amax(1)


def sphere_envelope_overlap(p1, p2, mask1=None, mask2=None,
                            tol: float = 1.0):
    """(B,) bool: False where ||c1 - c2|| > r1 + r2 + tol (ref :1172,
    :1185)."""
    c1, r1 = bounding_spheres(p1, mask1)
    c2, r2 = bounding_spheres(p2, mask2)
    return norm3(c1 - c2) <= r1 + r2 + tol
