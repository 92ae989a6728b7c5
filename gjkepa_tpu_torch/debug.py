"""Debug / sanitizer mode: the queries under explicit numerics checks.

Port of ``gjkepa_tpu/debug.py``.  Each ``checked_*`` function runs the
query it wraps, computes JAX's pre- and postconditions on the query's
device (finite inputs and outputs, non-negative depth and unit normal on
hit lanes, status codes inside the public enum, manifold points inside the
contact-plane slab), stacks them into one ``(n_checks, B)`` bool tensor and
reads it back with one copy: one host read beyond what the wrapped query
does.  On a violation it raises :class:`DebugCheckError` naming the first
failed check and its first 16 lanes; otherwise it returns the unchecked
query's result.

The checks and tolerances are JAX's, and so is their precedence, so that
the same bad input names the same check in both packages: the fused and
manifold checkers in the order of JAX's numeric prefixes (which the port
drops), :func:`checked_gjkepa_batch` in alphabetical order (``jax.jit``
returns its unprefixed dict sorted by key).  A NaN vertex in a float32
batch therefore fails the coordinate-range check first: the max of a NaN
is NaN, and NaN <= limit is false.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import gjkepa_batch
from .config import GJKEPAConfig
from .models.shapes import shape_support_world
from .ops.fused import fused_gjkepa_hulls, fused_gjkepa_shapes
from .ops.manifold import POLY_CAP, manifold_batch, manifold_shapes_batch
from .types import Status

__all__ = [
    "checked_gjkepa_batch",
    "checked_fused_gjkepa_hulls",
    "checked_fused_gjkepa_shapes",
    "checked_manifold_batch",
    "checked_manifold_shapes_batch",
    "DebugCheckError",
]


class DebugCheckError(ValueError):
    """A sanitizer check failed; message names the check and the lanes."""


def _finite(x: torch.Tensor) -> torch.Tensor:
    """(B,) bool: every entry of the lane finite."""
    f = torch.isfinite(x)
    return f.flatten(1).all(1) if f.ndim > 1 else f


def _raise_failed(checks: list[tuple[str, torch.Tensor]]) -> None:
    """Raise on the first check, in order, that fails on any lane.  The
    (n_checks, B) stack comes to the host in one copy."""
    ok = torch.stack([c for _, c in checks]).cpu().numpy()
    for (name, _), row in zip(checks, ok):
        if not row.all():
            lanes = np.nonzero(~row)[0]
            raise DebugCheckError(
                f"sanitizer check failed: {name} "
                f"(lanes {lanes[:16].tolist()}"
                f"{'…' if lanes.size > 16 else ''})")


def checked_gjkepa_batch(p1, p2, cfg: GJKEPAConfig | None = None):
    """:func:`gjkepa_batch` (the portable query; ``cfg`` defaults to the
    float64 ladder, ``GJKEPAConfig()``) under the numerics sanitizer.

    Raises :class:`DebugCheckError` if an input vertex is NaN/Inf, float32
    coordinates leave the ladder's range, an output is non-finite, or a
    hit lane has a negative depth or a non-unit normal; otherwise returns
    the unchecked query's :class:`CollisionResult`."""
    cfg = cfg if cfg is not None else GJKEPAConfig()
    res = gjkepa_batch(p1, p2, cfg=cfg)
    nrm2 = (res.normal * res.normal).sum(-1)
    if p1.dtype == torch.float32:
        # the supported coordinate range of a float32 ladder: rounding
        # noise (~1e-7 |x|) stays well below eps_coincide, whose scale is
        # eps_coincide / 1e-5 (GJKEPAConfig.for_f32)
        limit = 200.0 * (cfg.eps_coincide / 1e-5)
        in_range = ((p1.abs().amax((1, 2)) <= limit)
                    & (p2.abs().amax((1, 2)) <= limit))
    else:
        in_range = torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)
    _raise_failed([
        ("f32 coordinates exceed the tolerance ladder's supported range",
         in_range),
        ("negative penetration depth on a hit lane",
         ~res.hit | (res.depth >= 0.0)),
        ("non-finite contact point", _finite(res.contact_point)),
        ("non-finite depth", _finite(res.depth)),
        ("non-finite input vertex (NaN/Inf in p1 or p2)",
         _finite(p1) & _finite(p2)),
        ("non-finite nearest points", _finite(res.nearest_points)),
        ("non-finite normal", _finite(res.normal)),
        ("non-unit contact normal on a hit lane",
         ~res.hit | ((nrm2 - 1.0).abs() < 1e-3)),
    ])
    return res


def _fused_result_checks(res) -> list[tuple[str, torch.Tensor]]:
    """Postconditions of every fused query: finite outputs, non-negative
    depth and unit normal on hit lanes, non-negative miss distance, and
    status codes inside the public enum (the internal HIT_EPA_CAPACITY
    never leaves a dispatch)."""
    hit = res.hit
    nrm2 = (res.normal * res.normal).sum(-1)
    return [
        ("non-finite depth", _finite(res.depth)),
        ("non-finite normal", _finite(res.normal)),
        ("non-finite distance", _finite(res.distance)),
        ("negative penetration depth on a hit lane",
         ~hit | (res.depth >= 0.0)),
        ("non-unit contact normal on a hit lane",
         ~(hit & (res.status == Status.HIT)) | ((nrm2 - 1.0).abs() < 1e-3)),
        ("negative miss distance", hit | (res.distance >= -1e-6)),
        ("status code outside the public enum (internal code escaped)",
         (res.status >= Status.MISS_BROADPHASE)
         & (res.status <= Status.HIT_EPA_DEGENERATE)),
        ("hit flag inconsistent with status",
         hit == (res.status >= Status.HIT)),
    ]


def checked_fused_gjkepa_hulls(p1, p2, cfg: GJKEPAConfig | None = None):
    """:func:`fused_gjkepa_hulls` (K1, then K2 over the hits; ``cfg``
    defaults to :meth:`GJKEPAConfig.for_f32`) under the numerics
    sanitizer."""
    cfg = cfg if cfg is not None else GJKEPAConfig.for_f32()
    res = fused_gjkepa_hulls(p1, p2, cfg=cfg)
    _raise_failed([("non-finite input vertex (NaN/Inf in p1 or p2)",
                    _finite(p1) & _finite(p2))]
                  + _fused_result_checks(res))
    return res


def checked_fused_gjkepa_shapes(a, b, cfg: GJKEPAConfig | None = None):
    """:func:`fused_gjkepa_shapes` (K5, K6a, K7; ``cfg`` defaults to
    :meth:`GJKEPAConfig.for_f32`) under the numerics sanitizer."""
    cfg = cfg if cfg is not None else GJKEPAConfig.for_f32()
    res = fused_gjkepa_shapes(a, b, cfg=cfg)
    params_ok = (_finite(a.params) & _finite(a.pos) & _finite(a.rot)
                 & _finite(b.params) & _finite(b.pos) & _finite(b.rot))
    _raise_failed([("non-finite shape parameter (NaN/Inf in params/pos/rot)",
                    params_ok)]
                  + _fused_result_checks(res))
    return res


def _manifold_checks(m, normal, hit, s_a, s_b, tol):
    """The manifold's checks, given each side's support value along the
    normal: every valid point must lie (along the normal) between B's
    lowest and A's highest support, widened by the clustering tolerance,
    within which the clipped support polygons lie by construction (the
    reference's 0.1 support-set rule, ref :471-529)."""
    z = (m.points * normal[:, None, :]).sum(-1)                  # (B, 4)
    slack = tol + 1e-3
    in_slab = ((z >= (torch.minimum(s_b, s_a) - slack)[:, None])
               & (z <= (torch.maximum(s_a, s_b) + slack)[:, None]))
    return [
        ("non-finite manifold point", _finite(m.points)),
        ("non-finite manifold depth", _finite(m.depths)),
        ("negative manifold point depth",
         (~m.mask | (m.depths >= 0.0)).all(1)),
        ("manifold point on a miss lane", hit | ~m.mask.any(1)),
        ("manifold point off the contact plane slab",
         (~(m.mask & hit[:, None]) | in_slab).all(1)),
    ]


def _tol(cfg: GJKEPAConfig | None, tol: float | None):
    cfg = cfg if cfg is not None else GJKEPAConfig.for_f32()
    return cfg, (cfg.support_set_tol if tol is None else tol)


def checked_manifold_batch(p1, p2, normal, depth, hit, contact_point,
                           mask1=None, mask2=None,
                           cfg: GJKEPAConfig | None = None,
                           tol: float | None = None,
                           poly_cap: int = POLY_CAP):
    """:func:`manifold_batch` (same arguments) under the numerics
    sanitizer: finite outputs, per-point depth >= 0, no manifold points on
    miss lanes, and every valid point inside the contact-plane slab spanned
    by the two support planes along the normal."""
    cfg, tol = _tol(cfg, tol)
    m = manifold_batch(p1, p2, normal, depth, hit, contact_point, mask1,
                       mask2, cfg=cfg, tol=tol, poly_cap=poly_cap)
    z1 = (p1 * normal[:, None, :]).sum(-1)                       # (B, N1)
    z2 = (p2 * normal[:, None, :]).sum(-1)
    if mask1 is not None:
        z1 = torch.where(mask1, z1, -torch.inf)
    if mask2 is not None:
        z2 = torch.where(mask2, z2, torch.inf)
    _raise_failed(_manifold_checks(m, normal, hit, z1.amax(1), z2.amin(1),
                                   tol))
    return m


def checked_manifold_shapes_batch(a, b, normal, depth, hit, contact_point,
                                  cfg: GJKEPAConfig | None = None,
                                  tol: float | None = None,
                                  poly_cap: int = POLY_CAP):
    """:func:`manifold_shapes_batch` (same arguments) under the numerics
    sanitizer (see :func:`checked_manifold_batch`); each side's support
    along the normal comes from the closed-form support maps."""
    cfg, tol = _tol(cfg, tol)
    m = manifold_shapes_batch(a, b, normal, depth, hit, contact_point,
                              cfg=cfg, tol=tol, poly_cap=poly_cap)
    s_a = (shape_support_world(a.kind, a.params, a.pos, a.rot, normal)
           * normal).sum(-1)
    s_b = (shape_support_world(b.kind, b.params, b.pos, b.rot, -normal)
           * normal).sum(-1)
    _raise_failed(_manifold_checks(m, normal, hit, s_a, s_b, tol))
    return m
