"""Public query API of the port: the portable and fused queries.

Port of ``gjkepa_tpu/api.py:350-411``: :func:`gjkepa_batch_fused` runs the
two hull kernels (K1 GJK, K2 EPA cascade) and derives the reference's
contact outputs (nearest points, contact point, type) with
:func:`derive_contact_batch`: the complete GJKEPA contract of the
reference's one entry point (``SUBROUTINE GJKEPA``, GCLIB_GJKEPA.f90:39-239)
over a batch of pairs.  :func:`collide_shapes_batch_fused`
(``api.py:270-300``) is its twin over analytic shape pairs: the shape
kernels (K5-K7) and the closed-form support-set case trees.
:func:`gjk_distance_batch` and :func:`gjk_distance_shapes_batch`
(``api.py:303-347``) are the portable closest-distance queries: torch code
over the hull or shape support (``ops.distance``), in float32 or float64.

The portable path (``api.py:41-267, :415-452``) is the reference's query
in the JAX package's portable form, torch code over the support maps
(``ops.gjk``, ``ops.epa``, ``ops.contact``), in float32 or float64:
:func:`gjkepa` (one pair) and :func:`gjkepa_batch` over hull pairs with
the contact versions 1-3 (:func:`derive_contact`), :func:`collide_supports`
over any support map with the depth polish, and its shape and
hull-vs-shape forms :func:`collide_shapes_batch` and
:func:`collide_hull_shape_batch`.  It differs from the fused path where the
JAX package's does: all 99 init retries, the EPA mechanism, the float64
caps.

Layouts are the JAX package's: (B, N, 3) float32 vertices, optional (B, N)
bool masks, and a :class:`CollisionResult` with its field names, shapes and
dtypes.  Everything runs on the device the inputs are on; inputs on
different devices raise rather than move.
"""

from __future__ import annotations

from typing import Callable

import torch

from .config import DEFAULT_CONFIG, GJKEPAConfig
from .models.shapes import (SPHERE, ShapeBatch, make_shape_pair_support,
                            shape_support_world)
from .ops import broadphase, contact
from .ops.contact_rows import derive_contact_rows
from .ops.contact_shapes import derive_contact_shapes_batch
from .ops.distance import DistanceResult, gjk_distance
from .ops.epa import polish_support_descent, run_epa
from .ops.fused import FusedResult, fused_gjkepa_hulls, fused_gjkepa_shapes
from .ops.geom import norm3
from .ops.gjk import run_gjk
from .ops.support import SupportResult, hull_support_point, make_hull_support
from .spans import span, spanned
from .types import CollisionResult, Status

__all__ = ["gjkepa", "gjkepa_batch", "derive_contact", "collide_supports",
           "collide_shapes_batch", "collide_hull_shape_batch",
           "gjkepa_batch_fused", "derive_contact_batch",
           "collide_shapes_batch_fused", "gjk_distance_batch",
           "gjk_distance_shapes_batch"]


def _same_device(ref: torch.Tensor, ref_name: str = "p1", **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on "
                             f"{ref.device}")


# -- the portable path ---------------------------------------------------------

def derive_contact(p1, p2, epa_normal, cfg: GJKEPAConfig, mask1=None,
                   mask2=None):
    """Contact post-processing from the EPA normal (version dispatch, ref
    :329-343) over (B, N, 3) hulls: nearest points (B, 2, 3), contact point
    (B, 3), the (possibly rewritten) normal (B, 3) and contact type (B,)."""
    npts = contact.nearest_points(p1, p2, epa_normal, mask1, mask2)
    if cfg.version == 1:
        cpoint = contact.collision_point_v1(p1, p2, epa_normal, cfg, mask1,
                                            mask2)
        normal = epa_normal
    elif cfg.version == 2:
        cpoint = contact.collision_point_v2(p1, p2, epa_normal, cfg, mask1,
                                            mask2)
        normal = epa_normal
    elif cfg.version == 3:
        cpoint, normal = contact.collision_point_v3(p1, p2, epa_normal, cfg,
                                                    mask1, mask2)
    else:
        raise ValueError(f"unknown contact-point version {cfg.version!r} "
                         "(reference supports 1, 2, 3; ref :329-340)")
    ctype = contact.collision_type(p1, p2, normal, cfg.face_contact_tol,
                                   mask1, mask2)
    return npts, cpoint, normal, ctype


def _zeroed(hit, npts, normal, cpoint, depth, ctype, distance, status,
            gjk_iters, epa_iters) -> CollisionResult:
    """The result with its contact fields zeroed on misses (ref :65-71)."""
    return CollisionResult(
        hit=hit,
        colli_type=torch.where(hit, ctype, 0).to(torch.int32),
        nearest_points=torch.where(hit[:, None, None], npts, 0.0),
        normal=torch.where(hit[:, None], normal, 0.0),
        contact_point=torch.where(hit[:, None], cpoint, 0.0),
        depth=torch.where(hit, depth, 0.0),
        distance=distance,
        status=status.to(torch.int32),
        gjk_iters=gjk_iters,
        epa_iters=epa_iters)


def _chunks(b: int, chunk_size: int | None):
    """Slices of ``chunk_size`` pairs over a batch of b (all of it when
    None); one empty slice at b = 0, so that the result has its fields at
    batch size 0."""
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    step = max(b, 1) if chunk_size is None else chunk_size
    return [slice(i, min(i + step, b)) for i in range(0, max(b, 1), step)]


def _cat(results):
    """The chunks' results (at least one, of one NamedTuple type) joined
    along the batch axis."""
    return type(results[0])(*(torch.cat(f) for f in zip(*results)))


def _gjkepa_rows(p1, p2, mask1, mask2, cfg, use_broadphase):
    support = make_hull_support(p1, p2, mask1, mask2)
    if use_broadphase:
        active = broadphase.sphere_envelope_overlap(p1, p2, mask1, mask2,
                                                    cfg.broadphase_tol)
    else:
        active = torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)
    g = run_gjk(support, cfg, active, dtype=p1.dtype)
    e = run_epa(support, g.simplex, g.hit, cfg)
    npts, cpoint, normal, ctype = derive_contact(p1, p2, e.normal, cfg,
                                                 mask1, mask2)
    return _zeroed(g.hit, npts, normal, cpoint, e.depth, ctype, g.sep_lb,
                   torch.where(g.hit, e.status, g.status), g.iters, e.iters)


def gjkepa_batch(p1: torch.Tensor, p2: torch.Tensor,
                 mask1: torch.Tensor | None = None,
                 mask2: torch.Tensor | None = None,
                 cfg: GJKEPAConfig = DEFAULT_CONFIG,
                 use_broadphase: bool = True,
                 chunk_size: int | None = None) -> CollisionResult:
    """Full narrow-phase query over (B, N, 3) hull pairs, the portable path:
    broadphase, GJK with all init retries, EPA, contact (``cfg.version``),
    in the hulls' dtype (float64 with the default config, float32 with
    :meth:`GJKEPAConfig.for_f32`).  Optional (B, N) bool masks drop padded
    vertices.  ``chunk_size`` runs the batch in chunks of that many pairs,
    which bounds the EPA polytope buffers (B x F x 3)."""
    _same_device(p1, p2=p2, mask1=mask1, mask2=mask2)
    return _cat([_gjkepa_rows(p1[c], p2[c],
                              None if mask1 is None else mask1[c],
                              None if mask2 is None else mask2[c], cfg,
                              use_broadphase)
                 for c in _chunks(p1.shape[0], chunk_size)])


def gjkepa(p1: torch.Tensor, p2: torch.Tensor,
           mask1: torch.Tensor | None = None,
           mask2: torch.Tensor | None = None,
           cfg: GJKEPAConfig = DEFAULT_CONFIG,
           use_broadphase: bool = True) -> CollisionResult:
    """The query for one pair: (N1, 3) / (N2, 3) vertex buffers, optional
    (N,) masks; a batch of one through :func:`gjkepa_batch`, every field
    without its batch axis."""
    r = gjkepa_batch(p1[None], p2[None],
                     None if mask1 is None else mask1[None],
                     None if mask2 is None else mask2[None], cfg,
                     use_broadphase)
    return CollisionResult(*(t[0] for t in r))


def collide_supports(support: Callable, cfg: GJKEPAConfig = DEFAULT_CONFIG,
                     dtype: torch.dtype = torch.float32,
                     active: torch.Tensor | bool = True,
                     hint: torch.Tensor | None = None,
                     device: torch.device | str = "cuda") -> CollisionResult:
    """The query over any Minkowski support map: ``support(d)`` takes (B, 3)
    directions (or one (1, 3) direction, which it broadcasts) and returns a
    :class:`SupportResult` of (B, 3) tensors.

    GJK, EPA, then the support-function descent polish of the depth
    (exact supports); ``hint`` (B, 3), typically the centre-to-centre
    direction, starts a second descent and the better wins.  The contact
    point is the midpoint of the witnesses along the normal, contact type 1
    on a hit.  ``active`` is a (B,) bool tensor, which names the lanes and
    the device, or a Python bool for every lane, as in the JAX package;
    then a first probe, a (1, 3) direction on ``device`` (the card unless
    the caller names another), gives the batch size."""
    if isinstance(active, bool):
        r0 = support(torch.tensor([[1.0, 0.0, 0.0]], dtype=dtype,
                                  device=device))
        active = torch.full((r0.w.shape[0],), active, dtype=torch.bool,
                            device=r0.w.device)
    g = run_gjk(support, cfg, active, dtype=dtype)
    e = run_epa(support, g.simplex, g.hit, cfg)
    depth, normal = polish_support_descent(support, e.depth, e.normal, g.hit)
    if hint is not None:
        hnorm = norm3(hint)
        hunit = hint / torch.clamp(hnorm, min=1e-20)[:, None]
        d2, n2 = polish_support_descent(support, depth, hunit,
                                        g.hit & (hnorm > 1e-9))
        better = g.hit & (d2 < depth)
        depth = torch.where(better, d2, depth)
        normal = torch.where(better[:, None], n2, normal)
    ok = g.hit & (norm3(normal) > 0.5)
    status = torch.where(ok, Status.HIT, e.status)
    s = support(normal)
    return _zeroed(g.hit, torch.stack([s.a, s.b], 1), normal,
                   0.5 * (s.a + s.b), depth,
                   torch.ones_like(g.status), g.sep_lb,
                   torch.where(g.hit, status, g.status), g.iters, e.iters)


def _shape_rows(a: ShapeBatch, b: ShapeBatch, cfg) -> CollisionResult:
    res = collide_supports(make_shape_pair_support(a, b), cfg,
                           a.params.dtype,
                           torch.ones(len(a), dtype=torch.bool,
                                      device=a.kind.device),
                           hint=b.pos - a.pos)
    # sphere-sphere pairs: the exact depth and normal (EPA's polyhedral
    # answer carries ~1e-4 R on smooth shapes); concentric spheres keep EPA's
    both = (a.kind == SPHERE) & (b.kind == SPHERE)
    delta = b.pos - a.pos
    dist = norm3(delta)
    n_exact = delta / torch.clamp(dist, min=1e-20)[:, None]
    depth_exact = a.params[:, 0] + b.params[:, 0] - dist
    exact = both & (depth_exact > 0.0) & res.hit & (dist > 1e-9)
    depth = torch.where(exact, depth_exact, res.depth)
    normal = torch.where(exact[:, None], n_exact, res.normal)
    npts, cpoint, normal, ctype = derive_contact_shapes_batch(a, b, normal,
                                                              cfg)
    return _zeroed(res.hit, npts, normal, cpoint, depth, ctype, res.distance,
                   res.status, res.gjk_iters, res.epa_iters)


def collide_shapes_batch(a: ShapeBatch, b: ShapeBatch,
                         cfg: GJKEPAConfig = DEFAULT_CONFIG,
                         chunk_size: int | None = None) -> CollisionResult:
    """The portable query over analytic shape pairs (pair i is (a[i], b[i]))
    in the dtype of ``a.params``: :func:`collide_supports` with the
    centre-to-centre hint, exact sphere-sphere depths, and the full contact
    contract from the closed-form support sets (``ops.contact_shapes``)."""
    _same_device(a.kind, "a.kind",
                 **{f"{s}.{f}": t for s, x in (("a", a), ("b", b))
                    for f, t in zip(x._fields, x)})
    return _cat([_shape_rows(ShapeBatch(*(t[c] for t in a)),
                             ShapeBatch(*(t[c] for t in b)), cfg)
                 for c in _chunks(len(a), chunk_size)])


def _hull_shape_rows(p1, mask1, shapes: ShapeBatch, cfg) -> CollisionResult:
    def support(d):
        a = hull_support_point(p1, d, mask1)
        b = shape_support_world(shapes.kind, shapes.params, shapes.pos,
                                shapes.rot, -d)
        return SupportResult(a - b, a, b)

    centroid = broadphase.bounding_spheres(p1, mask1)[0]
    return collide_supports(support, cfg, p1.dtype,
                            torch.ones(p1.shape[0], dtype=torch.bool,
                                       device=p1.device),
                            hint=shapes.pos - centroid)


def collide_hull_shape_batch(p1: torch.Tensor, shapes: ShapeBatch,
                             mask1: torch.Tensor | None = None,
                             cfg: GJKEPAConfig = DEFAULT_CONFIG,
                             chunk_size: int | None = None
                             ) -> CollisionResult:
    """The portable query of (B, N, 3) hulls (side A, optional (B, N)
    masks) against analytic shapes (side B): :func:`collide_supports`
    hinted along the shape's position minus the hull's centroid."""
    _same_device(p1, mask1=mask1,
                 **{f"shapes.{f}": t for f, t in zip(shapes._fields, shapes)})
    return _cat([_hull_shape_rows(p1[c], None if mask1 is None else mask1[c],
                                  ShapeBatch(*(t[c] for t in shapes)), cfg)
                 for c in _chunks(p1.shape[0], chunk_size)])


# -- the fused path -------------------------------------------------------------

@spanned("gjkepa.gjkepa_batch_fused")
def gjkepa_batch_fused(p1: torch.Tensor, p2: torch.Tensor,
                       mask1: torch.Tensor | None = None,
                       mask2: torch.Tensor | None = None,
                       cfg: GJKEPAConfig | None = None) -> CollisionResult:
    """Full-surface batch query over hull pairs (float32, any B >= 1).

    Ragged hulls via (B, N) masks or repeated-vertex padding (equivalent).
    On CUDA tensors this launches the hull kernels; on CPU tensors it runs
    their plain PyTorch versions."""
    _same_device(p1, p2=p2, mask1=mask1, mask2=mask2)
    if cfg is None:
        cfg = GJKEPAConfig.for_f32()
    r = fused_gjkepa_hulls(p1, p2, mask1, mask2, cfg=cfg)
    return derive_contact_batch(p1, p2, r, cfg, mask1, mask2)


def derive_contact_batch(p1: torch.Tensor, p2: torch.Tensor, r: FusedResult,
                         cfg: GJKEPAConfig, mask1=None, mask2=None
                         ) -> CollisionResult:
    """Contact post-processing of a :class:`FusedResult` batch.

    A per-pair map: nearest points, contact point and contact type from the
    EPA normal (version dispatch, ref :329-343), zeroed on misses as the
    reference does (:65-71)."""
    _same_device(p1, p2=p2, mask1=mask1, mask2=mask2, normal=r.normal)
    if mask1 is not None and mask1.ndim == 1:
        mask1 = mask1[None, :].expand(p1.shape[0], -1)
    if mask2 is not None and mask2.ndim == 1:
        mask2 = mask2[None, :].expand(p2.shape[0], -1)
    with span("gjkepa.contact_rows"):
        npts, cpoint, normal, ctype = derive_contact_rows(p1, p2, r.normal,
                                                          cfg, mask1, mask2)
    return _zeroed(r.hit, npts, normal, cpoint, r.depth, ctype, r.distance,
                   r.status, r.gjk_iters, r.epa_iters)


def collide_shapes_batch_fused(a: ShapeBatch, b: ShapeBatch,
                               cfg: GJKEPAConfig | None = None
                               ) -> CollisionResult:
    """Full-contract batch query over analytic shape pairs: the fused shape
    query answers hit/depth/normal/distance, then the closed-form support
    sets give nearest points, contact point and contact type (ref :47-52,
    :329-343).  On CUDA tensors this launches the shape kernels; on CPU
    tensors it runs their plain PyTorch versions."""
    if cfg is None:
        cfg = GJKEPAConfig.for_f32()
    r = fused_gjkepa_shapes(a, b, cfg=cfg)
    npts, cpoint, normal, ctype = derive_contact_shapes_batch(a, b, r.normal,
                                                              cfg)
    return _zeroed(r.hit, npts, normal, cpoint, r.depth, ctype, r.distance,
                   r.status, r.gjk_iters, r.epa_iters)


def _distance_rows(support, n: int, cfg, dtype, dev) -> DistanceResult:
    active = torch.ones(n, dtype=torch.bool, device=dev)
    return gjk_distance(support, cfg, dtype=dtype, active=active)


def gjk_distance_batch(p1: torch.Tensor, p2: torch.Tensor,
                       mask1: torch.Tensor | None = None,
                       mask2: torch.Tensor | None = None,
                       cfg: GJKEPAConfig = DEFAULT_CONFIG,
                       chunk_size: int | None = None) -> DistanceResult:
    """Closest distance and witness points over (B, N, 3) hull pairs, 0 for
    intersecting pairs, in the hulls' dtype (float32 or float64); optional
    (B, N) bool masks drop padded vertices.  ``chunk_size`` runs the batch
    in chunks of that many pairs, which bounds the working memory; every
    pair is independent, so the result is the same."""
    _same_device(p1, p2=p2, mask1=mask1, mask2=mask2)
    return _cat([
        _distance_rows(make_hull_support(
            p1[c], p2[c], None if mask1 is None else mask1[c],
            None if mask2 is None else mask2[c]),
            p1[c].shape[0], cfg, p1.dtype, p1.device)
        for c in _chunks(p1.shape[0], chunk_size)])


def gjk_distance_shapes_batch(a: ShapeBatch, b: ShapeBatch,
                              cfg: GJKEPAConfig = DEFAULT_CONFIG,
                              chunk_size: int | None = None
                              ) -> DistanceResult:
    """Closest distance and witness points over analytic shape pairs, in
    the dtype of ``a.params``: the shapes twin of
    :func:`gjk_distance_batch`, ``chunk_size`` included."""
    _same_device(a.kind, "a.kind",
                 **{f"{s}.{f}": t for s, x in (("a", a), ("b", b))
                    for f, t in zip(x._fields, x)})
    return _cat([
        _distance_rows(make_shape_pair_support(ShapeBatch(*(t[c] for t in a)),
                                               ShapeBatch(*(t[c] for t in b))),
                       a.kind[c].shape[0], cfg, a.params.dtype,
                       a.kind.device)
        for c in _chunks(len(a), chunk_size)])

