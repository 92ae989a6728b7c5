"""Public query API of the port: the fused hull-pair and shape-pair queries.

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

Layouts are the JAX package's: (B, N, 3) float32 vertices, optional (B, N)
bool masks, and a :class:`CollisionResult` with its field names, shapes and
dtypes.  Everything runs on the device the inputs are on; inputs on
different devices raise rather than move.
"""

from __future__ import annotations

import torch

from .config import DEFAULT_CONFIG, GJKEPAConfig
from .models.shapes import ShapeBatch, make_shape_pair_support
from .ops.contact_rows import derive_contact_rows
from .ops.contact_shapes import derive_contact_shapes
from .ops.distance import DistanceResult, gjk_distance
from .ops.fused import FusedResult, fused_gjkepa_hulls, fused_gjkepa_shapes
from .ops.support import make_hull_support
from .types import CollisionResult

__all__ = ["gjkepa_batch_fused", "derive_contact_batch",
           "collide_shapes_batch_fused", "gjk_distance_batch",
           "gjk_distance_shapes_batch"]


def _same_device(ref: torch.Tensor, ref_name: str = "p1", **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on "
                             f"{ref.device}")


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
    npts, cpoint, normal, ctype = derive_contact_rows(p1, p2, r.normal, cfg,
                                                      mask1, mask2)
    return _collision_result(r, npts, cpoint, normal, ctype)


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
    npts, cpoint, normal, ctype = derive_contact_shapes(a, b, r.normal, cfg)
    return _collision_result(r, npts, cpoint, normal, ctype)


def gjk_distance_batch(p1: torch.Tensor, p2: torch.Tensor,
                       mask1: torch.Tensor | None = None,
                       mask2: torch.Tensor | None = None,
                       cfg: GJKEPAConfig = DEFAULT_CONFIG) -> DistanceResult:
    """Closest distance and witness points over (B, N, 3) hull pairs, 0 for
    intersecting pairs, in the hulls' dtype (float32 or float64); optional
    (B, N) bool masks drop padded vertices."""
    _same_device(p1, p2=p2, mask1=mask1, mask2=mask2)
    active = torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)
    return gjk_distance(make_hull_support(p1, p2, mask1, mask2), cfg,
                        dtype=p1.dtype, active=active)


def gjk_distance_shapes_batch(a: ShapeBatch, b: ShapeBatch,
                              cfg: GJKEPAConfig = DEFAULT_CONFIG
                              ) -> DistanceResult:
    """Closest distance and witness points over analytic shape pairs, in
    the dtype of ``a.params``: the shapes twin of
    :func:`gjk_distance_batch`."""
    _same_device(a.kind, "a.kind",
                 **{f"{s}.{f}": t for s, x in (("a", a), ("b", b))
                    for f, t in zip(x._fields, x)})
    active = torch.ones(a.kind.shape[0], dtype=torch.bool,
                        device=a.kind.device)
    return gjk_distance(make_shape_pair_support(a, b), cfg,
                        dtype=a.params.dtype, active=active)


def _collision_result(r: FusedResult, npts, cpoint, normal, ctype
                      ) -> CollisionResult:
    """Contact rows zeroed on misses, as the reference does (:65-71)."""
    hit = r.hit
    zero = torch.zeros((), dtype=cpoint.dtype, device=cpoint.device)
    return CollisionResult(
        hit=hit,
        colli_type=torch.where(hit, ctype, 0).to(torch.int32),
        nearest_points=torch.where(hit[:, None, None], npts, zero),
        normal=torch.where(hit[:, None], normal, zero),
        contact_point=torch.where(hit[:, None], cpoint, zero),
        depth=torch.where(hit, r.depth, zero),
        distance=r.distance,
        status=r.status,
        gjk_iters=r.gjk_iters,
        epa_iters=r.epa_iters,
    )
