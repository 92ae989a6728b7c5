"""Public query API of the port: the fused hull-pair query.

Port of ``gjkepa_tpu/api.py:350-411``: :func:`gjkepa_batch_fused` runs the
two hull kernels (K1 GJK, K2 EPA cascade) and derives the reference's
contact outputs (nearest points, contact point, type) with
:func:`derive_contact_batch`: the complete GJKEPA contract of the
reference's one entry point (``SUBROUTINE GJKEPA``, GCLIB_GJKEPA.f90:39-239)
over a batch of pairs.

Layouts are the JAX package's: (B, N, 3) float32 vertices, optional (B, N)
bool masks, and a :class:`CollisionResult` with its field names, shapes and
dtypes.  Everything runs on the device the inputs are on; inputs on
different devices raise rather than move.
"""

from __future__ import annotations

import torch

from .config import GJKEPAConfig
from .ops.contact_rows import derive_contact_rows
from .ops.fused import FusedResult, fused_gjkepa_hulls
from .types import CollisionResult

__all__ = ["gjkepa_batch_fused", "derive_contact_batch"]


def _same_device(ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, p1 on {ref.device}")


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
    hit = r.hit
    zero = torch.zeros((), dtype=p1.dtype, device=p1.device)
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
