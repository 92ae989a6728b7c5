"""Broadphase: the bounding-sphere reject and candidate-pair generation.

Port of ``gjkepa_tpu/ops/broadphase.py``.  The reference's only
broadphase is a centroid and max-radius bounding sphere per hull with a
fixed inflation (RoughCollisionDetection_SphericalEnvelope,
``GCLIB_GJKEPA.f90:1165-1188``), here over (B, N, 3) hulls with optional
(B, N) masks.  The rigid-body sim's candidate pairs come from
:func:`swept_candidate_pairs` (sweep and prune) or its O(n^2) twin
:func:`grid_candidate_pairs`: fixed-capacity pair lists with a validity
mask and the true candidate count, on the device of the centres, with no
host read.  Torch code, no kernel.
"""

from __future__ import annotations

import torch

from .geom import norm3

__all__ = ["bounding_spheres", "sphere_envelope_overlap",
           "grid_candidate_pairs", "swept_candidate_pairs"]


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


def _kth_columns(cum: torch.Tensor, k_cap: int) -> torch.Tensor:
    """(n, k_cap): the column of each row's k-th candidate (0-based), the
    count of prefix sums below k + 1 (the row's width where it has fewer
    than k + 1)."""
    want = torch.arange(1, k_cap + 1, dtype=cum.dtype, device=cum.device)
    return torch.searchsorted(cum, want.expand(cum.shape[0], k_cap).contiguous())


def grid_candidate_pairs(centers, radii, cell_size: float, max_pairs: int):
    """Candidate pairs (i, j > i) of (n, 3) centres whose spheres, radii
    (n,), overlap within ``cell_size`` (what a one-cell grid
    neighbourhood admits): an O(n^2) sweep compacted row by row, each body
    i with K = max_pairs // n slots.  Returns (pairs (n K, 2) int32, valid
    (n K,), n_candidates: the true count, so the caller sees what the
    slots dropped)."""
    n = centers.shape[0]
    k_cap = max(1, max_pairs // n)
    dist = norm3(centers[:, None, :] - centers[None, :, :])
    rsum = radii[:, None] + radii[None, :]
    iota = torch.arange(n, device=centers.device)
    cand = (iota[None, :] > iota[:, None]) & (dist <= rsum + cell_size)
    cum = torch.cumsum(cand.to(torch.int32), dim=1)
    jj = torch.clamp(_kth_columns(cum, k_cap), max=n - 1)
    ii = iota[:, None].expand(n, k_cap)
    valid = torch.arange(k_cap, device=centers.device)[None, :] < cum[:, -1:]
    pairs = torch.stack([ii.reshape(-1), jj.reshape(-1)], 1).to(torch.int32)
    return pairs, valid.reshape(-1), cand.sum(dtype=torch.int32)


def swept_candidate_pairs(centers, radii, max_pairs: int, window: int = 64,
                          inflate: float = 0.5):
    """Sweep and prune over the x-intervals of (n, 3) centres with radii
    (n,): bodies sorted by the low end of their interval (a stable sort,
    so equal ends keep body order), each tested against its next
    ``window`` neighbours, a pair admitted where ||ci - cj|| <= ri + rj +
    inflate (:func:`grid_candidate_pairs`' rule), as (earlier, later).

    Returns (pairs (n K, 2) int32 with K = max_pairs // n slots a body,
    valid (n K,), n_candidates int32, overflow).  ``overflow`` is True
    where candidates may have been dropped: an interval reaching past its
    window-th neighbour, a body with more candidates than its K slots, or
    more candidates than ``max_pairs``.  Invalid slots hold the self-pair
    (i, i)."""
    n = centers.shape[0]
    dev = centers.device
    w = min(window, n - 1)
    k_cap = max(1, max_pairs // n)
    x = centers[:, 0]
    x_lo = x - radii
    order = torch.argsort(x_lo, stable=True)
    xs = x_lo[order]
    xe = (x + radii)[order] + inflate
    c_s = centers[order]
    r_s = radii[order]

    iota = torch.arange(n, device=dev)
    idx = iota[:, None] + torch.arange(1, w + 1, device=dev)[None, :]
    in_range = idx < n
    nb = torch.clamp(idx, max=n - 1)          # out-of-range ones masked
    x_open = xs[nb] <= xe[:, None]            # neighbour starts before I end
    dist = norm3(c_s[nb] - c_s[:, None, :])
    cand = in_range & x_open & (dist <= r_s[:, None] + r_s[nb] + inflate)

    # window overflow: an interval still reaching its w-th neighbour's
    # start, past which candidates could exist
    tail = iota + w
    over_window = ((tail < n)
                   & (xs[torch.clamp(tail, max=n - 1)] <= xe)).any()

    cum = torch.cumsum(cand.to(torch.int32), dim=1)
    nrow = cum[:, -1]
    kk = torch.clamp(_kth_columns(cum, k_cap), max=w - 1)
    j_sorted = torch.clamp(iota[:, None] + kk + 1, max=n - 1)
    ii = order[:, None].expand(n, k_cap)
    valid = torch.arange(k_cap, device=dev)[None, :] < nrow[:, None]
    jj = torch.where(valid, order[j_sorted], ii)
    n_cand = cand.sum(dtype=torch.int32)
    overflow = over_window | (nrow > k_cap).any() | (n_cand > max_pairs)
    pairs = torch.stack([ii.reshape(-1), jj.reshape(-1)], 1).to(torch.int32)
    return pairs, valid.reshape(-1), n_cand, overflow
