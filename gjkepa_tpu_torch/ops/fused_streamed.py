"""The large-hull path: K12, K13 and their dispatch for n1 + n2 > 4096.

Ports ``_fused_hulls_streamed`` (``gjkepa_tpu/ops/fused.py:1434-1502``)
with its kernels ``_gjk_kernel_hulls_big`` (K12, :1073) and
``_epa_cascade_kernel_hulls_big`` (K13, :1086) over the streamed support
``_make_hull_support_streamed`` (K11, :1010).  The CUDA kernels are
``csrc/gjk_hulls_big.cu`` and ``csrc/epa_hulls_big.cu`` over the warp
support of ``csrc/hull_stream.cuh``; each has its plain PyTorch version
here.  A wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

``fused_gjkepa_hulls`` routes a batch here when n1 + n2 exceeds
:data:`STREAM_THRESHOLD`, as the JAX package does (:1533-1540), and the
route is visible in the results: the JAX package decides the
bounding-sphere broadphase on the hulls padded to a multiple of the
1024-vertex tile by repeating vertex 0 (:1449-1478), so the centroid
counts the repeats.  :func:`streamed_broadphase` does the same.  The
kernels then read the unpadded hulls: trailing repeats of vertex 0 never
change a first-max support (:1443-1446).

On the TPU the support streams vertex slabs through VMEM and folds them
with strict ``>``; on the card a team of threads scans a pair's vertices
(W warps of a block in K12 and K13, 4-32 threads in K1) and a shuffle
reduction keeps the first maximum (:func:`warp_first_max_plain` is that
reduction in torch, :func:`block_first_max_plain` its fold over a block's
warps).  K12 copies both hulls of a pair into shared memory once and
probes them there while they fit (its launcher's choice).  K13 keeps each
pair's polytope in shared memory where its store fits, in device memory
otherwise (K2's rule), and splits its face scans across a warp
(``csrc/epa_warp.cuh``): :func:`warp_first_min_plain` and
:func:`ballot_rank_plain` are its reductions in torch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..config import GJKEPAConfig
from ..spans import spanned
from .fused import FusedResult, cascade_plan, hulls_result, round_cfg
from .fused_epa import (MAX_TIERS, EPARows, _check_inputs, _passthrough,
                        check_stages, check_tensors, epa_cascade_plain,
                        face_stores)
from .fused_gjk import (INIT_DIRS, GJKRows, check_hulls, gjk_rows,
                        hull_broadphase)
from .fused_shapes import empty_gjk_rows, gjk_args

__all__ = ["STREAM_THRESHOLD", "TILE", "streams", "pad_tile",
           "streamed_broadphase", "gjk_hulls_big", "gjk_hulls_big_plain",
           "epa_hulls_big", "epa_hulls_big_plain", "warp_first_max_plain",
           "block_first_max_plain", "warp_first_min_plain",
           "ballot_rank_plain", "fused_hulls_streamed", "LAUNCHES"]

# n1 + n2 above which the JAX package streams: _AUTO_BLOCK_BUDGET //
# (3 * 4 * 128), both hulls of a 128-lane block in a 6 MB VMEM budget
# (fused.py:1403, :1533).
STREAM_THRESHOLD = 4096
# The vertex tile the JAX package pads each hull to a multiple of (:1435).
TILE = 1024
WARP = 32

# Kernel launches made by the wrappers below (CUDA tensors only).
LAUNCHES = {"gjk_hulls_big": 0, "epa_hulls_big": 0}


def streams(n1: int, n2: int) -> bool:
    """Whether hulls of n1 and n2 vertices take the large-hull path."""
    return n1 + n2 > STREAM_THRESHOLD


def pad_tile(p: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """(B, N, 3) hulls padded to a multiple of ``tile`` vertices by
    repeating vertex 0 (:1449-1453)."""
    pad = (-p.shape[1]) % tile
    if pad == 0:
        return p
    return torch.cat([p, p[:, :1].expand(-1, pad, -1)], dim=1)


@spanned("gjkepa.broadphase")
def streamed_broadphase(p1: torch.Tensor, p2: torch.Tensor, tol,
                        tile: int = TILE) -> torch.Tensor:
    """The (B,) bool broadphase of the large-hull path: bounding spheres of
    the tile-padded hulls (:1467-1476)."""
    return hull_broadphase(pad_tile(p1, tile), pad_tile(p2, tile), tol)


def warp_first_max_plain(dots: torch.Tensor, width: int = WARP,
                         group: int = 1) -> torch.Tensor:
    """K11's reduction over (B, N) dots in torch: thread t of a ``width``
    warp keeps the first maximum of its columns in index order, the
    ``group`` columns from (t + width * k) * group on, k = 0, 1, ... (the
    kernels read 4-vertex groups, ``group=4``, where N % 4 == 0, single
    vertices otherwise); then log2(width) xor-shuffle steps keep the larger
    value, and on an equal value the smaller index.  Returns the (B,) int64
    index every thread ends with (held to ``torch.argmax``, the first
    maximum)."""
    b, n = dots.shape
    cols = -(-n // (width * group)) * width * group
    vals = torch.full((b, cols), -torch.inf, dtype=dots.dtype,
                      device=dots.device)
    vals[:, :n] = dots
    idx = torch.arange(cols, device=dots.device).expand(b, -1)
    idx = torch.where(idx < n, idx, torch.iinfo(torch.int32).max)

    def by_thread(x):
        """Column (k * width + t) * group + j as row k * group + j of
        thread t's column: each thread's columns in its scan order."""
        return x.reshape(b, -1, width, group).transpose(2, 3).reshape(
            b, -1, width)

    vals, idx = by_thread(vals), by_thread(idx)
    best, bidx = vals[:, 0], idx[:, 0]
    for k in range(1, vals.shape[1]):
        take = vals[:, k] > best                     # strict: first wins
        best = torch.where(take, vals[:, k], best)
        bidx = torch.where(take, idx[:, k], bidx)
    lane = torch.arange(width, device=dots.device)
    off = width // 2
    while off:
        ob, oi = best[:, lane ^ off], bidx[:, lane ^ off]
        take = (ob > best) | ((ob == best) & (oi < bidx))
        best = torch.where(take, ob, best)
        bidx = torch.where(take, oi, bidx)
        off //= 2
    return bidx[:, 0]


def block_first_max_plain(dots: torch.Tensor, warps: int) -> torch.Tensor:
    """The first maximum a block of ``warps`` warps finds over (B, N) dots
    (``csrc/hull_stream.cuh`` BlockHullSupport): thread t of the block owns
    columns t, t + 32 * warps, ...; each warp reduces its 32 threads as
    :func:`warp_first_max_plain` does, and the warp results are folded in
    warp order, keeping the larger value and, on an equal value, the
    smaller index.  Returns the (B,) int64 index (held to
    ``torch.argmax``)."""
    b, n = dots.shape
    width = WARP * warps
    cols = -(-n // width) * width
    vals = torch.full((b, cols), -torch.inf, dtype=dots.dtype,
                      device=dots.device)
    vals[:, :n] = dots
    # warp u's threads own the columns of lanes 32u..32u+31 of each row of
    # the (B, -1, width) view: as a 32-wide warp, those columns alone
    per_warp = vals.view(b, -1, warps, WARP).transpose(1, 2)
    best = idx = None
    for u in range(warps):
        cols_u = per_warp[:, u].reshape(b, -1)           # (B, k * 32)
        local = warp_first_max_plain(cols_u, WARP)       # index in cols_u
        row, lane = local // WARP, local % WARP
        g = row * width + u * WARP + lane                # the column it is
        v = torch.gather(vals, 1, g[:, None])[:, 0]
        g = torch.where(torch.isneginf(v) & (g >= n),
                        torch.iinfo(torch.int32).max, g)
        if best is None:
            best, idx = v, g
        else:
            take = (v > best) | ((v == best) & (g < idx))
            best = torch.where(take, v, best)
            idx = torch.where(take, g, idx)
    return idx


def warp_first_min_plain(vals: torch.Tensor, width: int = WARP
                         ) -> torch.Tensor:
    """The min-face reduction of ``csrc/epa_warp.cuh`` over (B, F) face
    distances in torch: thread t of a ``width`` warp keeps the first
    (strict <) minimum of faces t, t + width, ...; xor-shuffle steps keep
    the smaller value, and on an equal value the smaller index.  It is
    :func:`warp_first_max_plain` on the negated distances (negation is exact
    and reverses the order, ties included; the kernel's +inf for a thread
    without faces is the -inf there).  Returns the (B,) int64 index (held
    to ``torch.argmin``, the first minimum)."""
    return warp_first_max_plain(-vals, width)


def _popcount(x: torch.Tensor, width: int) -> torch.Tensor:
    return sum((x >> k) & 1 for k in range(width))


def ballot_rank_plain(flags: torch.Tensor, width: int = WARP):
    """The ballot/prefix ranking of ``csrc/epa_warp.cuh`` over (B, N) flags
    in torch: per ``width``-column chunk a ballot word, each flagged
    column's rank the popcount of the ballot below its lane plus the
    flagged columns of the earlier chunks.  Returns the (B, N) int64 rank
    (-1 where not flagged) and the (B,) count: the order of the stable
    ``argsort`` that puts flagged columns first, and ``cumsum - 1``."""
    b, n = flags.shape
    cols = -(-n // width) * width
    f = torch.zeros((b, cols), dtype=torch.int64, device=flags.device)
    f[:, :n] = flags.long()
    lane = torch.arange(width, device=flags.device)
    ballot = (f.view(b, -1, width) << lane).sum(dim=2)       # (B, chunks)
    below = _popcount(ballot[:, :, None] & ((1 << lane) - 1), width)
    total = _popcount(ballot, width)
    rank = (torch.cumsum(total, 1) - total)[:, :, None] + below
    rank = rank.view(b, cols)[:, :n]
    return torch.where(flags, rank, -1), total.sum(dim=1)


# -- K12 ----------------------------------------------------------------------

def _check_gjk(p1, p2, active) -> None:
    check_hulls(p1, p2)
    check_tensors(p1, active=(active, torch.bool, (p1.shape[0],)))


def gjk_hulls_big_plain(p1, p2, active, cfg: GJKEPAConfig) -> GJKRows:
    """Plain PyTorch version of K12: the GJK phase over every pair, with
    the broadphase decided by the caller (``active``)."""
    _check_gjk(p1, p2, active)
    return gjk_rows(p1, p2, active, cfg)


@spanned("gjkepa.k12")
def gjk_hulls_big(p1, p2, active, cfg: GJKEPAConfig) -> GJKRows:
    """K12 over (B, N, 3) float32 hull pairs, a block of warps a pair, with
    both hulls staged in shared memory where they fit."""
    _check_gjk(p1, p2, active)
    if not _build.on_card(p1, "K12"):
        return gjk_hulls_big_plain(p1, p2, active, cfg)
    out = empty_gjk_rows(p1.shape[0], p1.device)
    ptr = _build.ptr
    _build.launch("gjk_hulls_big", p1.device, LAUNCHES, ptr(p1), ptr(p2),
                  ptr(active), INIT_DIRS.ctypes.data_as(ctypes.c_void_p),
                  *(ptr(t) for t in out), p1.shape[0], p1.shape[1],
                  p2.shape[1], *gjk_args(cfg))
    return out


# -- K13 ----------------------------------------------------------------------

# Plain PyTorch version of K13: K2's cascade (the support map is the same
# function).
epa_hulls_big_plain = epa_cascade_plain


def _epa_hulls_big_cuda(p1, p2, simplex, gjk_status, order, n_act, stages,
                        near_faces: int | None = None) -> EPARows:
    """K13 with a shared-memory store of ``near_faces`` faces (the size
    rule when None) and, if a tier needs one, a device store a hit
    (:func:`.fused_epa.face_stores`)."""
    b, n1, n2, dev = p1.shape[0], p1.shape[1], p2.shape[1], p1.device
    cfg = stages[0][0]
    lib = _build.load()
    near_faces, far_faces, far = face_stores(
        stages, lib.epa_hulls_big_smem_bytes, n_act, dev, near_faces)
    tier_f = (ctypes.c_int * MAX_TIERS)(*[c.epa_max_faces for c, _ in stages])
    tier_k = (ctypes.c_int * MAX_TIERS)(*[k for _, k in stages])
    out = _passthrough(gjk_status, b, dev)
    ptr = _build.ptr
    _build.launch("epa_hulls_big", dev, LAUNCHES, ptr(p1), ptr(p2),
                  ptr(simplex), ptr(order), ptr(n_act), *(ptr(t) for t in out),
                  None if far is None else ptr(far), b, n1, n2, len(stages),
                  tier_f, tier_k, near_faces, far_faces, cfg.eps_coincide,
                  cfg.eps_zero, cfg.epa_max_iters,
                  explain=_build.smem_refusal(lib.epa_hulls_big_smem_bytes,
                                              near_faces, dev))
    return out


@spanned("gjkepa.k13")
def epa_hulls_big(p1, p2, simplex, gjk_status, order, n_act,
                  stages: list[tuple[GJKEPAConfig, int]]) -> EPARows:
    """K13: the EPA tier ladder over pairs ``order[:n_act]`` (``n_act`` a
    device scalar), a block of warps a pair with the polytope in shared
    memory where its store fits and in device memory otherwise (K2's rule:
    no face capacity is refused; only the device store reads ``n_act``)."""
    _check_inputs(p1, p2, simplex, gjk_status, order, n_act)
    check_stages(stages)
    if not _build.on_card(p1, "K13"):
        return epa_hulls_big_plain(p1, p2, simplex, gjk_status, order, n_act,
                                   stages)
    return _epa_hulls_big_cuda(p1, p2, simplex, gjk_status, order, n_act,
                               stages)


# -- dispatch -----------------------------------------------------------------

@spanned("gjkepa.fused_hulls_streamed")
def fused_hulls_streamed(p1: torch.Tensor, p2: torch.Tensor,
                         cfg: GJKEPAConfig | None = None,
                         tile: int = TILE,
                         use_broadphase: bool = True) -> FusedResult:
    """The large-hull pipeline over (B, N, 3) float32 hull pairs (masks
    already turned into padding): the broadphase on the tile-padded hulls
    (every pair active with ``use_broadphase=False``, :1468-1476), K12 over
    every pair, a hit-first order with the count on the device, then K13
    over the hits.  ``epa_max_iters == 0`` runs no EPA."""
    cfg = round_cfg(cfg)
    if use_broadphase:
        active = streamed_broadphase(p1, p2, cfg.broadphase_tol, tile)
    else:
        active = torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)
    g = gjk_hulls_big(p1, p2, active, cfg)
    return hulls_result(g, cascade_plan(cfg), lambda *a: epa_hulls_big(
        p1, p2, g.simplex, g.status, *a))
