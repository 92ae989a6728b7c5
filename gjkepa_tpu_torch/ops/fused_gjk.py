"""K1: the GJK hull kernel, its wrapper and its plain version.

Ports ``gjkepa_tpu/ops/fused.py``: ``_hull_broadphase`` (:876),
``_make_hull_support`` (:237), ``_gjk_phase`` (:262-453) and the kernel
``_gjk_kernel_hulls`` (:1099) with its output rows ``_write_gjk_out``
(:903).  The CUDA kernel is ``csrc/gjk_hulls.cu``; both versions take
the kernel's ``use_broadphase`` mode (:1099-1109).  The kernel stages a
block's hulls in shared memory where its tile fits :data:`STAGED_BUDGET`
(:func:`stages`), and reads them from device memory otherwise.

:func:`gjk_hulls` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..config import GJKEPAConfig
from ..spans import spanned
from ..types import Status
from .directions import DIRECTION_TABLE
from .lane_geom import (FACE_IDX, P3, dist_pf_sign, fsqrt, is_inside_tri,
                        pcoincide, pcross, pdot, pmean4, pnorm,
                        point_in_simplex, putz, pwhere, pzero_like, vec_pl)

__all__ = ["GJKRows", "gjk_hulls", "gjk_hulls_plain", "team_size", "TEAMS",
           "TEAM_MAX_VERTICES", "LAUNCHES", "STAGED_LAUNCHES",
           "STAGED_BUDGET", "STAGED_TEAMS", "stages", "staged_team"]

# Kernel launches made by gjk_hulls (CUDA tensors only), and those of them
# that took the staged kernel (the hulls in shared memory).
LAUNCHES = 0
STAGED_LAUNCHES = 0

_RUNNING = -1

# Init-retry directions: the fused path probes the first 8 table rows;
# coincidence past them is MISS_INIT (fused.py:63-66, :281-318).
N_INIT_UNROLL = 8
INIT_DIRS = np.ascontiguousarray(DIRECTION_TABLE[:N_INIT_UNROLL],
                                 dtype=np.float32)

# K1's team sizes (threads a pair; csrc/gjk_hulls.cu instantiates each) and
# the largest hull each of the first three takes: on an H100 a team of 4
# was the fastest up to 64 vertices, 8 up to 256, 16 at 512 and 32 from
# 1024 on (PERF.md, Findings).
TEAMS = (4, 8, 16, 32)
TEAM_MAX_VERTICES = (64, 256, 512)

# K1's staged kernel (a block's 32 pairs, their hulls in shared memory):
# the most shared memory its block may take, in bytes (half an H100 SM's
# 228 KB less the 1 KB the card reserves a block: two blocks an SM), and
# its teams (csrc/gjk_hulls.cu instantiates each): 2 threads a pair up to
# 64 vertices a hull in batches of STAGED_PAIR_TEAM_BATCH pairs or more
# (512 blocks, about four an SM), else 8.  On an H100 a team of 2 was the
# fastest staged team at 16,384 and 65,536 pairs of 24 and 64 vertices,
# and the slowest at 4,096 pairs, a block an SM (PERF.md).
STAGED_BUDGET = 113 * 1024
STAGED_TEAMS = (2, 8)
STAGED_PAIR_TEAM_BATCH = 16_384


class GJKRows(NamedTuple):
    """Per-pair GJK output (the JAX kernel's rows 0-15)."""

    hit: torch.Tensor       # (B,) bool
    status: torch.Tensor    # (B,) int32
    iters: torch.Tensor     # (B,) int32
    sep: torch.Tensor       # (B,) f32 separation lower bound
    simplex: torch.Tensor   # (B, 4, 3) f32 final simplex


def check_hulls(p1: torch.Tensor, p2: torch.Tensor) -> None:
    """Raise on hull buffers the kernels do not take."""
    for name, p in (("p1", p1), ("p2", p2)):
        if p.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {p.dtype}")
        if p.ndim != 3 or p.shape[2] != 3 or p.shape[1] < 1:
            raise ValueError(f"{name} must be (B, N, 3), got {tuple(p.shape)}")
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p1.shape[0] != p2.shape[0]:
        raise ValueError(f"batch sizes differ: {p1.shape[0]} vs {p2.shape[0]}")
    if p1.device != p2.device:
        raise ValueError(f"hulls on different devices: {p1.device}, "
                         f"{p2.device}")


def hull_vertex(p: torch.Tensor, d: P3, sign: float = 1.0) -> P3:
    """The first vertex of each (N, 3) row of ``p`` maximising
    ``sign * <v, d>`` (vertex order, strict ``>``, as the reference's
    scan; ``sign = -1`` negates the dot product, ref :1040-1057)."""
    dots = p[:, :, 0] * d.x[:, None] + p[:, :, 1] * d.y[:, None] \
        + p[:, :, 2] * d.z[:, None]
    idx = torch.argmax(dots if sign > 0 else -dots, dim=1)
    return P3(*(torch.gather(p[:, :, k], 1, idx[:, None])[:, 0]
                for k in range(3)))


def make_hull_support_ab(p1: torch.Tensor, p2: torch.Tensor):
    """Support of the Minkowski difference over two (B, N, 3) vertex sets
    with its witnesses: d -> (a - b, a, b), a the first max of <v, d> on
    side 1 and b the first max of -<v, d> on side 2."""

    def support(d: P3):
        a = hull_vertex(p1, d)
        b = hull_vertex(p2, d, -1.0)
        return a - b, a, b

    return support


def make_hull_support(p1: torch.Tensor, p2: torch.Tensor):
    """Support point of the Minkowski difference over two (B, N, 3) vertex
    sets (:func:`make_hull_support_ab` without the witnesses)."""
    support_ab = make_hull_support_ab(p1, p2)
    return lambda d: support_ab(d)[0]


def hull_sphere(p: torch.Tensor):
    """Bounding sphere of (B, N, 3) hulls: the centroid P3 and the largest
    centroid-vertex distance."""
    c = p.mean(dim=1)                                  # (B, 3)
    r = fsqrt((p[:, :, 0] - c[:, 0:1]) ** 2
              + (p[:, :, 1] - c[:, 1:2]) ** 2
              + (p[:, :, 2] - c[:, 2:3]) ** 2).amax(dim=1)
    return P3(c[:, 0], c[:, 1], c[:, 2]), r


def hull_broadphase(p1: torch.Tensor, p2: torch.Tensor, tol) -> torch.Tensor:
    """Bounding-sphere overlap: centroid distance <= r1 + r2 + tol."""
    c1, r1 = hull_sphere(p1)
    c2, r2 = hull_sphere(p2)
    return pnorm(c1 - c2) <= r1 + r2 + tol


def gjk_phase(support, active: torch.Tensor, cfg: GJKEPAConfig):
    """Init (v1-v4) + iterate loop over (B,) lanes.

    Returns (simplex 4-tuple of P3, status, iters, sep)."""
    eps = cfg.eps_coincide
    epz = cfg.eps_zero
    b = active.shape[0]
    dev = active.device
    zero = pzero_like(torch.zeros(b, dtype=torch.float32, device=dev))

    def sep_upd(sep, d, w, run):
        return torch.where(run, torch.maximum(sep, -pdot(w, d)), sep)

    def const_dir(i):
        return P3(*(torch.full((b,), float(INIT_DIRS[i, k]),
                               dtype=torch.float32, device=dev)
                    for k in range(3)))

    # --- v1/v2 retry over the first N_INIT_UNROLL table rows (ref :82-112)
    d0 = const_dir(0)
    w1 = support(d0)
    w2 = support(-d0)
    s1 = pwhere(active, w1, zero)
    s2 = pwhere(active, w2, zero)
    sep = sep_upd(sep_upd(zero.x, d0, w1, active), -d0, w2, active)
    run = active & pcoincide(s1, s2, eps)
    for i in range(1, N_INIT_UNROLL):
        d = const_dir(i)
        w1 = support(d)
        w2 = support(-d)
        s1 = pwhere(run, w1, s1)
        s2 = pwhere(run, w2, s2)
        sep = sep_upd(sep_upd(sep, d, w1, run), -d, w2, run)
        run = run & pcoincide(s1, s2, eps)
    init_failed = pcoincide(s1, s2, eps)

    # --- v3 (ref :115-127) + origin-on-segment fix (fused.py:320-337) -----
    d3 = vec_pl(zero, s1, s2, epz)
    seg = s2 - s1
    segsq = pdot(seg, seg)
    t3 = -pdot(s1, seg) / torch.clamp(segsq, min=epz)
    rej = P3(s1.x + t3 * seg.x, s1.y + t3 * seg.y, s1.z + t3 * seg.z)
    on_line = pdot(rej, rej) <= (eps * eps) * (1.0 + segsq)
    alt = putz(pcross(seg, const_dir(0)), epz)
    alt2 = putz(pcross(seg, const_dir(1)), epz)
    alt = pwhere(pdot(alt, alt) > 0.0, alt, alt2)
    d3 = pwhere((pdot(d3, d3) > 0.0) & ~on_line, d3, alt)
    s3 = support(d3)
    sep = sep_upd(sep, d3, s3, active)
    v3_degenerate = pcoincide(s3, s1, eps) | pcoincide(s3, s2, eps)

    # --- v4 + early-EPA checks (ref :130-170) -----------------------------
    d4 = putz(pcross(s2 - s1, s3 - s2), epz)
    vo = -s3
    on_plane = torch.abs(pdot(vo, d4)) < eps
    early_hit = on_plane & is_inside_tri(s1, s2, s3, zero, epz)
    d4f = pwhere(pdot(vo, d4) < 0.0, -d4, d4)
    s4 = support(d4f)
    sep = sep_upd(sep, d4f, s4, active)
    v4_coplanar = torch.abs(dist_pf_sign(s4, s1, s2, s3, epz)) < eps
    # early-EPA seed: fresh support along the unflipped normal, the
    # opposite side when that one is coplanar (fused.py:353-363)
    s4e = support(d4)
    s4e_cop = torch.abs(dist_pf_sign(s4e, s1, s2, s3, epz)) < eps
    s4 = pwhere(early_hit, pwhere(s4e_cop, support(-d4), s4e), s4)
    in_tetra = point_in_simplex(zero, (s1, s2, s3, s4), eps, epz)

    status = torch.full((b,), _RUNNING, dtype=torch.int32, device=dev)
    for cond, code in ((in_tetra, Status.HIT),
                       (v4_coplanar, Status.MISS_INIT),
                       (early_hit, Status.HIT),
                       (v3_degenerate, Status.MISS_INIT),
                       (init_failed, Status.MISS_INIT),
                       (~active, Status.MISS_BROADPHASE)):
        status = torch.where(cond, code, status)

    # --- iterate loop (ref :178-236) --------------------------------------
    s = (s1, s2, s3, s4)
    l1 = l2 = (zero,) * 4
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    while True:
        run = (status == _RUNNING) & (it < cfg.gjk_max_iters)
        if not bool(run.any()):
            break
        m = pmean4(s)
        normals, scores = [], []
        for (f0, f1, f2) in FACE_IDX:
            n = putz(pcross(s[f0] - s[f1], s[f1] - s[f2]), epz)
            n = pwhere(pdot(n, s[f0] - m) < 0.0, -n, n)
            normals.append(n)
            scores.append(-pdot(n, s[f0]))
        # MAXLOC (first max) as a strict-> chain
        best = scores[0]
        k = torch.zeros(b, dtype=torch.int32, device=dev)
        for i in (1, 2, 3):
            better = scores[i] > best
            best = torch.where(better, scores[i], best)
            k = torch.where(better, i, k)
        d = zero
        for i in range(4):
            d = pwhere(k == i, normals[i], d)
        w = support(d)
        sep = sep_upd(sep, d, w, run)
        new_s = []
        for slot in range(3):
            v = zero
            for i in range(4):
                v = pwhere(k == i, s[FACE_IDX[i][slot]], v)
            new_s.append(v)
        new_s.append(w)

        flat_tri = pnorm(pcross(new_s[1] - new_s[0],
                                new_s[2] - new_s[1])) < eps
        coplanar4 = torch.abs(dist_pf_sign(new_s[3], new_s[0], new_s[1],
                                           new_s[2], epz)) < eps
        contains = point_in_simplex(zero, tuple(new_s), eps, epz)
        stalled = None
        for i in range(4):
            same = (pcoincide(new_s[i], l1[i], eps)
                    | pcoincide(new_s[i], l2[i], eps))
            stalled = same if stalled is None else (stalled & same)

        status = torch.where(run & stalled, Status.MISS_GJK, status)
        status = torch.where(run & contains, Status.HIT, status)
        status = torch.where(run & coplanar4, Status.MISS_GJK, status)
        status = torch.where(run & flat_tri, Status.MISS_GJK, status)
        s, l1, l2 = (tuple(pwhere(run, n_, o_) for n_, o_ in zip(new, old))
                     for new, old in ((new_s, s), (s, l1), (l1, l2)))
        it = torch.where(run, it + 1, it)

    status = torch.where(status == _RUNNING, Status.MISS_GJK, status)
    hit = status == Status.HIT
    sep = torch.where(hit | ~active, 0.0, torch.clamp(sep, min=0.0))
    return s, status, it, sep


def gjk_rows(p1: torch.Tensor, p2: torch.Tensor, active: torch.Tensor,
             cfg: GJKEPAConfig) -> GJKRows:
    """The GJK phase over hull pairs whose broadphase is decided
    (``active``), as GJK rows: the plain body of K1 and K12."""
    s, status, it, sep = gjk_phase(make_hull_support(p1, p2), active, cfg)
    simplex = torch.stack([torch.stack([v.x, v.y, v.z], dim=1) for v in s],
                          dim=1)
    return GJKRows(status == Status.HIT, status, it, sep, simplex)


def gjk_hulls_plain(p1: torch.Tensor, p2: torch.Tensor, cfg: GJKEPAConfig,
                    use_broadphase: bool = True) -> GJKRows:
    """Plain PyTorch version of K1 (lane-vectorised masked tensor code);
    without the broadphase every pair runs GJK (fused.py:1105-1108)."""
    check_hulls(p1, p2)
    if use_broadphase:
        active = hull_broadphase(p1, p2, cfg.broadphase_tol)
    else:
        active = torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)
    return gjk_rows(p1, p2, active, cfg)


def team_size(n1: int, n2: int) -> int:
    """Threads of K1 that share one pair (a divisor of the 32-thread warp):
    the first of TEAMS whose TEAM_MAX_VERTICES holds the larger hull, else
    the last."""
    n = max(n1, n2)
    return next((t for t, m in zip(TEAMS, TEAM_MAX_VERTICES) if n <= m),
                TEAMS[-1])


def stages(n1: int, n2: int, tile_bytes, budget: int = STAGED_BUDGET) -> bool:
    """Whether K1 stages the hulls of a block's pairs in shared memory: while
    its tile, ``tile_bytes(n1, n2)`` bytes (the kernel's
    ``gjk_hulls_staged_bytes`` on the card), fits ``budget``."""
    return tile_bytes(n1, n2) <= budget


def staged_team(b: int, n1: int, n2: int) -> int:
    """Threads a pair of K1's staged kernel over ``b`` pairs: the first of
    STAGED_TEAMS up to 64 vertices a hull in a batch of
    STAGED_PAIR_TEAM_BATCH pairs or more, else the second."""
    small = max(n1, n2) <= 64 and b >= STAGED_PAIR_TEAM_BATCH
    return STAGED_TEAMS[0] if small else STAGED_TEAMS[1]


@functools.cache
def _staged(n1: int, n2: int) -> bool:
    """:func:`stages` over the kernel's own byte count, once a shape."""
    return stages(n1, n2, _build.load().gjk_hulls_staged_bytes)


def _gjk_hulls_cuda(p1, p2, cfg: GJKEPAConfig, team: int | None = None,
                    use_broadphase: bool = True,
                    staged: bool | None = None) -> GJKRows:
    """K1 on the card.  By default the staged kernel (the hulls in shared
    memory) at :func:`staged_team` where :func:`stages` holds, else the
    streamed kernel at :func:`team_size`; a ``team`` given alone (one of
    TEAMS) runs the streamed kernel, ``staged=True`` the staged one (at a
    team of STAGED_TEAMS)."""
    global LAUNCHES, STAGED_LAUNCHES
    lib = _build.load()
    b, n1, n2 = p1.shape[0], p1.shape[1], p2.shape[1]
    if staged is None:
        staged = team is None and _staged(n1, n2)
    if team is None:
        team = staged_team(b, n1, n2) if staged else team_size(n1, n2)
    teams = STAGED_TEAMS if staged else TEAMS
    if team not in teams:
        raise ValueError(f"K1 team of {team} threads, expected one of "
                         f"{teams}")
    dev = p1.device
    out = GJKRows(torch.empty(b, dtype=torch.bool, device=dev),
                  torch.empty(b, dtype=torch.int32, device=dev),
                  torch.empty(b, dtype=torch.int32, device=dev),
                  torch.empty(b, dtype=torch.float32, device=dev),
                  torch.empty((b, 4, 3), dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = _build.ptr
        rc = lib.gjk_hulls_launch(
            ptr(p1), ptr(p2), INIT_DIRS.ctypes.data_as(ctypes.c_void_p),
            ptr(out.hit), ptr(out.status), ptr(out.iters), ptr(out.sep),
            ptr(out.simplex), b, n1, n2, team, int(use_broadphase),
            int(staged), cfg.eps_coincide, cfg.eps_zero,
            cfg.eps_coincide * cfg.eps_coincide,  # rounded once, as gjk_phase
            cfg.broadphase_tol, cfg.gjk_max_iters, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"gjk_hulls kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    STAGED_LAUNCHES += bool(staged)
    return out


@spanned("gjkepa.k1")
def gjk_hulls(p1: torch.Tensor, p2: torch.Tensor, cfg: GJKEPAConfig,
              use_broadphase: bool = True) -> GJKRows:
    """K1 over (B, N, 3) float32 hull pairs; ``use_broadphase=False`` skips
    the bounding spheres and runs GJK on every pair.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/gjk_hulls.cu``), which raises if it cannot build or launch."""
    check_hulls(p1, p2)
    if p1.device.type == "cpu":
        return gjk_hulls_plain(p1, p2, cfg, use_broadphase)
    if p1.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {p1.device}")
    return _gjk_hulls_cuda(p1, p2, cfg, use_broadphase=use_broadphase)
