"""K2: the EPA cascade hull kernel, its wrapper and its plain version.

Ports ``gjkepa_tpu/ops/fused.py``: ``_epa_phase_fast`` (:456-749),
``_epa_cascade`` (:837-873), the kernel ``_epa_cascade_kernel_hulls``
(:1112) and the per-lane merge of ``_write_epa_out`` (:975-1007).  The
CUDA kernel is ``csrc/epa_hulls.cu``.

Both versions take the hit-first lane ``order`` and the device scalar
``n_act``: lane ``order[i]`` for ``i < n_act`` runs the cascade, and every
other lane passes its GJK status through with zero depth, normal and
iteration count.

The kernel runs a team of 16 or 32 lanes per hit (:func:`k2_team`: 16,
two hits a warp, where both hulls have at most :data:`NARROW_VERTICES`
vertices), the small tiers' polytope in shared memory:
:func:`k2_near_faces` keeps the largest tier whose block still lets as
many blocks an SM as K2's registers allow fit in the SM's shared memory
(:func:`k2_device` asks the card), and every larger tier runs in a slot of
a device pool (:func:`k2_pool`), which a team claims only when its ladder
reaches such a tier.  The pool has a slot for every K2 hit an SM can hold
at either width, on every SM, so it is allocated once a device and no host
read sizes it: at the default ladder on an H100, 16 warps an SM by K2's
registers (:func:`k2_resident_hits`), a 16-lane team keeps 48 faces in
shared memory and pools 88 and 208, a 32-lane team keeps 48 and 88.
:data:`TALLY`, set by :func:`k2_tally`, counts the hits that finish in
each tier and the pool's claims, and at 16 lanes the iterations that give
the pairing's efficiency (:func:`k2_pairing`); the pool's own counters
count, on the main path too, its claims (:func:`pool_claims`) and the
tiers K2's ladder carried a polytope into (:func:`tier_carries`): where a
tier stops for capacity by free faces, the next one goes on from its
polytope wherever the plain ladder's restart would repeat its iterations
bit for bit.  K13
(``fused_streamed.epa_hulls_big``) keeps its own rule: each tier in shared
memory where its store fits in a block (:func:`near_store_faces`), else in
a device store one a hit (:func:`face_stores`), sized by the one host read
of the hit count.

:func:`epa_cascade` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..config import GJKEPAConfig
from ..spans import span, spanned
from ..types import Status
from .fused_gjk import check_hulls, make_hull_support
from .lane_geom import P3, fsqrt, pdot, pmean4, pwhere, pzero_like

__all__ = ["EPARows", "epa_cascade", "epa_cascade_plain", "epa_phase",
           "run_cascade", "check_stages", "check_tensors", "near_store_faces",
           "far_store_faces", "face_stores", "K2Device", "k2_device",
           "k2_near_faces", "k2_pool", "k2_resident_hits", "k2_tally",
           "k2_pairing", "k2_smem_bytes", "k2_team", "pool_claims",
           "tier_carries", "LAUNCHES", "LAUNCHES_BY_TEAM", "STORE_READS",
           "TALLY", "NARROW_VERTICES", "BY_VISIBLE", "BY_FREE"]

# Kernel launches made by epa_cascade (CUDA tensors only), and the same by
# the lanes of a hit's team.
LAUNCHES = 0
LAUNCHES_BY_TEAM = {16: 0, 32: 0}
# Host reads of the hit count by face_stores, K13's (0 at the default
# ladder, whose every tier fits in K13's shared memory); K2 takes none.
STORE_READS = 0
# K2's tally while k2_tally is open: int32 (MAX_TIERS + 3,) on the card,
# the hits that finished in each tier, the pool's slot claims, then (16
# lanes a hit only) the EPA iterations the hits ran and, summed over the
# warps, the iterations of each warp's longer team.
TALLY: torch.Tensor | None = None

BIG = 3.4e38            # "no plane" distance (float32)
_MAXID = 256            # vertex ids < 4 + epa_max_iters <= 103 < 256
K_MAX = 16              # largest visible-set bound the kernel holds
MAX_TIERS = 4
# The tally's entries past the tiers' counts (epa_hulls.cu kTally*).
TALLY_CLAIMS, TALLY_ITERS, TALLY_LONGER = (MAX_TIERS, MAX_TIERS + 1,
                                           MAX_TIERS + 2)
# What stopped a tier for capacity (epa_phase's cause): more visible faces
# than its K, or more horizon edges than free faces.
BY_VISIBLE, BY_FREE = 1, 2
# Hulls of at most this many vertices a side take 16 lanes a hit: 16
# 4-vertex groups, one probe pass on 16 lanes as on 32.
NARROW_VERTICES = 64


def near_store_faces(stages, smem_bytes, limit: int) -> int:
    """The face capacity of K13's shared-memory store (and, with K2's
    share of an SM as the limit, K2's): the largest tier's whose block,
    ``smem_bytes(faces)`` bytes (``epa_hulls_big_smem_bytes`` or
    ``epa_hulls_smem_bytes`` on the card), fits in ``limit`` bytes of
    shared memory (0 when none does).  Every tier up to it keeps its faces
    in shared memory."""
    return max((c.epa_max_faces for c, _ in stages
                if smem_bytes(c.epa_max_faces) <= limit), default=0)


def far_store_faces(stages, near_faces: int) -> int:
    """The face capacity of K2's pool or K13's store in device memory: the
    largest tier's above ``near_faces`` (0 when every tier fits in shared
    memory)."""
    return max((c.epa_max_faces for c, _ in stages
                if c.epa_max_faces > near_faces), default=0)


def face_stores(stages, smem_bytes, n_act: torch.Tensor, dev: torch.device,
                near_faces: int | None = None):
    """K13's face stores: (near_faces, far_faces, the device store
    or None).  ``near_faces`` defaults to :func:`near_store_faces` over the
    kernel's block bytes ``smem_bytes``; the device store, one a hit,
    [rank][field][face], is sized by the hit count, the one host read of
    these paths, taken only where a tier needs it (``gjkepa.store_read``,
    counted in :data:`STORE_READS`)."""
    global STORE_READS
    if near_faces is None:
        near_faces = near_store_faces(stages, smem_bytes,
                                      _build.smem_limit(dev))
    far_faces = far_store_faces(stages, near_faces)
    if not far_faces:
        return near_faces, 0, None
    with span("gjkepa.store_read"):
        hits = int(n_act)
    STORE_READS += 1
    far = torch.empty((max(hits, 1),
                       _build.load().epa_scratch_words_per_face(), far_faces),
                      dtype=torch.float32, device=dev)
    return near_faces, far_faces, far


def k2_team(n1: int, n2: int) -> int:
    """The lanes of K2's team a hit for hulls of ``n1`` and ``n2``
    vertices: 16, two hits a warp, where both have at most
    :data:`NARROW_VERTICES`; else 32."""
    return 16 if max(n1, n2) <= NARROW_VERTICES else 32


class K2Device(NamedTuple):
    """What K2's store rule and pool observe on a card for one team width
    (``epa_hulls_blocks_per_sm(team, 0)``, then ``epa_hulls_device``)."""

    blocks: int      # K2 blocks an SM its registers allow
    hits: int        # hits a block: epa_hulls.cu's kPairs * 32 / team
    sm_bytes: int    # shared memory an SM (233,472 B on an H100)
    reserve: int     # shared memory reserved a block (1,024 B)
    slots: int       # pool slots an SM id: the most K2 hits an SM holds
    sm_ids: int      # SM ids (%nsmid)


@functools.cache
def k2_device(dev: torch.device, team: int) -> K2Device:
    """:class:`K2Device` of ``dev`` for teams of ``team`` lanes, asked once
    a device and width (the SM ids by a one-thread kernel, so the first
    call waits for the card)."""
    lib = _build.load()
    facts = (ctypes.c_int * (len(K2Device._fields) - 1))()
    with torch.cuda.device(dev):
        blocks = lib.epa_hulls_blocks_per_sm(team, 0)
        rc = lib.epa_hulls_device(team, facts) if blocks >= 0 else -blocks
    if rc != 0:
        raise RuntimeError(f"cannot read K2's occupancy on {dev} at {team} "
                           f"lanes a hit: CUDA error {rc}")
    return K2Device(blocks, *facts)


def k2_near_faces(stages, smem_bytes, blocks: int, sm_bytes: int,
                  reserve: int) -> int:
    """The face capacity of K2's shared-memory store: the largest tier's
    whose block, ``smem_bytes(faces)`` bytes (:func:`k2_smem_bytes` on the
    card) and ``reserve`` more, still lets ``blocks`` blocks (what K2's
    registers allow) fit in ``sm_bytes`` of an SM's shared memory; 0 when
    none does.  Every larger tier takes the pool (:func:`k2_pool`)."""
    share = sm_bytes // max(blocks, 1) - reserve
    return near_store_faces(stages, smem_bytes, share)


_POOLS: dict = {}
# The words before a pool's masks: its claims, then its carries.
_CLAIMS, _CARRIES, _HEADER = 0, 1, 2


def k2_pool(dev: torch.device, far_faces: int, facts: K2Device):
    """K2's pool for tiers of up to ``far_faces`` faces on ``dev``: (faces,
    mask), faces (slots, fields, far_faces) float32 with ``facts.slots``
    slots for each of ``facts.sm_ids`` SM ids (None at ``far_faces`` 0,
    where no tier is pooled), mask int32 (SM ids, ceil(slots / 32))
    zeroed, a set bit a slot a team holds, preceded by two int32 words,
    the pool's claim counter (:func:`pool_claims`) and its carry counter
    (:func:`tier_carries`), which every K2 launch is handed.  The
    slots are the same at either width, so both share one pool.  Made once
    a device and size, then the card waits for the zeroed mask, so that a
    launch on any stream finds it; nothing in it depends on the batch or
    the hit count."""
    key = (dev, far_faces, facts.slots, facts.sm_ids)
    if key not in _POOLS:
        words = _build.load().epa_scratch_words_per_face()
        faces = (torch.empty((facts.sm_ids * facts.slots, words, far_faces),
                             dtype=torch.float32, device=dev)
                 if far_faces else None)
        mask_words = facts.sm_ids * -(-facts.slots // 32)
        counted = torch.zeros(_HEADER + mask_words, dtype=torch.int32,
                              device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _POOLS[key] = (faces, counted[_HEADER:].view(facts.sm_ids, -1))
    return _POOLS[key]


def _pool_counter(word: int, dev: torch.device | None) -> int:
    """Word ``word`` of the header of each pool on ``dev`` (every device
    for None), summed: a host read."""
    return sum(int(mask.as_strided((1,), (1,), word))
               for key, (_, mask) in _POOLS.items()
               if dev is None or key[0] == dev)


def pool_claims(dev: torch.device | None = None) -> int:
    """The slots K2's teams have claimed in the pools on ``dev`` (every
    device for None) since each was made: the counter each claim adds to
    on the card, the first word before the pool's masks in their storage
    (the kernel's ``mask[-2]``).  A host read, so for readers after the
    fact; the main path never takes it."""
    return _pool_counter(_CLAIMS, dev)


def tier_carries(dev: torch.device | None = None) -> int:
    """The tiers K2's ladder has carried a polytope into on ``dev``
    (every device for None) since each pool was made: the counter each
    team adds them to on the card, the word just before the pool's masks
    (the kernel's ``mask[-1]``), handed to every K2 launch.  A host read,
    as :func:`pool_claims`."""
    return _pool_counter(_CARRIES, dev)


def k2_smem_bytes(team: int):
    """K2's block bytes by the faces of its shared store, at ``team``
    lanes a hit (``epa_hulls_smem_bytes`` on the card)."""
    return functools.partial(_build.load().epa_hulls_smem_bytes, team)


def k2_resident_hits(dev: torch.device, stages, team: int) -> int:
    """K2's hits an SM (its warps times 32 / ``team``) over ``stages`` on
    ``dev`` under :func:`k2_near_faces`, by the occupancy calculator."""
    lib = _build.load()
    facts = k2_device(dev, team)
    nbytes = k2_smem_bytes(team)
    near = k2_near_faces(stages, nbytes, facts.blocks, facts.sm_bytes,
                         facts.reserve)
    with torch.cuda.device(dev):
        blocks = lib.epa_hulls_blocks_per_sm(team, nbytes(near))
    if blocks < 0:
        raise RuntimeError(f"cannot read K2's occupancy on {dev}: CUDA error "
                           f"{-blocks}")
    return blocks * facts.hits


@contextlib.contextmanager
def k2_tally(dev: torch.device):
    """Count K2's launches on ``dev`` while open: yields :data:`TALLY`,
    zeroed, which each launch adds to (the main path passes none)."""
    global TALLY
    outer = TALLY
    TALLY = torch.zeros(MAX_TIERS + 3, dtype=torch.int32, device=dev)
    try:
        yield TALLY
    finally:
        TALLY = outer


def k2_pairing(tally) -> float | None:
    """The pairing's efficiency from a tally of 16-lane launches (a list):
    the hits' EPA iterations over twice the summed iterations of each
    warp's longer team, the share of a warp's iterations that ran both of
    its teams; None when no 16-lane hit ran."""
    longer = tally[TALLY_LONGER]
    return tally[TALLY_ITERS] / (2 * longer) if longer else None


class EPARows(NamedTuple):
    """Per-pair merged EPA output (the JAX kernel's rows 0-5)."""

    depth: torch.Tensor      # (B,) f32
    normal: torch.Tensor     # (B, 3) f32
    iters: torch.Tensor      # (B,) int32
    status: torch.Tensor     # (B,) int32


def _plane_of(a, b, c, interior: P3, epz):
    """Unit outward normal (vs `interior`) + origin distance of triangles
    with corner coordinate triples a/b/c ((A, M) tensors each); distance
    BIG when degenerate."""
    e1x, e1y, e1z = b[0] - a[0], b[1] - a[1], b[2] - a[2]
    e2x, e2y, e2z = c[0] - a[0], c[1] - a[1], c[2] - a[2]
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    nrm = fsqrt(nx * nx + ny * ny + nz * nz)
    ok = nrm > epz
    inv = 1.0 / torch.where(ok, nrm, 1.0)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ix, iy, iz = interior.x[:, None], interior.y[:, None], interior.z[:, None]
    out = (nx * (a[0] - ix) + ny * (a[1] - iy) + nz * (a[2] - iz)) >= 0.0
    sgn = torch.where(out, 1.0, -1.0)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
    d = nx * a[0] + ny * a[1] + nz * a[2]
    return nx, ny, nz, torch.where(ok, d, BIG)


_SEED_FACES = ((0, 1, 2), (0, 2, 3), (0, 1, 3), (1, 2, 3))   # ref :279-293


def epa_phase(support, simplex, active, cfg: GJKEPAConfig, n_faces: int,
              k_vis: int, cause: bool = False):
    """Compact-visible EPA over (A,) lanes; one cascade tier.

    `support` maps a P3 of (A,) directions to the Minkowski support P3.
    Face state is (A, F): corner coordinates (9), corner vertex ids (3),
    plane (n, d) and alive.  Returns (depth, normal P3, iters, status),
    and with ``cause`` what stopped each lane for capacity, (A,) int32: 0
    nothing, :data:`BY_VISIBLE` more than K visible faces, :data:`BY_FREE`
    more horizon edges than free faces (K2's ladder carries these on)."""
    eps = cfg.eps_coincide
    epz = cfg.eps_zero
    F, K = n_faces, k_vis
    n_lanes = active.shape[0]
    dev = simplex.device
    f32 = torch.float32
    s = tuple(P3(simplex[:, i, 0], simplex[:, i, 1], simplex[:, i, 2])
              for i in range(4))
    interior = pmean4(s)

    # corner coordinates (A, F, 9) as a, b, c xyz; ids (A, F, 3)
    cor = torch.zeros((n_lanes, F, 9), dtype=f32, device=dev)
    ids = torch.zeros((n_lanes, F, 3), dtype=torch.int32, device=dev)
    for f, tri in enumerate(_SEED_FACES):
        for slot, v in enumerate(tri):
            cor[:, f, 3 * slot] = s[v].x
            cor[:, f, 3 * slot + 1] = s[v].y
            cor[:, f, 3 * slot + 2] = s[v].z
            ids[:, f, slot] = v
    nx, ny, nz, dd = _plane_of(*(tuple(cor[:, :4, 3 * j + x] for x in range(3))
                                 for j in range(3)), interior, epz)
    pad = F - 4
    zpad = torch.zeros((n_lanes, pad), dtype=f32, device=dev)
    nx, ny, nz = (torch.cat([t, zpad], 1) for t in (nx, ny, nz))
    dd = torch.cat([dd, torch.full((n_lanes, pad), BIG, dtype=f32,
                                   device=dev)], 1)
    alive = torch.arange(F, device=dev)[None, :].expand(n_lanes, F) < 4

    f_iota = torch.arange(F, device=dev)[None, :]
    k_iota = torch.arange(K, device=dev)[None, :]
    nv = torch.full((n_lanes,), 4, dtype=torch.int32, device=dev)
    it = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    done = ~active
    depth = torch.zeros(n_lanes, dtype=f32, device=dev)
    nout = pzero_like(depth)
    status = torch.full((n_lanes,), Status.HIT_EPA_CAP, dtype=torch.int32,
                        device=dev)
    why = torch.zeros(n_lanes, dtype=torch.int32, device=dev)

    while True:
        run = ~done & (it < cfg.epa_max_iters)
        if not bool(run.any()):
            break
        # -- min face / probe direction --------------------------------------
        dvals = torch.where(alive, dd, BIG)
        kmin = torch.argmin(dvals, dim=1)                       # first min
        d_min = torch.gather(dvals, 1, kmin[:, None])[:, 0]
        star = f_iota == kmin[:, None]
        all_deg = d_min >= BIG * 0.5
        d_min = torch.where(all_deg, 0.0, d_min)
        direction = P3(*(torch.gather(t, 1, kmin[:, None])[:, 0]
                         for t in (nx, ny, nz)))
        direction = pwhere(all_deg, pzero_like(d_min), direction)

        w = support(direction)
        gain = pdot(w, direction) - d_min
        dup = torch.zeros_like(alive)
        for slot in range(3):
            same = alive
            for x, wx in enumerate(w):
                same = same & (torch.abs(cor[:, :, 3 * slot + x]
                                         - wx[:, None]) < eps)
            dup = dup | same
        converged = (gain < eps) | dup.any(dim=1)

        # -- visible set -----------------------------------------------------
        beyond = (nx * w.x[:, None] + ny * w.y[:, None]
                  + nz * w.z[:, None]) > dd + epz
        visible = alive & (beyond | star) & (dd < BIG * 0.5)
        visible = visible | (alive & star)
        nvis = visible.sum(dim=1)
        over_k = nvis > K

        # -- compact the first K visible faces (index order) -----------------
        src = torch.argsort((~visible).to(torch.int8), dim=1,
                            stable=True)[:, :K]
        valid_k = k_iota < nvis[:, None]                         # (A, K)
        sids = torch.gather(ids, 1, src[:, :, None].expand(-1, -1, 3))
        scor = torch.gather(cor, 1, src[:, :, None].expand(-1, -1, 9))

        # -- edge rows, e-major over the 3 edges then the K slots ------------
        eu = torch.cat([sids[:, :, e] for e in range(3)], 1)       # (A, 3K)
        ev = torch.cat([sids[:, :, (e + 1) % 3] for e in range(3)], 1)
        ecu = torch.cat([scor[:, :, 3 * e:3 * e + 3] for e in range(3)], 1)
        ecv = torch.cat([scor[:, :, 3 * ((e + 1) % 3):3 * ((e + 1) % 3) + 3]
                         for e in range(3)], 1)                  # (A, 3K, 3)
        evalid = torch.cat([valid_k] * 3, 1)

        # -- horizon: undirected key unique among valid edges ----------------
        ukey = torch.where(evalid, torch.minimum(eu, ev) * _MAXID
                           + torch.maximum(eu, ev), -1)
        same = ((ukey[:, :, None] == ukey[:, None, :])
                & evalid[:, :, None] & evalid[:, None, :])
        horizon = evalid & (same.sum(dim=2) == 1)
        n_new = horizon.sum(dim=1)

        free = ~alive | visible
        n_free = free.sum(dim=1)
        # capacity failures (a larger tier fixes them) vs intrinsic
        # degeneracy (no expansion exists)
        cant_cap = ~converged & (over_k | (n_new > n_free))
        cant_deg = ~converged & ~cant_cap & ((n_new == 0) | all_deg)
        cant = cant_cap | cant_deg
        do_ins = run & ~(converged | cant)

        # -- r-th free face (ascending index) <- r-th horizon edge -----------
        rank_f = torch.cumsum(free.to(torch.int32), dim=1) - 1
        hord = torch.argsort((~horizon).to(torch.int8), dim=1, stable=True)
        src_edge = torch.gather(hord, 1, rank_f.clamp(0, 3 * K - 1))
        write = free & (rank_f < n_new[:, None]) & do_ins[:, None]

        na = torch.gather(ecu, 1, src_edge[:, :, None].expand(-1, -1, 3))
        nb = torch.gather(ecv, 1, src_edge[:, :, None].expand(-1, -1, 3))
        nc = torch.stack([w.x, w.y, w.z], 1)[:, None, :].expand(-1, F, -1)
        pnx, pny, pnz, pdd = _plane_of(
            tuple(na[:, :, x] for x in range(3)),
            tuple(nb[:, :, x] for x in range(3)),
            tuple(nc[:, :, x] for x in range(3)), interior, epz)
        new_ids = torch.stack([torch.gather(eu, 1, src_edge),
                               torch.gather(ev, 1, src_edge),
                               nv[:, None].expand(-1, F)], 2)
        w3 = write[:, :, None]
        cor = torch.where(w3, torch.cat([na, nb, nc], 2), cor)
        ids = torch.where(w3, new_ids, ids)
        nx = torch.where(write, pnx, nx)
        ny = torch.where(write, pny, ny)
        nz = torch.where(write, pnz, nz)
        dd = torch.where(write, pdd, dd)
        alive = torch.where(do_ins[:, None], (alive & ~visible) | write, alive)
        nv = torch.where(do_ins, nv + 1, nv)
        it = torch.where(run, it + 1, it)
        done = done | (run & (converged | cant))
        depth = torch.where(run, d_min, depth)
        nout = pwhere(run, direction, nout)
        status = torch.where(run & converged, Status.HIT, status)
        status = torch.where(run & cant_deg, Status.HIT_EPA_DEGENERATE, status)
        status = torch.where(run & cant_cap, Status.HIT_EPA_CAPACITY, status)
        if cause:
            why = torch.where(run & cant_cap, torch.where(
                over_k, BY_VISIBLE, BY_FREE).to(torch.int32), why)

    zero = torch.zeros_like(depth)
    depth = torch.where(active, depth, zero)
    nout = pwhere(active, nout, pzero_like(zero))
    status = torch.where(active, status, 0)
    if cause:
        return depth, nout, it, status, torch.where(active, why, 0)
    return depth, nout, it, status


def run_cascade(support_of, simplex, stages):
    """The tier ladder over (A,) lanes, all of them active (_epa_cascade).

    Tier 1 runs every lane; each later tier re-runs only the lanes the
    previous one stopped for capacity.  ``support_of(idx)`` is the support
    over lanes ``idx`` ((R,) int64), or over all A lanes for None.  Returns
    (depth, normal P3, iters, status), a surviving capacity status still
    HIT_EPA_CAPACITY."""
    ones = torch.ones(simplex.shape[0], dtype=torch.bool, device=simplex.device)
    (c0, k0), rest = stages[0], stages[1:]
    depth, normal, it, status = epa_phase(support_of(None), simplex, ones, c0,
                                          c0.epa_max_faces, k0)
    for c, k in rest:
        retry = (status == Status.HIT_EPA_CAPACITY).nonzero()[:, 0]
        if retry.numel() == 0:
            break
        d2, n2, i2, s2 = epa_phase(support_of(retry), simplex[retry],
                                   ones[retry], c, c.epa_max_faces, k)
        depth[retry], it[retry], status[retry] = d2, i2, s2
        normal = P3(*(t.index_put((retry,), v) for t, v in zip(normal, n2)))
    return depth, normal, it, status


def check_stages(stages) -> None:
    """Raise on a tier ladder the kernel does not hold."""
    if not 1 <= len(stages) <= MAX_TIERS:
        raise ValueError(f"need 1..{MAX_TIERS} EPA tiers, got {len(stages)}")
    shared = {(c.eps_coincide, c.eps_zero, c.epa_max_iters) for c, _ in stages}
    if len(shared) != 1:
        raise ValueError("EPA tiers differ in more than face capacity and "
                         f"visible-set bound: {sorted(shared)}")
    for c, k in stages:
        if not 1 <= k <= K_MAX:
            raise ValueError(f"visible-set bound {k} outside 1..{K_MAX}")
        if c.epa_max_faces < 4:
            raise ValueError(f"face capacity {c.epa_max_faces} < 4")
        if 4 + c.epa_max_iters >= _MAXID:
            raise ValueError(f"epa_max_iters {c.epa_max_iters} overflows "
                             f"the {_MAXID}-id edge keys")


def check_tensors(ref: torch.Tensor, **tensors) -> None:
    """Raise on a tensor the kernels do not take: each keyword is (tensor,
    dtype, shape), and each must lie on ``ref``'s device, contiguous."""
    for name, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_inputs(p1, p2, simplex, gjk_status, order, n_act):
    check_hulls(p1, p2)
    b = p1.shape[0]
    check_tensors(p1, simplex=(simplex, torch.float32, (b, 4, 3)),
                  gjk_status=(gjk_status, torch.int32, (b,)),
                  order=(order, torch.int32, (b,)),
                  n_act=(n_act, torch.int32, ()))


def _passthrough(gjk_status, b, dev) -> EPARows:
    return EPARows(torch.zeros(b, dtype=torch.float32, device=dev),
                   torch.zeros((b, 3), dtype=torch.float32, device=dev),
                   torch.zeros(b, dtype=torch.int32, device=dev),
                   gjk_status.clone())


def epa_cascade_plain(p1, p2, simplex, gjk_status, order, n_act,
                      stages) -> EPARows:
    """Plain PyTorch version of K2 (lane-vectorised masked tensor code).

    Runs tier 1 over lanes ``order[:n_act]``; each later tier re-runs only
    the lanes the previous one stopped for capacity (``_epa_cascade``)."""
    _check_inputs(p1, p2, simplex, gjk_status, order, n_act)
    check_stages(stages)
    b = p1.shape[0]
    out = _passthrough(gjk_status, b, p1.device)
    lanes = order[:int(n_act)].long()
    if lanes.numel() == 0:
        return out
    q1, q2 = p1[lanes], p2[lanes]

    def support_of(idx):
        if idx is None:
            return make_hull_support(q1, q2)
        return make_hull_support(q1[idx], q2[idx])

    depth, normal, it, status = run_cascade(support_of, simplex[lanes], stages)
    # a capacity exit from the final tier is degenerate to callers
    status = torch.where(status == Status.HIT_EPA_CAPACITY,
                         Status.HIT_EPA_DEGENERATE, status)
    out.depth[lanes] = depth
    out.normal[lanes] = torch.stack([normal.x, normal.y, normal.z], 1)
    out.iters[lanes] = it
    out.status[lanes] = status
    return out


def _epa_cascade_cuda(p1, p2, simplex, gjk_status, order, n_act, stages,
                      near_faces: int | None = None,
                      team: int | None = None) -> EPARows:
    """K2 on teams of ``team`` lanes (:func:`k2_team` when None) with a
    shared-memory store of ``near_faces`` faces a team
    (:func:`k2_near_faces` when None) and, for the larger tiers, the
    device's pool (:func:`k2_pool`); no host read."""
    global LAUNCHES
    lib = _build.load()
    b, n1, n2 = p1.shape[0], p1.shape[1], p2.shape[1]
    dev = p1.device
    cfg = stages[0][0]
    if team is None:
        team = k2_team(n1, n2)
    facts = k2_device(dev, team)
    if near_faces is None:
        near_faces = k2_near_faces(stages, k2_smem_bytes(team),
                                   facts.blocks, facts.sm_bytes,
                                   facts.reserve)
    far_faces = far_store_faces(stages, near_faces)
    faces, mask = k2_pool(dev, far_faces, facts)
    tally = TALLY if TALLY is not None and TALLY.device == dev else None
    tier_f = (ctypes.c_int * MAX_TIERS)(*[c.epa_max_faces for c, _ in stages])
    tier_k = (ctypes.c_int * MAX_TIERS)(*[k for _, k in stages])
    out = _passthrough(gjk_status, b, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = _build.ptr
        rc = lib.epa_hulls_launch(
            ptr(p1), ptr(p2), ptr(simplex), ptr(order), ptr(n_act),
            ptr(out.depth), ptr(out.normal), ptr(out.iters), ptr(out.status),
            None if faces is None else ptr(faces), ptr(mask),
            None if tally is None else ptr(tally), b, n1, n2, len(stages),
            tier_f, tier_k, near_faces, far_faces, facts.slots, team,
            cfg.eps_coincide, cfg.eps_zero, cfg.epa_max_iters,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"epa_hulls kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_TEAM[team] += 1
    return out


@spanned("gjkepa.k2")
def epa_cascade(p1, p2, simplex, gjk_status, order, n_act,
                stages: list[tuple[GJKEPAConfig, int]]) -> EPARows:
    """K2: the EPA tier ladder over the first ``n_act`` lanes of ``order``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/epa_hulls.cu``), which raises if it cannot build or launch."""
    _check_inputs(p1, p2, simplex, gjk_status, order, n_act)
    check_stages(stages)
    if p1.device.type == "cpu":
        return epa_cascade_plain(p1, p2, simplex, gjk_status, order, n_act,
                                 stages)
    if p1.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {p1.device}")
    return _epa_cascade_cuda(p1, p2, simplex, gjk_status, order, n_act,
                             stages)
