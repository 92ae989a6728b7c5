"""K2's and K13's face stores by size, in plain Python, at their byte
boundaries, and K7's and K10's store, which always fits.

K2 (csrc/epa_hulls.cu) keeps a tier's polytope in shared memory while its
block still lets as many blocks an SM as K2's registers allow fit in the
SM's shared memory, and every larger tier in a slot of a device pool
(``fused_epa.k2_near_faces``, ``far_store_faces``, ``k2_pool``).  The rule
takes the kernel's byte count as a function (``epa_hulls_smem_bytes`` on
the card), the register-bound blocks an SM, the SM's shared memory and the
reserve a block as arguments (``epa_hulls_device`` on the card), so it is
held here without a card, against stand-ins of them: a block of H hits
(P warps, 32 / TW teams a warp), each 1,152 B of scratch and 68 B a face,
16 warps an SM by the registers (111 a thread: a scheduler's quarter of
the register file holds 4 such warps), and an H100's 233,472 B an SM,
1,024 B reserved a block (232,448 B a block at most).  The pool's size,
K2's choice of team width by the hulls' sizes and its launch arguments
are held through a stand-in of the library on CPU tensors.  K13
(csrc/epa_hulls_big.cu) keeps each tier in shared memory where its own
store fits in a block (``near_store_faces``) and in a device store
otherwise: one polytope a block of 8 warps, the probe exchange and one
warp's scratch beside the faces (``epa_hulls_big_smem_bytes`` on the
card).  K7 (csrc/epa_shapes.cu)
keeps its one store in shared memory and has no device store: the shape
ladder (``fused_shapes.shape_stages``) is 48 faces at every
``epa_max_iters``, so a block of W warps takes W * (1,152 + 68 * 48) B
(``epa_shapes_smem_bytes`` on the card).  K10 (csrc/epa_hull_shape.cu)
runs the same kernel (csrc/epa_polish_warp.cuh) over the mixed path's
ladder, the same ``shape_stages``, with its own block size
(``epa_hull_shape_smem_bytes``).  K12's staged-or-scanned choice
is its C launcher's (``gjk_hulls_big_staged``), held on the card.  K1
(csrc/gjk_hulls.cu) stages a block's hulls in shared memory while its
tile fits ``fused_gjk.STAGED_BUDGET`` (``fused_gjk.stages`` over
``gjk_hulls_staged_bytes`` on the card): held here against a stand-in of
that count, with the teams of K1, K8 and K9, which the staging leaves as
they were.
"""

import contextlib
import types

import pytest
import torch

from gjkepa_tpu_torch import GJKEPAConfig
from gjkepa_tpu_torch.ops import (fused_distance, fused_epa, fused_gjk,
                                  fused_hull_shapes, fused_shapes)
from gjkepa_tpu_torch.ops.fused import cascade_plan

H100_LIMIT = 232_448     # an H100 block's opt-in shared memory
H100_SM = 233_472        # an H100 SM's shared memory
RESERVE = 1_024          # shared memory reserved a block
K2_WARPS = 16            # K2's warps an SM by its registers (111 a thread)
K2_WARP_LANES = 32


def k2_bytes(hits):
    """A stand-in of K2's block bytes, a block of ``hits`` teams."""
    return lambda faces: hits * (1152 + 68 * faces)


def _k2_stores(stages, smem_bytes, blocks, sm_bytes=H100_SM):
    near = fused_epa.k2_near_faces(stages, smem_bytes, blocks, sm_bytes,
                                   RESERVE)
    far = fused_epa.far_store_faces(stages, near)
    return near, far, ["shared" if c.epa_max_faces <= near else "pool"
                       for c, _ in stages]


def _stores(stages, smem_bytes, limit):
    near = fused_epa.near_store_faces(stages, smem_bytes, limit)
    far = fused_epa.far_store_faces(stages, near)
    return near, far, ["shared" if c.epa_max_faces <= near else "device"
                       for c, _ in stages]


def _ladder(*faces):
    cfg = GJKEPAConfig.for_f32()
    return [(cfg.replace(epa_max_faces=f), 16) for f in faces]


@pytest.mark.parametrize("pairs", [1, 2, 4, 8])
def test_k2_default_ladder_at_the_byte_boundary(pairs):
    """At the blocks an SM K2's registers allow (16 warps, P a block, a
    hit a warp) the default ladder (F = 48, 88, 208) keeps 48 and 88
    faces in shared memory and pools 208; on an SM whose shared memory
    gives each block exactly a tier's bytes that tier stays shared, and
    one byte less sends it, and only it and the larger ones, to the
    pool."""
    stages = cascade_plan(GJKEPAConfig.for_f32())
    assert [c.epa_max_faces for c, _ in stages] == [48, 88, 208]
    nbytes, blocks = k2_bytes(pairs), K2_WARPS // pairs
    assert _k2_stores(stages, nbytes, blocks) == (
        88, 208, ["shared", "shared", "pool"])

    def sm(faces):     # the SM whose share a block is that tier's block
        return blocks * (nbytes(faces) + RESERVE)
    assert _k2_stores(stages, nbytes, blocks, sm(208)) == (
        208, 0, ["shared"] * 3)
    assert _k2_stores(stages, nbytes, blocks, sm(208) - 1) == (
        88, 208, ["shared", "shared", "pool"])
    assert _k2_stores(stages, nbytes, blocks, sm(88)) == (
        88, 208, ["shared", "shared", "pool"])
    assert _k2_stores(stages, nbytes, blocks, sm(88) - 1) == (
        48, 208, ["shared", "pool", "pool"])
    assert _k2_stores(stages, nbytes, blocks, sm(48) - 1) == (
        0, 208, ["pool"] * 3)


@pytest.mark.parametrize("team, hits, near, pooled", [
    (32, 1, 88, [208]), (16, 2, 48, [88, 208])])
def test_k2_hits_a_block_set_the_shared_tiers(team, hits, near, pooled):
    """At 16 one-warp blocks an SM on an H100 (233,472 B, 1,024 B reserved
    a block: 13,568 B a block's share), a block of one 32-lane hit keeps
    48 and 88 faces in shared memory (7,136 B) and a block of two 16-lane
    hits keeps 48 (2 x 4,416 = 8,832 B; 88 would take 14,272 B), the
    larger tiers in the pool."""
    stages = cascade_plan(GJKEPAConfig.for_f32())
    assert hits == K2_WARP_LANES // team
    nbytes = k2_bytes(hits)
    got_near, far, where = _k2_stores(stages, nbytes, K2_WARPS)
    assert (got_near, far) == (near, 208)
    assert [c.epa_max_faces for (c, _), w in zip(stages, where)
            if w == "pool"] == pooled
    share = H100_SM // K2_WARPS - RESERVE
    assert nbytes(near) <= share < nbytes(min(pooled))
    assert nbytes(48) == (8832 if hits == 2 else 4416)


@pytest.mark.parametrize("blocks, near", [
    (1, 208), (2, 208), (7, 208), (14, 208), (15, 88), (16, 88), (18, 88),
    (20, 88), (24, 88),
    (28, 88), (29, 48), (32, 48)])
def test_k2_rule_follows_the_register_bound(blocks, near):
    """A ladder that fits whole under the register bound (up to 14 one-warp
    blocks an SM: 14 x (15,296 + 1,024) B <= 233,472) keeps every tier in
    shared memory and pools nothing, as the rule it replaced; past it the
    208-face tier takes the pool (88 faces fit up to 28 blocks, 48 faces
    beyond)."""
    stages = cascade_plan(GJKEPAConfig.for_f32())
    got_near, far, where = _k2_stores(stages, k2_bytes(1), blocks)
    assert got_near == near
    assert far == (0 if near == 208 else 208)
    assert where.count("pool") == (near < 208) + (near < 88)
    assert blocks * (k2_bytes(1)(near) + RESERVE) <= H100_SM


def test_k2_runs_a_store_past_shared_memory_in_device_memory():
    """A face capacity past a block's shared memory (F = 4096: 279,680 B a
    warp) is no refusal: it takes the pool, and a ladder mixing it with
    small tiers keeps those in shared memory."""
    nbytes = k2_bytes(1)
    assert nbytes(4096) == 279_680 > H100_LIMIT
    assert _k2_stores(_ladder(4096), nbytes, K2_WARPS) == (0, 4096, ["pool"])
    assert _k2_stores(_ladder(8, 16, 4096), nbytes, K2_WARPS) == (
        16, 4096, ["shared", "shared", "pool"])
    assert _k2_stores(_ladder(8, 16, 4096), nbytes, 1) == (
        16, 4096, ["shared", "shared", "pool"])


@pytest.mark.parametrize("limit", [0, 20_000, 60_000])
@pytest.mark.parametrize("faces", [(48, 88, 208), (8, 16, 208), (208,),
                                   (208, 48, 88), (88, 88, 4096),
                                   (4, 600, 700, 4096)],
                         ids=lambda f: "-".join(map(str, f)))
def test_k2_a_tier_is_shared_exactly_when_its_store_fits(faces, limit):
    """Whatever the ladder's order, a tier keeps its faces in shared memory
    exactly when its block fits in a block's share of the SM (``limit``
    bytes, the reserve aside, at K2's blocks an SM), and the pool holds
    the largest of the others (none when every tier fits)."""
    stages = _ladder(*faces)
    nbytes = k2_bytes(2)
    blocks = K2_WARPS // 2
    near, far, where = _k2_stores(stages, nbytes, blocks,
                                  blocks * (limit + RESERVE))
    assert where == ["shared" if nbytes(f) <= limit else "pool"
                     for f in faces]
    assert far == max((f for f in faces if nbytes(f) > limit), default=0)
    assert near == max((f for f in faces if nbytes(f) <= limit), default=0)


# An H100's K2 facts as epa_hulls_device reports them at 16 lanes a hit
# (blocks by the registers, hits a block, shared memory an SM, reserve,
# slots an SM id, SM ids); the slots, 32 blocks an SM x 2 hits, are the
# same at 32 lanes.
H100_K2 = fused_epa.K2Device(16, 2, H100_SM, RESERVE, 64, 132)


class K2Library:
    """A stand-in of the built library's K2 entry points: the device facts
    given (the hits a block by the team width asked), K2's block bytes
    and face words, and a launch that records its arguments."""

    def __init__(self, facts):
        self.facts = facts
        self.launches = []

    def epa_hulls_blocks_per_sm(self, team, smem):
        return self.facts.blocks    # the registers bind these blocks

    def epa_hulls_device(self, team, out):
        for i, v in enumerate(self.facts._replace(hits=32 // team)[1:]):
            out[i] = v
        return 0

    def epa_hulls_smem_bytes(self, team, faces):
        return 32 // team * (1152 + 68 * faces)

    def epa_scratch_words_per_face(self):
        return 17

    def epa_hulls_launch(self, *args):
        self.launches.append(args)
        return 0


@pytest.fixture
def k2_library(monkeypatch):
    """K2's wrapper over CPU tensors with the library stood in (no card):
    each test gives its facts and reads the launches."""
    def use(facts):
        lib = K2Library(facts)
        monkeypatch.setattr(fused_epa._build, "load", lambda: lib)
        return lib
    monkeypatch.setattr(fused_epa, "_POOLS", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    fused_epa.k2_device.cache_clear()
    yield use
    fused_epa.k2_device.cache_clear()


def _k2_inputs(b, hits, n=24, n2=None):
    g = torch.Generator().manual_seed(b)
    return (torch.randn(b, n, 3, generator=g),
            torch.randn(b, n if n2 is None else n2, 3, generator=g),
            torch.randn(b, 4, 3, generator=g),
            torch.ones(b, dtype=torch.int32),
            torch.arange(b, dtype=torch.int32),
            torch.tensor(hits, dtype=torch.int32))


# positions of epa_hulls_launch's arguments
POOL_FACES, POOL_MASK, TALLY, B_ARG = 9, 10, 11, 12
NEAR, FAR, PER_SM, TEAM = 18, 19, 20, 21


@pytest.mark.parametrize("facts", [H100_K2, H100_K2._replace(sm_ids=144),
                                   H100_K2._replace(slots=128),
                                   H100_K2._replace(slots=40, sm_ids=8)],
                         ids=["h100", "144-ids", "p2", "40-slots"])
def test_k2_pool_depends_on_the_card_alone(k2_library, facts):
    """K2's pool holds a slot of 208 faces for every K2 hit an SM can hold
    on every SM id (p2: a card holding two-warp blocks of 16-lane hits),
    with a zeroed mask word for each 32 slots an SM id: the same tensors,
    made once, for every batch size and hit count, at either team width
    (24 vertices: 16 lanes, 48 faces shared; 96: 32 lanes, 88 faces), and
    no host read of the hit count."""
    lib = k2_library(facts)
    stages = cascade_plan(GJKEPAConfig.for_f32())
    reads = fused_epa.STORE_READS
    sizes = ((64, 0), (64, 64), (256, 17), (4096, 4096), (1, 1))
    for n in (24, 96):
        for b, hits in sizes:
            fused_epa._epa_cascade_cuda(*_k2_inputs(b, hits, n), stages)
    assert fused_epa.STORE_READS == reads
    ((faces, mask),) = fused_epa._POOLS.values()
    assert faces.shape == (facts.sm_ids * facts.slots, 17, 208)
    assert mask.shape == (facts.sm_ids, -(-facts.slots // 32))
    assert mask.dtype == torch.int32 and not mask.any()
    assert [a[B_ARG] for a in lib.launches] == [b for b, _ in sizes] * 2
    for i, a in enumerate(lib.launches):
        team, near = (16, 48) if i < len(sizes) else (32, 88)
        assert a[POOL_FACES].value == faces.data_ptr()
        assert a[POOL_MASK].value == mask.data_ptr()
        assert (a[NEAR], a[FAR], a[PER_SM], a[TEAM]) == (
            near, 208, facts.slots, team)
        assert a[TALLY] is None


def test_k2_pool_slots_count_hits_not_warps(k2_library):
    """Launches at 16 and at 32 lanes a hit share one pool whose slots an
    SM id are the card's most K2 hits an SM (64 on an H100: 32 blocks of
    two 16-lane hits), twice the 32 one-hit warps an SM can hold."""
    lib = k2_library(H100_K2)
    stages = cascade_plan(GJKEPAConfig.for_f32())
    for n in (24, 96, 64, 65):
        fused_epa._epa_cascade_cuda(*_k2_inputs(128, 100, n), stages)
    ((faces, mask),) = fused_epa._POOLS.values()
    assert faces.shape == (132 * 64, 17, 208) and mask.shape == (132, 2)
    assert [(a[TEAM], a[PER_SM]) for a in lib.launches] == [
        (16, 64), (32, 64), (16, 64), (32, 64)]
    assert {a[POOL_FACES].value for a in lib.launches} == {faces.data_ptr()}
    assert [fused_epa.k2_device(torch.device("cpu"), t).hits
            for t in (16, 32)] == [2, 1]


@pytest.mark.parametrize("n1, n2, team", [
    (4, 4, 16), (8, 8, 16), (24, 24, 16), (64, 64, 16), (24, 64, 16),
    (65, 24, 32), (24, 65, 32), (96, 96, 32), (2048, 2048, 32)])
def test_k2_team_by_the_hulls_sizes(k2_library, n1, n2, team):
    """The wrapper launches 16 lanes a hit where both hulls have at most 64
    vertices and 32 above, by the hulls' shapes alone, and counts the
    launch under its width."""
    k2_library(H100_K2)
    assert fused_epa.k2_team(n1, n2) == team
    stages = cascade_plan(GJKEPAConfig.for_f32())
    before = dict(fused_epa.LAUNCHES_BY_TEAM)
    fused_epa._epa_cascade_cuda(*_k2_inputs(8, 8, n1, n2), stages)
    after = fused_epa.LAUNCHES_BY_TEAM
    assert {t: after[t] - before[t] for t in after} == {
        16: int(team == 16), 32: int(team == 32)}


def _pool_passed(lib, blocks, near, n):
    """Whether K2's launch over ``n``-vertex hulls at ``blocks`` blocks an
    SM (and ``near`` faces forced, or the rule's) was handed the pool's
    face store; it is handed the pool's masks and counters either way."""
    lib.facts = H100_K2._replace(blocks=blocks)
    stages = cascade_plan(GJKEPAConfig.for_f32())
    fused_epa._epa_cascade_cuda(*_k2_inputs(32, 32, n), stages,
                                near_faces=near)
    (args,) = lib.launches
    pooled = args[POOL_FACES] is not None
    ((faces, mask),) = fused_epa._POOLS.values()
    assert args[POOL_MASK].value == mask.data_ptr()
    assert (faces is not None) == pooled
    assert args[FAR] == (208 if pooled else 0)
    return pooled


@pytest.mark.parametrize("blocks, near, pooled", [
    (14, None, False), (16, None, True), (16, 208, False), (16, 0, True),
    (1, 48, True)])
def test_k2_pool_only_where_a_tier_needs_it(k2_library, blocks, near,
                                            pooled):
    """No face store is made or passed while every tier fits in K2's share
    of shared memory (the rule at 14 one-hit blocks an SM at 32 lanes, or
    a store of 208 faces forced), only the pool's masks and counters; a
    tier past it passes the pool's face store too."""
    assert _pool_passed(k2_library(H100_K2), blocks, near, 96) == pooled


@pytest.mark.parametrize("blocks, near, pooled", [
    (7, None, False), (8, None, True), (16, None, True), (16, 208, False),
    (16, 0, True), (1, 48, True)])
def test_k2_pool_only_where_a_tier_needs_it_at_16_lanes(k2_library, blocks,
                                                         near, pooled):
    """The same at 16 lanes a hit, two hits a block: every tier fits up to
    7 blocks an SM (7 x (2 x 15,296 + 1,024) <= 233,472 B), not at 8."""
    assert _pool_passed(k2_library(H100_K2), blocks, near, 24) == pooled


def test_k2_tally_is_passed_only_while_open(k2_library):
    """``k2_tally`` hands K2 an int32 (MAX_TIERS + 3) tally on the launch's
    device while open, and none after (the main path's)."""
    lib = k2_library(H100_K2)
    stages = cascade_plan(GJKEPAConfig.for_f32())
    inputs = _k2_inputs(32, 32)
    with fused_epa.k2_tally(torch.device("cpu")) as tally:
        fused_epa._epa_cascade_cuda(*inputs, stages)
    fused_epa._epa_cascade_cuda(*inputs, stages)
    assert tally.shape == (fused_epa.MAX_TIERS + 3,)
    assert tally.dtype == torch.int32
    assert lib.launches[0][TALLY].value == tally.data_ptr()
    assert lib.launches[1][TALLY] is None and fused_epa.TALLY is None


@pytest.mark.parametrize("iters, longer, want", [
    (200, 100, 1.0), (150, 100, 0.75), (100, 100, 0.5), (0, 0, None)])
def test_k2_pairing_reads_the_tally(iters, longer, want):
    """The pairing's efficiency is the hits' iterations over twice the
    summed longer team's: 1 when every warp's teams ran as long, 0.5
    when one of each ran alone; none without a 16-lane hit."""
    tally = [0] * (fused_epa.MAX_TIERS + 3)
    tally[fused_epa.TALLY_ITERS] = iters
    tally[fused_epa.TALLY_LONGER] = longer
    assert fused_epa.k2_pairing(tally) == want


def k7_bytes(warps):
    """A stand-in of K7's block bytes, built with W = ``warps`` warps."""
    return lambda faces: warps * (1152 + 68 * faces)


def test_k7_ladder_is_48_faces_at_every_cap():
    """shape_stages gives two tiers of 48 faces (K = 8, then 16) at every
    epa_max_iters of 1..64, capped at 16 iterations, and no EPA at 0."""
    cfg = GJKEPAConfig.for_f32()
    assert fused_shapes.shape_stages(cfg.replace(epa_max_iters=0)) == []
    for iters in range(1, 65):
        stages = fused_shapes.shape_stages(cfg.replace(epa_max_iters=iters))
        assert [(c.epa_max_faces, k) for c, k in stages] == [(48, 8), (48, 16)]
        assert {c.epa_max_iters for c, _ in stages} == {min(iters, 16)}
        fused_epa.check_stages(stages)


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_k7_block_fits_shared_memory(warps):
    """At each block size swept (1, 2 and 4 warps), K7's block at the
    shape ladder's 48 faces fits an H100's opt-in shared memory, and
    within the default 48 KB: no opt-in, no refusal on the main path."""
    cfg = GJKEPAConfig.for_f32()
    f_max = max(c.epa_max_faces for c, _ in fused_shapes.shape_stages(cfg))
    need = k7_bytes(warps)(f_max)
    assert need == warps * 4416
    assert need <= 48 * 1024 < H100_LIMIT


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_k10_block_fits_shared_memory(warps):
    """At each block size measured for K10 (1, 2 and 4 warps), K10's
    block at the mixed path's ladder (48 faces) fits within the default
    48 KB of shared memory: no opt-in, no refusal on the main path."""
    stages = fused_shapes.shape_stages(GJKEPAConfig.for_f32())
    f_max = max(c.epa_max_faces for c, _ in stages)
    assert f_max == 48
    need = k7_bytes(warps)(f_max)       # the same kernel and layout as K7
    assert need == warps * 4416
    assert need <= 48 * 1024 < H100_LIMIT


# K13's block: the probe exchange of 8 warps (144 B), one warp's scratch
# (1,152 B) and 68 B a face of its near store.
K13_FIXED = 144 + 1152


def k13_bytes(faces):
    """A stand-in of K13's block bytes (``epa_hulls_big_smem_bytes``)."""
    return K13_FIXED + 68 * faces


def test_k13_default_ladder_needs_no_device_store():
    """At an H100's limit the default ladder (F = 48, 88, 208) keeps every
    tier in K13's shared memory: no device store, so no host read of
    n_act."""
    stages = cascade_plan(GJKEPAConfig.for_f32())
    near = fused_epa.near_store_faces(stages, k13_bytes, H100_LIMIT)
    assert near == 208 and fused_epa.far_store_faces(stages, near) == 0
    assert k13_bytes(208) == 15_440


@pytest.mark.parametrize("faces", [48, 208, 3392])
def test_k13_store_split_at_the_byte_boundary(faces):
    """A last tier of ``faces`` faces is shared at its block's bytes and one
    face's bytes more, and goes to device memory one face's bytes below
    (the earlier tiers stay shared while they fit)."""
    cfg = GJKEPAConfig.for_f32()
    stages = cascade_plan(cfg.replace(epa_max_faces=faces))
    last = stages[-1][0].epa_max_faces
    assert last == max(208, faces)
    need = k13_bytes(last)
    for limit, where in ((need, "shared"), (need + 68, "shared"),
                         (need - 68, "device"), (need - 1, "device")):
        near, far, placed = _stores(stages, k13_bytes, limit)
        assert placed[-1] == where
        assert far == (last if where == "device" else 0)
        assert near == max((c.epa_max_faces for c, _ in stages
                            if k13_bytes(c.epa_max_faces) <= limit),
                           default=0)


def test_k13_tiers_past_shared_memory_take_the_device_store():
    """The largest face capacity whose K13 block fits an H100 is 3,399; a
    ladder whose last tier is 3,400 or 4,096 faces keeps 48 and 88 in
    shared memory and the last tier in device memory."""
    assert k13_bytes(3399) <= H100_LIMIT < k13_bytes(3400)
    cfg = GJKEPAConfig.for_f32()
    for faces in (3400, 4096):
        stages = cascade_plan(cfg.replace(epa_max_faces=faces))
        assert _stores(stages, k13_bytes, H100_LIMIT) == (
            88, stages[-1][0].epa_max_faces, ["shared", "shared", "device"])


def k1_words(n):
    """A staged hull's words: 3n rounded up to 16-B words, then to an odd
    number of them."""
    return 4 * (((3 * n + 3) // 4) | 1)


def k1_bytes(n1, n2, pairs=32):
    """A stand-in of K1's staged tile (``gjk_hulls_staged_bytes``): the
    mbarrier (16 B) and a block's 32 pairs, both hulls each."""
    return 4 * (4 + pairs * (k1_words(n1) + k1_words(n2)))


@pytest.mark.parametrize("shape", [(8, 8), (23, 23), (24, 24), (64, 64),
                                   (64, 23), (128, 128), (148, 148),
                                   (149, 149), (256, 256), (1024, 1024),
                                   (2048, 2048)],
                         ids=lambda s: f"{s[0]} x {s[1]}")
def test_k1_stages_at_the_byte_boundary(shape):
    """A tile is staged at its own bytes and one byte more, and streamed
    one byte below them."""
    n1, n2 = shape
    need = k1_bytes(n1, n2)
    assert fused_gjk.stages(n1, n2, k1_bytes, need)
    assert fused_gjk.stages(n1, n2, k1_bytes, need + 1)
    assert not fused_gjk.stages(n1, n2, k1_bytes, need - 1)


def test_k1_budget_stages_the_small_hulls():
    """At STAGED_BUDGET (two blocks an H100 SM) K1 stages hulls up to 148
    vertices (c2's 64-vertex tile is 50,192 B) and streams them from 149
    on; the staged team is 2 up to 64 vertices a hull in a batch of
    16,384 pairs or more, else 8."""
    def staged(n1, n2):
        return fused_gjk.stages(n1, n2, k1_bytes)
    assert fused_gjk.STAGED_BUDGET == 115_712
    assert 2 * (fused_gjk.STAGED_BUDGET + 1024) == 233_472  # an H100 SM
    assert k1_bytes(64, 64) == 50_192 and k1_bytes(148, 148) == 113_680
    assert all(staged(n, n) for n in (4, 8, 23, 24, 63, 64, 65, 128, 148))
    assert not any(staged(n, n) for n in (149, 256, 512, 1024, 2048))
    assert staged(8, 280) and not staged(8, 290)
    assert [fused_gjk.staged_team(65536, n, n)
            for n in (4, 24, 64, 65, 148)] == [2, 2, 2, 8, 8]
    assert fused_gjk.staged_team(16384, 64, 8) == 2
    assert fused_gjk.staged_team(16383, 64, 8) == 8
    assert fused_gjk.staged_team(4096, 24, 24) == 8
    assert fused_gjk.staged_team(65536, 8, 65) == 8
    assert set(fused_gjk.STAGED_TEAMS) == {2, 8}


def test_k1_staged_hulls_are_aligned_and_spread_over_banks():
    """A staged hull of 1 to 2,048 vertices starts 16-B aligned, holds its
    3n words, and the eight pairs of a quarter warp (teams of 2, or of 4)
    start on eight disjoint groups of four banks (an odd number of 16-B
    words apart)."""
    for n in range(1, 2049):
        w = k1_words(n)
        assert w % 4 == 0 and (w // 4) % 2 == 1 and 3 * n <= w < 3 * n + 8
        assert len({(p * w) % 32 for p in range(8)}) == 8


def test_team_rules_are_unchanged():
    """K1's streamed, K8's and K9's teams by hull size, 8 to 2,048
    vertices, are what they were before K1 staged its hulls: 4 threads up
    to 64 vertices, 8 up to 256, 16 up to 512, then 32 (K8's restart: its
    own team)."""
    assert fused_gjk.TEAMS == (4, 8, 16, 32)
    for n in range(8, 2049):
        want = 4 if n <= 64 else 8 if n <= 256 else 16 if n <= 512 else 32
        assert fused_gjk.team_size(n, n) == want
        assert fused_gjk.team_size(n, 8) == want
        assert fused_distance.team_size(n, n, restart=False) == want
        assert fused_distance.team_size(n, n, restart=True) \
            == fused_distance.RESTART_TEAM
        assert fused_hull_shapes.team_size(n) == want
