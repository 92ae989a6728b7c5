"""The port's CUDA kernels against their plain versions on an NVIDIA GPU.

Marked ``cuda``; each test skips without a CUDA device.  The machine with
the card has no JAX, so run this file without the JAX conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider

Tolerances: hit and status exact, separation 1e-5, iteration counts on
>= 99.5% of lanes (both versions round every op on their own: the kernels
are built with --fmad=false) hold K1 in ``test_k1_matches_plain_on_card``;
every other check is bit for bit.  K5, K6a and K6b: rows bit for bit on
c3 in natural and shuffled order, a batch of 4,093 pairs, the 16 kind
pairs, all-cylinder pairs (every pair in GJK) and spheres (no pair in
GJK), K6a's inactive rows included; their wrappers launch one kernel
each.  K7 and K10 (a warp a hit over
epa_warp.cuh, one kernel in epa_polish_warp.cuh): rows bit for bit at
epa_max_iters 1, 16 and 64, K10 also on hulls of 21-24 vertices and on
masked hulls.  K8 and K9 (a team of threads a pair over K11's support):
rows bit for bit at every team size, K8's two-phase equal to one pass, K9
in the dispatch's order and in the caller's.  K2, K12 and K13 (the warp
kernels over K11's support): rows bit for bit against their plain
versions on every input, the tie fixture, both of K2's face stores and
both of K12's hull sources included.  K2 at 16 and 32 lanes a hit, each
bit for bit against the plain version and the 32-lane kernel: its store
rule over the card's own occupancy facts at each width; K2 on 16,384 hits
with its tiers as the rule places them and all in its device pool (more
hits than slots), and two launches in flight on two streams: bit for
bit, the tally summing to the hits, the pool's slot masks clear after; an
odd hit count (the last warp's second team idle), warps whose two teams
run 1 and many EPA iterations, and the wrapper's width by the hulls'
sizes (16 at 24 and 64 vertices, 32 at 96).  K1 at each team size and K2 and
K13 over a tier ladder forced to overflow into their retries, at vertex
counts with each remainder mod 4: bit for bit; K1 without the broadphase
at each team size, K13 with its tiers in shared memory, device memory or
both, and past shared memory: bit for bit.  K1's staged kernel (a block's
hulls in shared memory) at 8-256 vertices, n = 3 mod 4 and one side of
each, with and without the broadphase, at each of its teams, on a ragged
last block: bit for bit against the plain version and the streamed
kernel; ``gjk_hulls`` stages at 24 and 64 vertices and streams at 256
and 1,024, as ``STAGED_LAUNCHES`` counts.  ``fused_gjkepa_hulls`` without
the broadphase on both routes against its CPU run (discrete fields exact,
depth, normal and distance within 1e-5); the portable distance in chunks
equal to the unchunked call, bit for bit.  The portable path (torch
code, no kernel): ``gjkepa_batch`` and ``collide_shapes_batch`` on the
card against their CPU runs, with the tolerances of their comparison with
the JAX package; ``collide_supports`` without ``active`` on the card.  The
manifolds (torch code) on the card against their CPU run: masks on >=
99.9% of lanes, and on those lanes the kept points as sets and the depths
within 1e-5, row by row on >= 99% of them (the 4-point reduction's first
maxima over ties, which a last-bit difference of the centroid sums and
atan2 between the devices can move).  One sim step on the card (K1/K2
over box corners) against the same branch on the CPU through their
plain versions and against the CPU's portable step, at
``tests/test_torch_sim.py``'s tolerance.  Sharding and the sanitizer: the
fused query over 4 entries of the card bit for bit against the unsharded
query, one K1 and one K2 a shard; the checked fused query bit for bit
against the unchecked one, and a poisoned input named with the CPU's
check and lanes.  The bench's c3 config (seed 0) through its timer on the
card: its keys and c3's hits.
"""

import ctypes

import numpy as np
import pytest
import torch

from gjkepa_tpu_torch import _build
from gjkepa_tpu_torch import (GJKEPAConfig, ShapeBatch,
                              fused_gjk_distance_hulls,
                              fused_gjkepa_hull_shapes, fused_gjkepa_hulls,
                              fused_gjkepa_shapes, gjk_distance_batch,
                              gjk_distance_shapes_batch, gjkepa_batch_fused)
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops import fused_distance as fd
from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
from gjkepa_tpu_torch.ops import fused_streamed as fst
from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
from gjkepa_tpu_torch.ops import fused_shapes as fs
from gjkepa_tpu_torch.ops.fused import (cascade_plan, hit_first_order,
                                        mask_to_padding)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _hulls(rng, b, n, spread=0.8, scale=1.0):
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, n, 1))
    v = (v + rng.normal(size=(b, 1, 3)) * spread) * scale
    return v.astype(np.float32)


def _rows_equal(k, p, active=None):
    """Bit-equal rows; GJK rows' simplex on the ``active`` lanes only."""
    if active is not None:
        k, p = ((*r[:4], r.simplex[active]) for r in (k, p))
    return all(torch.equal(x, y) for x, y in zip(k, p))


def test_k1_matches_plain_on_card(dev):
    rng = np.random.default_rng(1)
    p1, p2 = (torch.from_numpy(_hulls(rng, 2048, 32)).to(dev) for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    n0 = fused_gjk.LAUNCHES
    gk = fused_gjk.gjk_hulls(p1, p2, cfg)
    gp = fused_gjk.gjk_hulls_plain(p1, p2, cfg)
    assert fused_gjk.LAUNCHES == n0 + 1
    assert torch.equal(gk.hit, gp.hit) and torch.equal(gk.status, gp.status)
    assert float((gk.iters == gp.iters).float().mean()) >= 0.995
    assert float((gk.sep - gp.sep).abs().max()) <= 1e-5


def _k2_widths_equal(args, team, want, **variant):
    """K2 at ``team`` lanes a hit and at 32, each bit for bit against
    ``want`` (the plain rows): two launches."""
    n0 = fused_epa.LAUNCHES
    ek = fused_epa._epa_cascade_cuda(*args, team=team, **variant)
    e32 = fused_epa._epa_cascade_cuda(*args, team=32, **variant)
    assert fused_epa.LAUNCHES == n0 + 2
    return _rows_equal(ek, want) and _rows_equal(e32, want)


@pytest.mark.parametrize("team", [16, 32])
def test_k2_matches_plain_on_card(dev, team):
    rng = np.random.default_rng(2)
    p1 = torch.from_numpy(_hulls(rng, 1024, 24, spread=0.0, scale=2.0)).to(dev)
    p2 = torch.from_numpy(_hulls(rng, 1024, 24, spread=0.2, scale=0.5)).to(dev)
    cfg = GJKEPAConfig.for_f32()
    g = fused_gjk.gjk_hulls(p1, p2, cfg)
    order, n_act = hit_first_order(g.hit)
    st = cascade_plan(cfg)
    args = (p1, p2, g.simplex, g.status, order, n_act, st)
    ep = fused_epa.epa_cascade_plain(*args)
    assert int(n_act) > 500
    assert _k2_widths_equal(args, team, ep)
    n0 = fused_epa.LAUNCHES
    assert _rows_equal(fused_epa.epa_cascade(*args), ep)
    assert fused_epa.LAUNCHES == n0 + 1


def test_main_path_stays_on_the_card(dev):
    c = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                  for z in (-.5, .5)], np.float32)
    offsets = np.array([0.3, 0.7, 1.2, 2.5] * 64, np.float32)
    p1 = torch.from_numpy(np.stack([c] * len(offsets))).to(dev)
    p2 = torch.from_numpy(c[None] + np.stack(
        [offsets, 0 * offsets, 0 * offsets], 1)[:, None]).to(dev)
    r = gjkepa_batch_fused(p1, p2)
    assert all(t.device == p1.device for t in r)
    hit = offsets < 1.0
    assert torch.equal(r.hit.cpu(), torch.from_numpy(hit))
    np.testing.assert_allclose(r.depth.cpu().numpy()[hit], 1.0 - offsets[hit],
                               atol=1e-5)


def _shape_rows(pairs, dev):
    a, b = (ShapeBatch.from_numpy(*p, device=dev) for p in pairs)
    retired, _ = fs.retirement(a, b)
    return a.packed(), b.packed(), retired


def _shape_pairs(name):
    if name == "mixed16":
        return fixtures.mixed16_pairs(64, 5)
    if name == "dense_cyl":     # every pair active
        rng = np.random.default_rng(3)
        return (fixtures.kind_batch(3, 1024, rng, spread=0.2),
                fixtures.kind_batch(3, 1024, rng, spread=0.2))
    if name == "spheres":       # no GJK lanes: n_act = 0
        rng = np.random.default_rng(4)
        return (fixtures.kind_batch(0, 1000, rng),
                fixtures.kind_batch(0, 1000, rng))
    if name == "c3_shuffled":
        return tuple(fixtures.c3_shuffled(0, 4096)[:2])
    if name == "c3_odd":        # B % 4 != 0
        return tuple(tuple(x[:4093] for x in side)
                     for side in fixtures.c3_pairs(0, 4096))
    return fixtures.c3_pairs(0, 4096)


@pytest.mark.parametrize("name", ["mixed16", "dense_cyl", "c3", "c3_shuffled",
                                  "c3_odd", "spheres"])
def test_shape_kernels_match_plain_on_card(dev, name):
    sa, sb, retired = _shape_rows(_shape_pairs(name), dev)
    cfg = GJKEPAConfig.for_f32()
    n0 = dict(fs.LAUNCHES)
    # K5
    ck = fs.cf_shapes(sa, sb, retired, cfg)
    cp = fs.cf_shapes_plain(sa, sb, retired, cfg)
    assert _rows_equal(ck, cp)
    # K6a over the compacted GJK lanes: every row, the inactive ones too
    order, n_act = hit_first_order(cp.act)
    gk = fs.gjk_sub_shapes(sa, sb, retired, order, n_act, cfg)
    gp = fs.gjk_sub_shapes_plain(sa, sb, retired, order, n_act, cfg)
    assert _rows_equal(gk, gp)
    # K6b over every lane (its simplex on the GJK lanes), with the
    # closed-form channel
    hk = fs.gjk_shapes(sa, sb, retired, cfg)
    hp = fs.gjk_shapes_plain(sa, sb, retired, cfg)
    assert _rows_equal(hk, hp, cp.act)
    assert all(torch.equal(x, y) for x, y in zip(hk[5:], hp[5:]))
    # K7 over the GJK hits
    st = fs.shape_stages(cfg)
    epa = hp.hit & ~hp.final
    order, n_act = hit_first_order(epa)
    args = (sa, sb, hp.simplex, hp.status, hp.cf_depth, hp.cf_normal, order,
            n_act, st)
    ek, ep = fs.epa_shapes(*args), fs.epa_shapes_plain(*args)
    assert (int(n_act) > 0) == (name != "spheres")
    assert _rows_equal(ek, ep)
    assert {k: fs.LAUNCHES[k] - n0[k] for k in n0} == {
        "cf_shapes": 1, "gjk_sub_shapes": 1, "gjk_shapes": 1, "epa_shapes": 1}


def test_shape_wrappers_launch_one_kernel_on_card(dev):
    """K6a and K6b write every row themselves: each wrapper launches its
    kernel and nothing else (no zero fills)."""
    from gjkepa_tpu_torch.profile import kernel_launches
    sa, sb, retired = _shape_rows(_shape_pairs("c3"), dev)
    cfg = GJKEPAConfig.for_f32()
    order, n_act = hit_first_order(fs.cf_shapes(sa, sb, retired, cfg).act)
    for fn in (lambda: fs.gjk_sub_shapes(sa, sb, retired, order, n_act, cfg),
               lambda: fs.gjk_shapes(sa, sb, retired, cfg),
               lambda: fs.cf_shapes(sa, sb, retired, cfg)):
        assert kernel_launches(fn) == 1


@pytest.mark.parametrize("n_act", [0, 17, 4093])
def test_k6a_writes_every_row_for_any_order(dev, n_act):
    """K6a writes pair order[i]'s row for every i, GJK below ``n_act`` and
    the inactive row above, so with any permutation and count no row is
    left as it was: rows filled with NaN beforehand all equal plain's (a
    pair below ``n_act`` that its GJK test finds inactive keeps a zero
    simplex, where the plain version leaves its probes)."""
    sa, sb, retired = _shape_rows(_shape_pairs("c3_odd"), dev)
    cfg = GJKEPAConfig.for_f32()
    b = sa.shape[0]
    order = torch.randperm(b, generator=torch.Generator().manual_seed(n_act))
    order = order.to(dev, torch.int32)
    count = torch.tensor(n_act, dtype=torch.int32, device=dev)
    want = fs.gjk_sub_shapes_plain(sa, sb, retired, order, count, cfg)
    nan = float("nan")
    rows = fs.GJKRows(torch.ones(b, dtype=torch.bool, device=dev),
                      torch.full((b,), 7, dtype=torch.int32, device=dev),
                      torch.full((b,), 7, dtype=torch.int32, device=dev),
                      torch.full((b,), nan, device=dev),
                      torch.full((b, 4, 3), nan, device=dev))
    ptr = _build.ptr
    _build.launch("gjk_sub_shapes", dev, {"gjk_sub_shapes": 0},
                  *(ptr(t) for t in (sa, sb, retired, order, count)),
                  fs.INIT_DIRS.ctypes.data_as(ctypes.c_void_p),
                  *(ptr(t) for t in rows), b, *fs.gjk_args(cfg))
    torch.cuda.synchronize()
    probes = torch.zeros(b, dtype=torch.bool, device=dev)
    probes[order[:n_act].long()] = True
    probes &= ~fs.cf_shapes_plain(sa, sb, retired, cfg).act
    assert _rows_equal(rows, want, ~probes)
    assert not bool(rows.simplex[probes].any())


def test_shape_path_sort_hits_agree_on_card(dev):
    a, b = (ShapeBatch.from_numpy(*p, device=dev)
            for p in fixtures.c3_pairs(1, 8192))
    r1 = fused_gjkepa_shapes(a, b, sort_hits=True)
    r2 = fused_gjkepa_shapes(a, b, sort_hits=False)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    assert all(t.device == a.kind.device for t in r1)


def test_k8_matches_plain_on_card(dev):
    rng = np.random.default_rng(4)
    p1, p2 = (torch.from_numpy(_hulls(rng, 4096, 12, spread=2.0)).to(dev)
              for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    n0 = fd.LAUNCHES["distance_hulls"]
    k = fd.distance_hulls(p1, p2, cfg, 64)
    p = fd.distance_hulls_plain(p1, p2, cfg, 64)
    assert fd.LAUNCHES["distance_hulls"] == n0 + 1
    assert _rows_equal(k, p)
    two = fused_gjk_distance_hulls(p1, p2, cfg=cfg)
    one = fused_gjk_distance_hulls(p1, p2, cfg=cfg, two_phase=False)
    assert fd.LAUNCHES["distance_hulls"] == n0 + 4
    for x, y in zip(two, one):
        assert torch.equal(x, y)


def test_k9_k10_match_plain_on_card(dev):
    """K9 at every team size and K10 on a quarter of c3b: rows bit for bit
    against their plain versions, one launch each through the wrappers."""
    hulls, shapes = fixtures.c3b_pairs()
    p1 = torch.from_numpy(hulls[:4096]).to(dev)
    sb = ShapeBatch.from_numpy(*(x[::4] for x in shapes),
                               device=dev).packed()
    cfg = GJKEPAConfig.for_f32()
    env = fh.hull_shape_retirement(p1, sb, cfg)
    order, _ = hit_first_order(~env.retired)
    n0 = dict(fh.LAUNCHES)
    gk = fh.gjk_hull_shape(p1, sb, env.retired, order, cfg)
    gp = fh.gjk_hull_shape_plain(p1, sb, env.retired, order, cfg)
    lanes = gp.status != 0          # the lanes that ran GJK
    assert _rows_equal(gk, gp, lanes)
    order, n_act = hit_first_order(gp.hit)
    args = (p1, sb, gp.simplex, gp.status, order, n_act, fs.shape_stages(cfg))
    ek, ep = fh.epa_hull_shape(*args), fh.epa_hull_shape_plain(*args)
    assert int(n_act) > 500
    assert _rows_equal(ek, ep)
    assert {k: fh.LAUNCHES[k] - n0[k] for k in n0} == {
        "gjk_hull_shape": 1, "epa_hull_shape": 1}
    for team in fused_gjk.TEAMS:
        got = fh._gjk_hull_shape_cuda(p1, sb, env.retired, order, cfg, team)
        assert _rows_equal(got, gp, lanes), team


def test_mixed_path_sort_hits_agree_on_card(dev):
    hulls, shapes = fixtures.c3b_pairs()
    p1 = torch.from_numpy(hulls).to(dev)
    sh = ShapeBatch.from_numpy(*shapes, device=dev)
    r1 = fused_gjkepa_hull_shapes(p1, sh, sort_hits=True)
    r2 = fused_gjkepa_hull_shapes(p1, sh, sort_hits=False)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    assert all(t.device == p1.device for t in r1)


def _big_rows_match(p1, p2, cfg):
    """K12 and K13 rows bit for bit against their plain versions."""
    active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
    gk = fst.gjk_hulls_big(p1, p2, active, cfg)
    gp = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
    # the simplex of the lanes that ran GJK (the plain version leaves
    # probes in the others, the kernel zeros)
    assert _rows_equal(gk, gp, active)
    order, n_act = hit_first_order(gp.hit)
    args = (p1, p2, gp.simplex, gp.status, order, n_act, cascade_plan(cfg))
    assert _rows_equal(fst.epa_hulls_big(*args), fst.epa_hulls_big_plain(*args))
    return gp


def test_k12_k13_match_plain_on_card(dev):
    rng = np.random.default_rng(6)
    p1, p2 = (torch.from_numpy(_hulls(rng, 512, 2600)).to(dev)
              for _ in range(2))
    n0 = dict(fst.LAUNCHES)
    _big_rows_match(p1, p2, GJKEPAConfig.for_f32())
    assert {k: fst.LAUNCHES[k] - n0[k] for k in n0} == {
        "gjk_hulls_big": 1, "epa_hulls_big": 1}


def test_k12_k13_keep_the_first_maximum_on_ties(dev):
    """Support probes that tie between copies of a box corner one ulp apart,
    in one thread's scan and across threads: bit for bit."""
    p1, p2 = (torch.from_numpy(x).to(dev)
              for x in fixtures.tie_pairs(512, 2100, 2100))
    _big_rows_match(p1, p2, GJKEPAConfig.for_f32())


def test_large_hull_path_launches_on_card(dev):
    """One call with n1 + n2 > 4096 launches K12 and K13 once each and K1
    and K2 never; boolean mode launches K12 only."""
    rng = np.random.default_rng(7)
    p1, p2 = (torch.from_numpy(_hulls(rng, 256, 2049, 0.3)).to(dev)
              for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    for c, want in ((cfg, 1), (cfg.replace(epa_max_iters=0), 0)):
        n0 = (dict(fst.LAUNCHES), fused_gjk.LAUNCHES, fused_epa.LAUNCHES)
        r = gjkepa_batch_fused(p1, p2, cfg=c)
        assert {k: fst.LAUNCHES[k] - n0[0][k] for k in n0[0]} == {
            "gjk_hulls_big": 1, "epa_hulls_big": want}
        assert (fused_gjk.LAUNCHES, fused_epa.LAUNCHES) == n0[1:]
        assert int(r.hit.sum()) > 0
        assert all(bool(torch.isfinite(t).all()) for t in r
                   if t.is_floating_point())


@pytest.mark.parametrize("team", fused_gjk.TEAMS)
@pytest.mark.parametrize("case", [("boolean", 4096, 64), ("deep", 2048, 24),
                                  ("boolean", 4096, 63), ("deep", 2048, 23)],
                         ids=lambda c: f"{c[0]} {c[1]} x {c[2]}")
def test_k1_teams_are_bit_equal_to_plain(dev, case, team):
    """K1 at every team size, rows bit for bit against the plain version;
    at 63 and 23 vertices (not a multiple of 4) K11 takes its scalar
    scan."""
    kind, b, n = case
    rng = np.random.default_rng(8)
    cfg = GJKEPAConfig.for_f32()
    if kind == "boolean":
        p1, p2 = (torch.from_numpy(_hulls(rng, b, n)).to(dev)
                  for _ in range(2))
        cfg = cfg.replace(epa_max_iters=0)
    else:
        p1 = torch.from_numpy(_hulls(rng, b, n, 0.0, 2.0)).to(dev)
        p2 = torch.from_numpy(_hulls(rng, b, n, 0.2, 0.5)).to(dev)
    n0 = fused_gjk.LAUNCHES
    gk = fused_gjk._gjk_hulls_cuda(p1, p2, cfg, team)
    gp = fused_gjk.gjk_hulls_plain(p1, p2, cfg)
    assert fused_gjk.LAUNCHES == n0 + 1
    assert int(gp.hit.sum()) > 0
    assert _rows_equal(gk, gp, gp.status != 0)


@pytest.mark.parametrize("team", fused_gjk.TEAMS)
@pytest.mark.parametrize("case", [("c2", 4096, 64), ("deep", 2048, 24),
                                  ("c2", 4096, 63)],
                         ids=lambda c: f"{c[0]} {c[1]} x {c[2]}")
def test_k1_without_the_broadphase_is_bit_equal_to_plain(dev, case, team):
    """K1 with the broadphase off at every team size: every pair runs GJK,
    rows bit for bit against the plain version (the simplex on every
    lane); at 63 vertices K11 takes its scalar scan."""
    kind, b, n = case
    rng = np.random.default_rng(16)
    cfg = GJKEPAConfig.for_f32()
    if kind == "c2":
        p1, p2 = (torch.from_numpy(_hulls(rng, b, n, 1.5)).to(dev)
                  for _ in range(2))
    else:
        p1, p2 = (t.to(dev) for t in _deep(rng, b, n))
    n0 = fused_gjk.LAUNCHES
    gk = fused_gjk._gjk_hulls_cuda(p1, p2, cfg, team, use_broadphase=False)
    gp = fused_gjk.gjk_hulls_plain(p1, p2, cfg, use_broadphase=False)
    assert fused_gjk.LAUNCHES == n0 + 1
    assert bool((gp.status != 0).all()) and int(gp.hit.sum()) > 0
    assert _rows_equal(gk, gp)
    on = fused_gjk.gjk_hulls_plain(p1, p2, cfg)
    if kind == "c2":
        assert int((on.status == 0).sum()) > 100


def test_fused_hulls_without_the_broadphase_on_card(dev):
    """fused_gjkepa_hulls(use_broadphase=False) on both routes launches K1
    and K2, or K12 and K13, once each, and equals the same call through the
    plain versions on the CPU: discrete fields exact, depth and distance
    within 1e-5 (PERF.md's rule for the fused paths)."""
    rng = np.random.default_rng(17)
    for b, n in ((2048, 32), (64, 2049)):
        p1, p2 = (torch.from_numpy(_hulls(rng, b, n, 1.5)) for _ in range(2))
        n0 = {"gjk_hulls": fused_gjk.LAUNCHES, "epa_hulls": fused_epa.LAUNCHES,
              **fst.LAUNCHES}
        r = fused_gjkepa_hulls(p1.to(dev), p2.to(dev), use_broadphase=False)
        n1 = {"gjk_hulls": fused_gjk.LAUNCHES, "epa_hulls": fused_epa.LAUNCHES,
              **fst.LAUNCHES}
        route = (("gjk_hulls_big", "epa_hulls_big") if fst.streams(n, n)
                 else ("gjk_hulls", "epa_hulls"))
        assert {k: n1[k] - n0[k] for k in n0} == {k: int(k in route)
                                                   for k in n0}
        w = fused_gjkepa_hulls(p1, p2, use_broadphase=False)
        assert int((w.status == 0).sum()) == 0 and int(w.hit.sum()) > 0
        for f in ("hit", "status", "gjk_iters", "epa_iters"):
            assert torch.equal(getattr(r, f).cpu(), getattr(w, f)), f
        for f in ("depth", "distance", "normal"):
            assert float((getattr(r, f).cpu() - getattr(w, f)).abs().max()) \
                <= 1e-5, f


def _k1_tile(n1, n2, pairs=32):
    """K1's staged tile in bytes: the mbarrier (16 B), then the block's 32
    pairs' two hulls, each at an odd number of 16-B words."""
    def words(n):
        return 4 * (((3 * n + 3) // 4) | 1)
    return 4 * (4 + pairs * (words(n1) + words(n2)))


# (n1, n2): a multiple of 4 (bulk copies), n = 3 mod 4 (the block's loads,
# K11's scalar scan), one of each (both copies in one block), and 256
# vertices, past STAGED_BUDGET (197,648 B: staged only when asked)
K1_STAGED_SHAPES = ((8, 8), (23, 23), (24, 24), (63, 63), (64, 64),
                    (256, 256), (64, 23))


@pytest.mark.parametrize("use_broadphase", [True, False],
                         ids=["sphere", "no sphere"])
@pytest.mark.parametrize("shape", K1_STAGED_SHAPES,
                         ids=lambda s: f"{s[0]} x {s[1]}")
def test_k1_staged_is_bit_equal_to_plain_and_streamed(dev, shape,
                                                      use_broadphase):
    """K1's staged kernel (the hulls of a block's 32 pairs in shared
    memory) at each of STAGED_TEAMS, on 2,045 pairs (the last block is
    ragged): rows bit for bit against the plain version (the simplex on
    the lanes that ran GJK) and against the streamed kernel at the rule's
    team (every row); each launch counted once, the staged ones in
    STAGED_LAUNCHES too."""
    n1, n2 = shape
    rng = np.random.default_rng(22)
    p1 = torch.from_numpy(_hulls(rng, 2045, n1)).to(dev)
    p2 = torch.from_numpy(_hulls(rng, 2045, n2)).to(dev)
    cfg = GJKEPAConfig.for_f32().replace(epa_max_iters=0)
    assert _build.load().gjk_hulls_staged_bytes(n1, n2) == _k1_tile(n1, n2)
    assert _k1_tile(n1, n2) <= _build.smem_limit(dev)
    gp = fused_gjk.gjk_hulls_plain(p1, p2, cfg, use_broadphase)
    ran = gp.status != 0
    assert int(gp.hit.sum()) > 0
    if use_broadphase:
        assert int((~ran).sum()) > 0
    n0 = (fused_gjk.LAUNCHES, fused_gjk.STAGED_LAUNCHES)
    gm = fused_gjk._gjk_hulls_cuda(p1, p2, cfg, fused_gjk.team_size(n1, n2),
                                   use_broadphase)
    assert _rows_equal(gm, gp, ran)
    for team in fused_gjk.STAGED_TEAMS:
        gs = fused_gjk._gjk_hulls_cuda(p1, p2, cfg, team, use_broadphase,
                                       staged=True)
        assert _rows_equal(gs, gp, ran), team
        assert _rows_equal(gs, gm), team
    k = len(fused_gjk.STAGED_TEAMS)
    assert (fused_gjk.LAUNCHES, fused_gjk.STAGED_LAUNCHES) == (
        n0[0] + 1 + k, n0[1] + k)


def test_k1_takes_the_staged_kernel_by_shape(dev):
    """gjk_hulls stages the hulls at 24 and 64 vertices (a block's tile is
    50,192 B at 64, inside STAGED_BUDGET) and streams them at 256
    (197,648 B) and 1,024: STAGED_LAUNCHES grows with LAUNCHES only at the
    first two, and every call equals the plain version."""
    rng = np.random.default_rng(23)
    cfg = GJKEPAConfig.for_f32().replace(epa_max_iters=0)
    lib = _build.load()
    assert _k1_tile(64, 64) == 50_192 and _k1_tile(256, 256) == 197_648
    for n, staged in ((24, True), (64, True), (256, False), (1024, False)):
        assert (lib.gjk_hulls_staged_bytes(n, n)
                <= fused_gjk.STAGED_BUDGET) == staged
        p1, p2 = (torch.from_numpy(_hulls(rng, 1024, n)).to(dev)
                  for _ in range(2))
        n0 = (fused_gjk.LAUNCHES, fused_gjk.STAGED_LAUNCHES)
        gk = fused_gjk.gjk_hulls(p1, p2, cfg)
        assert (fused_gjk.LAUNCHES, fused_gjk.STAGED_LAUNCHES) == (
            n0[0] + 1, n0[1] + staged)
        gp = fused_gjk.gjk_hulls_plain(p1, p2, cfg)
        assert _rows_equal(gk, gp, gp.status != 0)


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_chunked_distance_on_card(dev, chunk):
    """gjk_distance_batch and gjk_distance_shapes_batch in chunks equal the
    unchunked call on the card, bit for bit."""
    rng = np.random.default_rng(18)
    p1, p2 = (torch.from_numpy(_hulls(rng, 4096, 24, 1.5)).to(dev)
              for _ in range(2))
    want = gjk_distance_batch(p1, p2, cfg=GJKEPAConfig.for_f32())
    got = gjk_distance_batch(p1, p2, cfg=GJKEPAConfig.for_f32(),
                             chunk_size=chunk)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int((~want.intersecting).sum()) > 100
    a, b = (ShapeBatch.from_numpy(*p, device=dev)
            for p in fixtures.mixed16_pairs(64, 3))
    want = gjk_distance_shapes_batch(a, b, cfg=GJKEPAConfig.for_f32())
    got = gjk_distance_shapes_batch(a, b, cfg=GJKEPAConfig.for_f32(),
                                    chunk_size=chunk // 4)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("n", [2600, 2601, 2602, 2603])
def test_k13_overflow_ladder_is_bit_equal_to_plain(dev, n):
    """K13 over a ladder whose first tiers overflow (F=8, K=2; F=16, K=4;
    F=208, K=16), so the retries run over the same shared-memory store:
    rows bit for bit against the plain cascade, at each vertex count mod 4
    (K11 reads 2600 as float4 groups, the others by its scalar scan)."""
    rng = np.random.default_rng(9)
    p1, p2 = (torch.from_numpy(_hulls(rng, 512, n, 0.3)).to(dev)
              for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    ladder = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((8, 2), (16, 4), (208, 16))]
    active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
    g = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
    order, n_act = hit_first_order(g.hit)
    args = (p1, p2, g.simplex, g.status, order, n_act, ladder)
    ep = fst.epa_hulls_big_plain(*args)
    n0 = fst.LAUNCHES["epa_hulls_big"]
    ek = fst.epa_hulls_big(*args)
    assert fst.LAUNCHES["epa_hulls_big"] == n0 + 1
    assert int(n_act) > 100 and int((ep.iters > 3).sum()) > 100
    assert _rows_equal(ek, ep)


def test_k13_takes_a_polytope_past_shared_memory(dev):
    """A face capacity whose store does not fit in a block's shared memory
    (F = 4096) runs in K13's device store, bit for bit: no refusal; the
    default ladder's tiers stay in shared memory."""
    from gjkepa_tpu_torch import _build
    lib = _build.load()
    rng = np.random.default_rng(10)
    p1, p2 = (torch.from_numpy(_hulls(rng, 64, 2600, 0.3)).to(dev)
              for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    assert lib.epa_hulls_big_smem_bytes(4096) > _build.smem_limit(dev)
    assert fused_epa.near_store_faces(cascade_plan(cfg),
                                      lib.epa_hulls_big_smem_bytes,
                                      _build.smem_limit(dev)) == 208
    active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
    g = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
    order, n_act = hit_first_order(g.hit)
    for ladder in ([(cfg.replace(epa_max_faces=4096), 16)],
                   cascade_plan(cfg.replace(epa_max_faces=4096))):
        args = (p1, p2, g.simplex, g.status, order, n_act, ladder)
        n0 = fst.LAUNCHES["epa_hulls_big"]
        ek = fst.epa_hulls_big(*args)
        assert fst.LAUNCHES["epa_hulls_big"] == n0 + 1
        assert int(n_act) > 10
        assert _rows_equal(ek, fst.epa_hulls_big_plain(*args))


@pytest.mark.parametrize("near", [None, 16, 0],
                         ids=["rule", "near16", "device"])
def test_k13_store_splits_are_bit_equal_to_plain(dev, near):
    """K13 over the overflow ladder (F=8, K=2; F=16, K=4; F=208, K=16)
    with its tiers in shared memory (the rule), the first two there and
    the last in device memory, or all in device memory: bit for bit."""
    rng = np.random.default_rng(9)
    p1, p2 = (torch.from_numpy(_hulls(rng, 512, 2600, 0.3)).to(dev)
              for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    ladder = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((8, 2), (16, 4), (208, 16))]
    active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
    g = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
    order, n_act = hit_first_order(g.hit)
    args = (p1, p2, g.simplex, g.status, order, n_act, ladder)
    ek = fst._epa_hulls_big_cuda(*args, near_faces=near)
    assert int(n_act) > 100
    assert _rows_equal(ek, fst.epa_hulls_big_plain(*args))


def test_k13_takes_a_polytope_past_48_kb(dev):
    """A face store above the default 48 KB of shared memory a block (F =
    1024: 17 words a face) is opted into and runs bit for bit."""
    from gjkepa_tpu_torch import _build
    rng = np.random.default_rng(11)
    p1, p2 = (torch.from_numpy(_hulls(rng, 64, 2600, 0.3)).to(dev)
              for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    ladder = [(cfg.replace(epa_max_faces=1024), 16)]
    assert _build.load().epa_hulls_big_smem_bytes(1024) > 48 * 1024
    active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
    g = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
    order, n_act = hit_first_order(g.hit)
    args = (p1, p2, g.simplex, g.status, order, n_act, ladder)
    assert int(n_act) > 10
    assert _rows_equal(fst.epa_hulls_big(*args), fst.epa_hulls_big_plain(*args))


def test_kernel_byte_counts_are_the_rules(dev):
    """On the card, the block-fit rule (K13's, and K2's before its pool)
    over K2's own byte count keeps the whole default ladder in shared
    memory and sends a 4,096-face store to device memory, and K12's
    launcher stages 2,600 + 2,600 and 8,192 + 8,192 vertices but not
    10,240 + 10,240."""
    from gjkepa_tpu_torch import _build
    lib = _build.load()
    limit = _build.smem_limit(dev)
    assert limit == lib.epa_hulls_big_smem_limit() > 48 * 1024
    stages = cascade_plan(GJKEPAConfig.for_f32())
    k2_bytes = fused_epa.k2_smem_bytes(32)
    assert fused_epa.near_store_faces(stages, k2_bytes, limit) == 208
    assert k2_bytes(208) <= limit < k2_bytes(4096)
    with torch.cuda.device(dev):
        assert lib.gjk_hulls_big_staged(2600, 2600)
        assert lib.gjk_hulls_big_staged(8192, 8192)
        assert not lib.gjk_hulls_big_staged(10240, 10240)


def _deep(rng, b, n):
    p1 = torch.from_numpy(_hulls(rng, b, n, 0.0, 2.0))
    p2 = torch.from_numpy(_hulls(rng, b, n, 0.2, 0.5))
    return p1, p2


@pytest.mark.parametrize("team", [16, 32])
@pytest.mark.parametrize("near", [None, 16, 0],
                         ids=["rule", "near16", "device"])
@pytest.mark.parametrize("n", [24, 23])
def test_k2_overflow_ladder_is_bit_equal_to_plain(dev, n, near, team):
    """K2 at each width over a ladder whose first tiers overflow (F=8,
    K=2; F=16, K=4; F=208, K=16), with the tiers as its store rule places
    them, the first two in shared memory and the last in the pool, or all
    in the pool: rows bit for bit against the plain cascade and the
    32-lane kernel; at 23 vertices K11 takes its scalar scan."""
    rng = np.random.default_rng(12)
    p1, p2 = (t.to(dev) for t in _deep(rng, 2048, n))
    cfg = GJKEPAConfig.for_f32()
    ladder = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((8, 2), (16, 4), (208, 16))]
    g = fused_gjk.gjk_hulls_plain(p1, p2, cfg)
    order, n_act = hit_first_order(g.hit)
    args = (p1, p2, g.simplex, g.status, order, n_act, ladder)
    ep = fused_epa.epa_cascade_plain(*args)
    assert int(n_act) > 1000 and int((ep.iters > 3).sum()) > 500
    assert _k2_widths_equal(args, team, ep, near_faces=near)


def test_k2_takes_a_polytope_past_shared_memory(dev):
    """A face capacity whose store does not fit in a block's shared memory
    (F = 4096) runs in K2's pool, bit for bit: no refusal."""
    from gjkepa_tpu_torch import _build
    rng = np.random.default_rng(13)
    p1, p2 = (t.to(dev) for t in _deep(rng, 512, 24))
    cfg = GJKEPAConfig.for_f32()
    ladder = [(cfg.replace(epa_max_faces=4096), 16)]
    assert fused_epa.k2_smem_bytes(32)(4096) > _build.smem_limit(dev)
    g = fused_gjk.gjk_hulls(p1, p2, cfg)
    order, n_act = hit_first_order(g.hit)
    args = (p1, p2, g.simplex, g.status, order, n_act, ladder)
    n0 = fused_epa.LAUNCHES
    ek = fused_epa.epa_cascade(*args)
    assert fused_epa.LAUNCHES == n0 + 1
    assert int(n_act) > 300
    assert _rows_equal(ek, fused_epa.epa_cascade_plain(*args))


@pytest.mark.parametrize("team", [16, 32])
def test_k2_store_rule_on_card(dev, team):
    """K2's rule over the card's own facts at each width: the registers'
    blocks an SM fit in shared memory beside the tiers it keeps there, the
    occupancy calculator gives K2 those hits an SM, and the tiers past
    them take the pool, whose slots cover the most K2 hits an SM holds at
    either width."""
    facts = fused_epa.k2_device(dev, team)
    nbytes = fused_epa.k2_smem_bytes(team)
    stages = cascade_plan(GJKEPAConfig.for_f32())
    near = fused_epa.k2_near_faces(stages, nbytes, facts.blocks,
                                   facts.sm_bytes, facts.reserve)
    hits = fused_epa.k2_resident_hits(dev, stages, team)
    props = torch.cuda.get_device_properties(dev)
    assert facts.blocks >= 1 and facts.hits == 32 // team
    assert facts.sm_ids >= props.multi_processor_count
    assert facts.blocks * facts.hits <= facts.slots <= 64
    assert facts.slots == fused_epa.k2_device(dev, 48 - team).slots
    assert facts.blocks * (nbytes(near) + facts.reserve) <= facts.sm_bytes
    assert hits == facts.blocks * facts.hits
    assert near in (0, 48, 88, 208)
    if near < 208:
        assert facts.blocks * (nbytes(208) + facts.reserve) > facts.sm_bytes


def _k2_case(dev, b, seed):
    rng = np.random.default_rng(seed)
    p1, p2 = (t.to(dev) for t in _deep(rng, b, 24))
    cfg = GJKEPAConfig.for_f32()
    g = fused_gjk.gjk_hulls(p1, p2, cfg)
    order, n_act = hit_first_order(g.hit)
    return (p1, p2, g.simplex, g.status, order, n_act, cascade_plan(cfg))


def _pool_clear():
    torch.cuda.synchronize()
    return not any(bool(m.any()) for _, m in fused_epa._POOLS.values())


def _k2_tallied(args, team, **variant):
    """K2 at ``team`` lanes a hit under a tally: (rows, tally as a list);
    no host read is taken and the pool's masks end clear."""
    reads = fused_epa.STORE_READS
    with fused_epa.k2_tally(args[0].device) as tally:
        ek = fused_epa._epa_cascade_cuda(*args, team=team, **variant)
    assert fused_epa.STORE_READS == reads
    assert _pool_clear()
    return ek, tally.tolist()


def _pairing_holds(tally, rows, n, team):
    """The tally's iteration entries at ``team`` lanes: at 16, every hit's
    iterations summed (at least its rows', which count the last tier
    alone) and each warp's longer team's, at most their sum and at least
    half of it; at 32, none."""
    its, longer = tally[fused_epa.TALLY_ITERS], tally[fused_epa.TALLY_LONGER]
    if team == 32:
        return its == longer == 0
    ran = int(rows.iters.sum())
    return its >= ran > 0 and longer <= its <= 2 * longer


@pytest.mark.parametrize("team", [16, 32])
@pytest.mark.parametrize("near", [None, 0], ids=["rule", "pool"])
def test_k2_pool_is_bit_equal_to_plain(dev, near, team):
    """K2 at each width on 16,384 deep hits over the default ladder, its
    tiers as the rule places them or every tier in the pool (each hit
    claims a slot: more hits than the pool has slots, so slots are
    reused): rows bit for bit against the plain cascade and the 32-lane
    kernel, the tally counts every hit once and a claim for each hit that
    reached a pooled tier, and at 16 lanes the iterations of the pairing,
    the pool's masks end clear and no host read is taken."""
    args = _k2_case(dev, 16384, 14)
    facts = fused_epa.k2_device(dev, team)
    n = int(args[5])
    assert n > facts.sm_ids * facts.slots
    ek, tally = _k2_tallied(args, team, near_faces=near)
    tiers = tally[:fused_epa.MAX_TIERS]
    assert sum(tiers) == n
    if near is None:
        near = fused_epa.k2_near_faces(
            args[6], fused_epa.k2_smem_bytes(team), facts.blocks,
            facts.sm_bytes, facts.reserve)
    pooled = [c.epa_max_faces > near for c, _ in args[6]]
    assert tally[fused_epa.TALLY_CLAIMS] == sum(
        t for t, p in zip(tiers, pooled) if p)
    assert _pairing_holds(tally, ek, n, team)
    want = fused_epa.epa_cascade_plain(*args)
    assert _rows_equal(ek, want)
    assert _rows_equal(fused_epa._epa_cascade_cuda(*args, team=32,
                                                   near_faces=near), want)


@pytest.mark.parametrize("team", [16, 32])
def test_k2_launches_in_flight_on_two_streams(dev, team):
    """Two K2 launches at each width on two streams at once, every tier in
    the pool, so that both claim slots of the same masks, beside a launch
    of the other width: each gives the plain rows, and the masks end
    clear."""
    a = _k2_case(dev, 8192, 15)
    b = _k2_case(dev, 8192, 16)
    want = [fused_epa.epa_cascade_plain(*x) for x in (a, b)]
    fused_epa._epa_cascade_cuda(*a, near_faces=0)   # the pool made first
    streams = [torch.cuda.Stream(dev) for _ in range(3)]
    got = []
    for x, st, t in zip((a, b, a), streams, (team, team, 48 - team)):
        st.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(st):
            got.append(fused_epa._epa_cascade_cuda(*x, near_faces=0,
                                                   team=t))
    for st in streams:
        torch.cuda.current_stream(dev).wait_stream(st)
    assert _pool_clear()
    assert all(_rows_equal(g, w) for g, w in zip(got, want + want[:1]))


@pytest.mark.parametrize("team", [16, 32])
def test_k2_odd_hit_count_on_card(dev, team):
    """An odd hit count: the last warp's second team at 16 lanes has no
    hit and leaves alone; every hit's rows bit for bit against the plain
    cascade and the 32-lane kernel, the pairing's tally as it holds."""
    p1, p2, simplex, status, order, n_act, st = _k2_case(dev, 4096, 17)
    odd = int(n_act) - 1 + int(n_act) % 2
    assert odd % 2 == 1 and odd > 3000
    args = (p1, p2, simplex, status, order,
            torch.tensor(odd, dtype=torch.int32, device=dev), st)
    want = fused_epa.epa_cascade_plain(*args)
    ek, tally = _k2_tallied(args, team)
    assert sum(tally[:fused_epa.MAX_TIERS]) == odd
    assert _pairing_holds(tally, ek, odd, team)
    assert _k2_widths_equal(args, team, want) and _rows_equal(ek, want)
    rest = order[odd:].long()
    assert torch.equal(ek.iters[rest], torch.zeros_like(ek.iters[rest]))


def _shallow_box_pairs(rng, b, n):
    """``b`` pairs of unit cubes (8 corners repeated to ``n`` vertices),
    the second moved 0.9-0.99 along one of the first's axes and a little
    across, both turned at random: a shallow face contact, where GJK's
    simplex often holds a face on the Minkowski facet nearest the origin,
    so that EPA's first probe gains nothing and stops at iteration 1."""
    cube = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                     for z in (-.5, .5)])
    p1 = np.empty((b, n, 3), np.float32)
    p2 = np.empty((b, n, 3), np.float32)
    for i in range(b):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        shift = [0.9 + 0.09 * rng.random(), *(0.3 * rng.normal(size=2))]
        p1[i] = np.resize(cube @ q.T, (n, 3))
        p2[i] = np.resize((cube + shift) @ q.T, (n, 3))
    return torch.from_numpy(p1), torch.from_numpy(p2)


@pytest.mark.parametrize("team", [16, 32])
def test_k2_teams_of_a_warp_run_apart_on_card(dev, team):
    """Hits in alternating order, one stopping at EPA iteration 1 (a
    shallow box contact) and the next running more (a deep pair), so that
    the two teams of a 16-lane warp part after the first iteration: rows
    bit for bit against the plain cascade and the 32-lane kernel, and the
    tally's iterations those of the rows, its pairing well under 1."""
    rng = np.random.default_rng(18)
    b = 2048
    s1, s2 = _shallow_box_pairs(rng, b, 24)
    d1, d2 = _deep(rng, b, 24)
    p1 = torch.cat([s1, d1]).to(dev)
    p2 = torch.cat([s2, d2]).to(dev)
    cfg = GJKEPAConfig.for_f32()
    stages = cascade_plan(cfg)
    g = fused_gjk.gjk_hulls(p1, p2, cfg)
    order, n_act = hit_first_order(g.hit)
    first = fused_epa.epa_cascade_plain(p1, p2, g.simplex, g.status, order,
                                        n_act, stages)
    lane = torch.arange(2 * b, device=dev)
    short = lane[(lane < b) & g.hit & (first.iters == 1)]
    long = lane[(lane >= b) & g.hit & (first.iters > 1)]
    m = min(short.numel(), long.numel())
    assert m > 800
    keep = torch.stack([short[:m], long[:m]], 1).reshape(-1)
    rest = torch.ones(2 * b, dtype=torch.bool, device=dev)
    rest[keep] = False
    order = torch.cat([keep, lane[rest]]).to(torch.int32)
    n_act = torch.tensor(2 * m, dtype=torch.int32, device=dev)
    args = (p1, p2, g.simplex, g.status, order, n_act, stages)
    want = fused_epa.epa_cascade_plain(*args)
    its = want.iters[keep].view(-1, 2)
    assert bool((its[:, 0] == 1).all()) and bool((its[:, 1] > 1).all())
    ek, tally = _k2_tallied(args, team)
    assert _pairing_holds(tally, ek, int(n_act), team)
    if team == 16 and sum(tally[1:fused_epa.MAX_TIERS]) == 0:
        # every hit in its first tier: the rows' iterations are the tally's
        assert tally[fused_epa.TALLY_ITERS] == int(its.sum())
        assert tally[fused_epa.TALLY_LONGER] == int(its.max(1).values.sum())
        assert fused_epa.k2_pairing(tally) < 0.75
    assert _k2_widths_equal(args, team, want) and _rows_equal(ek, want)


def test_k2_width_by_the_hulls_sizes_on_card(dev):
    """The wrapper launches 16 lanes a hit at 24 and 64 vertices and 32 at
    96, as its launch split counts, each bit for bit against the plain
    cascade."""
    cfg = GJKEPAConfig.for_f32()
    rng = np.random.default_rng(19)
    for n, team in ((24, 16), (64, 16), (96, 32)):
        p1, p2 = (t.to(dev) for t in _deep(rng, 512, n))
        g = fused_gjk.gjk_hulls(p1, p2, cfg)
        order, n_act = hit_first_order(g.hit)
        args = (p1, p2, g.simplex, g.status, order, n_act, cascade_plan(cfg))
        before = dict(fused_epa.LAUNCHES_BY_TEAM)
        ek = fused_epa.epa_cascade(*args)
        after = fused_epa.LAUNCHES_BY_TEAM
        assert {t: after[t] - before[t] for t in after} == {
            16: int(team == 16), 32: int(team == 32)}
        assert int(n_act) > 300
        assert _rows_equal(ek, fused_epa.epa_cascade_plain(*args))


def test_k12_scans_hulls_past_shared_memory(dev):
    """Pairs whose hulls do not fit in a block's shared memory (10,240 +
    10,240 vertices) take K12's device-memory scan, bit for bit, and so
    do K13's rows after it."""
    from gjkepa_tpu_torch import _build
    rng = np.random.default_rng(14)
    p1, p2 = (torch.from_numpy(_hulls(rng, 8, 10240, 0.2)).to(dev)
              for _ in range(2))
    with torch.cuda.device(dev):
        assert not _build.load().gjk_hulls_big_staged(10240, 10240)
    gp = _big_rows_match(p1, p2, GJKEPAConfig.for_f32())
    assert int(gp.hit.sum()) > 0


@pytest.mark.parametrize("b,n,staged", [(512, 2600, True), (512, 2601, True),
                                        (8, 10240, False)])
def test_k12_staged_and_scanned_hulls_agree(dev, b, n, staged):
    """K12 with the hulls staged in shared memory (bulk copy at 2600
    vertices, the threads' copy at 2601) and scanned in device memory
    (10,240 + 10,240, past shared memory), as its launcher chooses: the
    same rows, bit for bit, as the plain version."""
    from gjkepa_tpu_torch import _build
    with torch.cuda.device(dev):
        assert bool(_build.load().gjk_hulls_big_staged(n, n)) == staged
    rng = np.random.default_rng(15)
    p1, p2 = (torch.from_numpy(_hulls(rng, b, n, 0.3)).to(dev)
              for _ in range(2))
    cfg = GJKEPAConfig.for_f32()
    active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
    gp = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
    assert int(gp.hit.sum()) > (50 if b > 8 else 0)
    n0 = fst.LAUNCHES["gjk_hulls_big"]
    gk = fst.gjk_hulls_big(p1, p2, active, cfg)
    assert fst.LAUNCHES["gjk_hulls_big"] == n0 + 1
    assert _rows_equal(gk, gp, active)


def _k8_pairs(case):
    """K8's inputs: a slice of bench.py's c2, hulls of 63 vertices (K11's
    scalar scan), and ragged hulls from random masks."""
    rng = np.random.default_rng(16)
    if case == "c2":
        return [torch.from_numpy(x) for x in fixtures.c2_hulls(n=8192)]
    if case == "n63":
        return [torch.from_numpy(_hulls(rng, 4096, 63, spread=2.0))
                for _ in range(2)]
    from gjkepa_tpu_torch.ops.fused import mask_to_padding
    out = []
    for _ in range(2):
        p = torch.from_numpy(_hulls(rng, 4096, 24, spread=2.0))
        mask = torch.from_numpy(rng.random((4096, 24)) < 0.7)
        mask[:, rng.integers(0, 24)] = True
        out.append(mask_to_padding(p, mask).contiguous())
    return out


@pytest.mark.parametrize("team", fused_gjk.TEAMS)
@pytest.mark.parametrize("case", ["c2", "n63", "masked"])
def test_k8_teams_are_bit_equal_to_plain(dev, case, team):
    """K8 at every team size over every pair, at the low cap and the full
    one, rows bit for bit against the plain version."""
    p1, p2 = (t.to(dev) for t in _k8_pairs(case))
    cfg = GJKEPAConfig.for_f32()
    for cap in (10, 64):
        want = fd.distance_hulls_plain(p1, p2, cfg, cap)
        n0 = fd.LAUNCHES["distance_hulls"]
        got = fd._distance_hulls_cuda(p1, p2, cfg, cap, team=team)
        assert fd.LAUNCHES["distance_hulls"] == n0 + 1
        assert _rows_equal(got, want)
    assert int((want.iters > 10).sum()) > 0


@pytest.mark.parametrize("team", fused_gjk.TEAMS)
def test_k8_restart_writes_only_its_rows(dev, team):
    """K8 over an order and a device count (phase 2's launch) at every team
    size: the rows of order[:n_act] bit for bit as the plain version writes
    them, every other row as it was."""
    p1, p2 = (t.to(dev) for t in _k8_pairs("c2"))
    cfg = GJKEPAConfig.for_f32()
    rng = np.random.default_rng(17)
    pick = torch.from_numpy(rng.random(p1.shape[0]) < 0.05).to(dev)
    order, n_act = hit_first_order(pick)
    start = fd.distance_hulls_plain(p1, p2, cfg, 3)
    want = fd.distance_hulls_plain(p1, p2, cfg, 64, order, n_act,
                                   out=fd.DistanceRows(*(t.clone()
                                                         for t in start)))
    got = fd._distance_hulls_cuda(p1, p2, cfg, 64, order, n_act,
                                  out=fd.DistanceRows(*(t.clone()
                                                        for t in start)),
                                  team=team)
    assert _rows_equal(got, want)
    assert _rows_equal([x[~pick] for x in got], [x[~pick] for x in start])
    assert int(n_act) > 100


def test_k8_team_rule_on_card(dev):
    """The wrapper's teams: K1's rule over every pair, RESTART_TEAM for a
    restart; two-phase equals one pass at c2 bit for bit."""
    assert fd.team_size(64, 64, restart=False) == fused_gjk.team_size(64, 64)
    assert fd.team_size(64, 64, restart=True) == fd.RESTART_TEAM
    p1, p2 = (t.to(dev) for t in _k8_pairs("c2"))
    cfg = GJKEPAConfig.for_f32()
    two = fused_gjk_distance_hulls(p1, p2, cfg=cfg)
    one = fused_gjk_distance_hulls(p1, p2, cfg=cfg, two_phase=False)
    for x, y in zip(two, one):
        assert torch.equal(x, y)


@pytest.mark.parametrize("iters", [1, 16, 64])
@pytest.mark.parametrize("name", ["mixed16", "dense_cyl", "c3"])
def test_k7_is_bit_equal_to_plain(dev, name, iters):
    """K7 at epa_max_iters 1, 16 and 64 (the shape ladder caps it at 16 on
    48 faces): rows bit for bit against the plain version."""
    sa, sb, retired = _shape_rows(_shape_pairs(name), dev)
    cfg = GJKEPAConfig.for_f32().replace(epa_max_iters=iters)
    hp = fs.gjk_shapes_plain(sa, sb, retired, cfg)
    order, n_act = hit_first_order(hp.hit & ~hp.final)
    st = fs.shape_stages(cfg)
    assert {c.epa_max_faces for c, _ in st} == {48}
    args = (sa, sb, hp.simplex, hp.status, hp.cf_depth, hp.cf_normal, order,
            n_act, st)
    n0 = fs.LAUNCHES["epa_shapes"]
    ek = fs.epa_shapes(*args)
    assert fs.LAUNCHES["epa_shapes"] == n0 + 1
    ep = fs.epa_shapes_plain(*args)
    assert int(n_act) > 0
    assert _rows_equal(ek, ep)


def test_k7_refuses_a_polytope_past_shared_memory(dev):
    """A face capacity whose warp store does not fit in a block's shared
    memory raises, naming the bytes; K7 allocates no device store."""
    from gjkepa_tpu_torch import _build
    lib = _build.load()
    assert lib.epa_shapes_smem_bytes(48) == 4416        # K7's kWarps = 1
    sa, sb, retired = _shape_rows(_shape_pairs("mixed16"), dev)
    cfg = GJKEPAConfig.for_f32()
    hp = fs.gjk_shapes_plain(sa, sb, retired, cfg)
    order, n_act = hit_first_order(hp.hit & ~hp.final)
    f_big = 4096
    need = lib.epa_shapes_smem_bytes(f_big)
    assert need > _build.smem_limit(dev)
    ladder = [(cfg.replace(epa_max_faces=f_big, epa_max_iters=16), 16)]
    n0 = fs.LAUNCHES["epa_shapes"]
    with pytest.raises(RuntimeError, match=f"{need} bytes of shared memory"):
        fs.epa_shapes(sa, sb, hp.simplex, hp.status, hp.cf_depth,
                      hp.cf_normal, order, n_act, ladder)
    assert fs.LAUNCHES["epa_shapes"] == n0


def _c3b_cut(case, dev):
    """c3b's hulls (case "c3b"), their first n vertices ("n21".."n23": each
    remainder mod 4, K11's single-vertex scan) or padded through a mask
    that drops 20% of the vertices ("masked": repeated vertices, exact
    first-max ties), with c3b's shape rows."""
    hulls, shapes = fixtures.c3b_pairs()
    p1 = torch.from_numpy(hulls).to(dev)
    if case.startswith("n"):
        p1 = p1[:, :int(case[1:])].contiguous()
    elif case == "masked":
        keep = torch.from_numpy(np.random.default_rng(9).random(
            hulls.shape[:2]) > 0.2).to(dev)
        keep[:, 1] = True
        p1 = mask_to_padding(p1, keep).contiguous()
    return p1, ShapeBatch.from_numpy(*shapes, device=dev).packed()


@pytest.mark.parametrize("iters", [1, 16, 64])
@pytest.mark.parametrize("case", ["c3b", "n21", "n22", "n23", "masked"])
def test_k10_is_bit_equal_to_plain_at_c3b(dev, case, iters):
    """K10 (a warp a hit, its polytope in shared memory) at c3b, on hulls
    of 21-23 vertices and on masked hulls, at epa_max_iters 1, 16 and 64
    (the shape ladder caps it at 16 on 48 faces): rows bit for bit against
    the plain version."""
    p1, sb = _c3b_cut(case, dev)
    cfg = GJKEPAConfig.for_f32().replace(epa_max_iters=iters)
    env = fh.hull_shape_retirement(p1, sb, cfg)
    order, _ = hit_first_order(~env.retired)
    gp = fh.gjk_hull_shape_plain(p1, sb, env.retired, order, cfg)
    order, n_act = hit_first_order(gp.hit)
    args = (p1, sb, gp.simplex, gp.status, order, n_act, fs.shape_stages(cfg))
    assert int(n_act) > 1000
    assert _rows_equal(fh.epa_hull_shape(*args), fh.epa_hull_shape_plain(*args))


def test_k10_refuses_a_polytope_past_shared_memory(dev):
    """A face capacity whose warp store does not fit in a block's shared
    memory raises, naming the bytes, and launches nothing; K10 allocates
    no device store."""
    from gjkepa_tpu_torch import _build
    lib = _build.load()
    assert lib.epa_hull_shape_smem_bytes(48) == 4416    # K10's kWarps = 1
    p1, sb = _c3b_cut("c3b", dev)
    p1, sb = p1[:512].contiguous(), sb[:512].contiguous()
    cfg = GJKEPAConfig.for_f32()
    env = fh.hull_shape_retirement(p1, sb, cfg)
    order, _ = hit_first_order(~env.retired)
    gp = fh.gjk_hull_shape_plain(p1, sb, env.retired, order, cfg)
    order, n_act = hit_first_order(gp.hit)
    f_big = 4096
    need = lib.epa_hull_shape_smem_bytes(f_big)
    assert need > _build.smem_limit(dev)
    ladder = [(cfg.replace(epa_max_faces=f_big, epa_max_iters=16), 16)]
    n0 = fh.LAUNCHES["epa_hull_shape"]
    with pytest.raises(RuntimeError, match=f"{need} bytes of shared memory"):
        fh.epa_hull_shape(p1, sb, gp.simplex, gp.status, order, n_act, ladder)
    assert fh.LAUNCHES["epa_hull_shape"] == n0


@pytest.mark.parametrize("team", fused_gjk.TEAMS)
@pytest.mark.parametrize("case", ["c3b", "n21", "n22", "n23", "masked"])
def test_k9_teams_are_bit_equal_to_plain(dev, case, team):
    """K9 at every team size at c3b, on hulls of 21-23 vertices and on
    masked hulls: rows bit for bit against the plain version (the simplex
    on the lanes that ran GJK), in the dispatch's active-first order and in
    the caller's (sort_hits True and False)."""
    p1, sb = _c3b_cut(case, dev)
    cfg = GJKEPAConfig.for_f32()
    env = fh.hull_shape_retirement(p1, sb, cfg)
    order, _ = hit_first_order(~env.retired)
    gp = fh.gjk_hull_shape_plain(p1, sb, env.retired, order, cfg)
    assert int(gp.hit.sum()) > 1000
    for o in (order, torch.arange(p1.shape[0], dtype=torch.int32,
                                  device=dev)):
        got = fh._gjk_hull_shape_cuda(p1, sb, env.retired, o, cfg, team)
        assert _rows_equal(got, gp, gp.status != 0)


# -- the portable path ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_portable_gjkepa_batch_on_card_matches_cpu(dev, dtype):
    """gjkepa_batch (torch code, no kernel) runs on the card's tensors and
    agrees with its CPU run: hit, status and contact type exact,
    iterations on >= 95% of lanes, depth within 1e-9 (float64) or 1e-5
    (float32), the tolerances of its comparison with the JAX package."""
    from gjkepa_tpu_torch import gjkepa_batch
    cfg = GJKEPAConfig() if dtype == torch.float64 else GJKEPAConfig.for_f32()
    rng = np.random.default_rng(0)
    p1, p2 = (torch.from_numpy(_hulls(rng, 512, 12, spread=0.6)).to(dtype)
              for _ in range(2))
    want = gjkepa_batch(p1, p2, cfg=cfg)
    got = gjkepa_batch(p1.to(dev), p2.to(dev), cfg=cfg)
    assert got.depth.device.type == "cuda"
    for f in ("hit", "status", "colli_type"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("gjk_iters", "epa_iters"):
        assert (getattr(got, f).cpu() == getattr(want, f)).float().mean() \
            >= 0.95
    tol = 1e-9 if dtype == torch.float64 else 1e-5
    assert float((got.depth.cpu() - want.depth).abs().max()) <= tol


def test_portable_collide_shapes_on_card(dev):
    """collide_shapes_batch on the card: the CPU run's hits and depths
    (within 2e-5, float32), on the 16 kind pairs."""
    from gjkepa_tpu_torch import collide_shapes_batch
    cfg = GJKEPAConfig.for_f32()
    a, b = fixtures.mixed16_pairs(16, 3)
    ca, cb = (ShapeBatch.from_numpy(*x, device="cpu") for x in (a, b))
    ga, gb = (ShapeBatch.from_numpy(*x, device=dev) for x in (a, b))
    want = collide_shapes_batch(ca, cb, cfg=cfg)
    got = collide_shapes_batch(ga, gb, cfg=cfg)
    assert torch.equal(got.hit.cpu(), want.hit) and int(want.hit.sum()) > 10
    assert float((got.depth.cpu() - want.depth).abs().max()) <= 2e-5


def test_collide_supports_without_active_on_card(dev):
    """No ``active``: the probe runs on the card (the default device), and
    the rows equal those of an explicit all-True mask."""
    from gjkepa_tpu_torch import collide_supports
    from gjkepa_tpu_torch.ops.support import SupportResult
    rng = np.random.default_rng(6)
    c1, c2 = (torch.from_numpy(x).to(dev)
              for x in rng.normal(size=(2, 64, 3)).astype(np.float32) * 0.6)
    r1, r2 = (torch.from_numpy(x).to(dev) for x in
              (0.3 + 0.5 * rng.random((2, 64))).astype(np.float32))

    def support(d):
        u = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True),
                            min=1e-30)
        a, b = c1 + r1[:, None] * u, c2 - r2[:, None] * u
        return SupportResult(a - b, a, b)

    cfg = GJKEPAConfig.for_f32()
    got = collide_supports(support, cfg)
    want = collide_supports(support, cfg, active=torch.ones(
        64, dtype=torch.bool, device=dev))
    assert got.hit.device.type == "cuda" and int(got.hit.sum()) > 0
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def manifolds_agree(got, want, tol=1e-5):
    """The card's manifold rule (module docstring): returns (the share of
    lanes whose masks agree, the share of those equal row by row)."""
    gm, wm = got.mask.cpu(), want.mask.cpu()
    same = (gm == wm).all(1)
    gp, wp = got.points.cpu(), want.points.cpu()
    gd, wd = got.depths.cpu(), want.depths.cpu()
    rows = (((gp - wp).abs().amax(2) <= tol) & ((gd - wd).abs() <= tol)
            | ~wm).all(1) & same
    for i in torch.nonzero(same & ~rows)[:, 0].tolist():
        d = torch.cdist(gp[i][wm[i]].double(), wp[i][wm[i]].double())
        assert max(float(d.amin(0).max()), float(d.amin(1).max())) <= tol, i
        assert torch.allclose(gd[i][wm[i]].sort().values,
                              wd[i][wm[i]].sort().values, rtol=0, atol=tol)
    return float(same.float().mean()), float(rows.sum() / same.sum())


def test_manifold_batch_on_card_matches_cpu(dev):
    """c4's deep pairs (1,024 of them) through gjkepa_batch_fused on the
    CPU, then manifold_batch on the card and on the CPU."""
    from gjkepa_tpu_torch import manifold_batch
    p1, p2 = (torch.from_numpy(x[:1024]) for x in fixtures.c4_pairs())
    r = gjkepa_batch_fused(p1, p2)
    args = (p1, p2, r.normal, r.depth, r.hit, r.contact_point)
    want = manifold_batch(*args)
    got = manifold_batch(*(t.to(dev) for t in args))
    assert got.points.device.type == "cuda"
    assert torch.equal(got.overflow.cpu(), want.overflow)
    masks, rows = manifolds_agree(got, want)
    assert masks >= 0.999 and rows >= 0.99, (masks, rows)


def _close_states(got, want):
    for f, rtol, atol in (("pos", 0, 1e-6), ("quat", 0, 1e-6),
                          ("vel", 1e-5, 1e-5), ("angvel", 1e-5, 1e-5)):
        torch.testing.assert_close(getattr(got, f).cpu(), getattr(want, f),
                                   rtol=rtol, atol=atol, msg=f)


def test_sim_step_on_card_matches_cpu(dev):
    """The packed 64-box scene of tests/test_torch_sim.py: one step on the
    card launches K1 and K2 and agrees with the same branch on the CPU
    (their plain versions; diag exact) and with the CPU's portable step."""
    from gjkepa_tpu_torch.sim import SimConfig, init_boxes, rigid, sim_step
    state = init_boxes(64, height=0.55, spread=4.0, device="cpu")
    scfg, cfg = SimConfig(max_pairs=512), GJKEPAConfig.for_f32()
    n1, n2 = fused_gjk.LAUNCHES, fused_epa.LAUNCHES
    got, gd = sim_step(rigid.SimState(*(t.to(dev) for t in state)), scfg)
    torch.cuda.synchronize()
    assert fused_gjk.LAUNCHES > n1 and fused_epa.LAUNCHES > n2
    assert got.pos.device.type == "cuda"
    want, wd = rigid._step(state, scfg, cfg, rigid._pair_contacts_fused)
    portable, _ = sim_step(state, scfg)
    for k, v in wd.items():
        assert torch.equal(gd[k].cpu(), v), k
    assert int(wd["n_contacts"]) >= 100
    _close_states(got, want)
    _close_states(got, portable)


def test_fused_sharded_on_a_cuda0_mesh_equals_unsharded(dev):
    """The fused query over 4 entries of the card: every field bit for
    bit against the unsharded query, one K1 and one K2 a shard."""
    from gjkepa_tpu_torch.parallel import (gjkepa_batch_fused_sharded,
                                           pair_mesh, shard_pairs)
    rng = np.random.default_rng(0)
    p1, p2 = (torch.from_numpy(x).to(dev) for x in fixtures.deep_pairs(
        rng, 4096, 24))
    cfg = GJKEPAConfig.for_f32()
    mesh = pair_mesh(4, device=dev)
    s1, s2 = shard_pairs(mesh, p1, p2)
    torch.cuda.synchronize()
    fused_gjk.LAUNCHES = 0
    fused_epa.LAUNCHES = 0
    r = gjkepa_batch_fused_sharded(mesh, s1, s2, cfg=cfg)
    torch.cuda.synchronize()
    assert (fused_gjk.LAUNCHES, fused_epa.LAUNCHES) == (4, 4)
    assert [s.depth.device for s in r.shards] == [dev] * 4
    g = r.gather()
    for name, x, y in zip(g._fields, g, gjkepa_batch_fused(p1, p2, cfg=cfg)):
        assert torch.equal(x, y), name


def test_checked_fused_hulls_raises_on_a_poisoned_lane_on_card(dev):
    """The sanitizer over K1/K2 on the card: clean rows bit for bit
    against the unchecked call, a NaN vertex named with its lanes as on
    the CPU."""
    from gjkepa_tpu_torch.debug import (DebugCheckError,
                                        checked_fused_gjkepa_hulls)
    from gjkepa_tpu_torch.ops.fused import fused_gjkepa_hulls
    rng = np.random.default_rng(0)
    p1, p2 = (torch.from_numpy(x) for x in fixtures.deep_pairs(rng, 2048,
                                                               24))
    cfg = GJKEPAConfig.for_f32()
    r = checked_fused_gjkepa_hulls(p1.to(dev), p2.to(dev), cfg=cfg)
    for name, x, y in zip(r._fields, r, fused_gjkepa_hulls(
            p1.to(dev), p2.to(dev), cfg=cfg)):
        assert torch.equal(x, y), name
    p1[[7, 1500], 3, 1] = float("nan")
    p2[900, 0, 0] = float("inf")
    msg = []
    for d in (dev, torch.device("cpu")):
        with pytest.raises(DebugCheckError) as e:
            checked_fused_gjkepa_hulls(p1.to(d), p2.to(d), cfg=cfg)
        msg.append(str(e.value))
    assert msg[0] == msg[1] == (
        "sanitizer check failed: non-finite input vertex (NaN/Inf in p1 or "
        "p2) (lanes [7, 900, 1500])")


def test_bench_c3_seed0_on_card(dev):
    """The bench's c3 config through its timer on the card, seed 0 alone:
    its keys, a positive rate and the JAX bench's 3,870 hits within 1%."""
    from gjkepa_tpu_torch import bench
    tag, a, b = next(bench.c3_inputs(dev))
    results, diag = bench.c3(bench.Timer(dev), [(tag, a, b)],
                             GJKEPAConfig.for_f32())
    assert set(results) == {"c3_seed0_qps", "c3_analytic64k_qps",
                            "c3_seed_spread"}
    assert results["c3_seed0_qps"] == results["c3_analytic64k_qps"] > 0
    assert results["c3_seed_spread"] == 0
    assert abs(diag["seed0"]["hits"] - 3870) <= 0.01 * 3870
