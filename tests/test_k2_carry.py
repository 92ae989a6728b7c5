"""K2's ladder carries a polytope on instead of rebuilding it.

Where a tier of the EPA ladder stops for capacity, the plain version
(``fused_epa.run_cascade``) restarts the next tier from the GJK simplex.
K2 (``csrc/epa_hulls.cu``'s ``k2_ladder``) gives the same rows without the
replay: after a stop by free faces (more horizon edges than free faces) it
carries the polytope into the next tier when that tier has at least as
many faces and as large a visible-set bound; after a stop by visible
faces (more than K) it restarts, as the plain ladder does.  The carry
rests on one fact, pinned here on the CPU with the plain tier
(``epa_phase``): a larger tier run from the simplex repeats the smaller
tier's iterations bit for bit up to a stop by free faces, since its extra
faces stay dead and come last.  The recipe is the
``hull255_64k.deep_penetration_facets`` cell's at 255 points, and forced
ladders with a small K reach the stops by visible faces.

The tests marked ``cuda`` run K2 at 16 and 32 lanes a hit on the card,
bit for bit against ``epa_cascade_plain``, with each way in (a carry in
the same store, a carry from shared memory into the pool, a restart after
a stop by visible faces or before a smaller tier), and hold the pool's
carry counter (``fused_epa.tier_carries``), which every launch is handed,
to the carries counted from the plain ladder's exits:

    python -m pytest tests/test_k2_carry.py -q -m cuda --noconftest \\
        -o addopts="" -p no:cacheprovider
"""

import pytest
import torch

from benchmark import traffic
from gjkepa_tpu_torch import GJKEPAConfig
from gjkepa_tpu_torch.ops import fused_epa
from gjkepa_tpu_torch.ops.fused import cascade_plan, hit_first_order, round_cfg
from gjkepa_tpu_torch.ops.fused_gjk import gjk_hulls, make_hull_support
from gjkepa_tpu_torch.types import Status

CFG = round_cfg(GJKEPAConfig.for_f32())
# Ladders of (faces, K) with a small K, so that tiers also stop by visible
# faces: A carries a stop by free faces (16 -> 24, 24 -> 48) and restarts
# after a stop by visible faces; B only restarts (fewer faces, then a
# smaller K).
LADDERS = {"carry": ((16, 3), (24, 3), (48, 8)),
           "restart": ((32, 8), (16, 3), (24, 2))}


def _ladder(tiers):
    return [(CFG.replace(epa_max_faces=f), k) for f, k in tiers]


def _hits(seed, pairs, vertices, dev):
    """The facets cell's recipe (``deep_penetration_facets.json``'s sides)
    through K1: (p1, p2, simplex, status, order, n_act)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p1 = traffic.draw_side(g, pairs, vertices, 2.0, 0.0, dev)
    p2 = traffic.draw_side(g, pairs, vertices, 0.5, 0.2, dev)
    gr = gjk_hulls(p1, p2, CFG, True)
    order, n_act = hit_first_order(gr.hit)
    return p1, p2, gr.simplex, gr.status, order, n_act


def tier_exits(p1, p2, simplex, stages):
    """The plain ladder tier by tier over every lane: a list, a tier each,
    of (lanes, depth, normal, iters, status, cause), each tier over the
    lanes the one before stopped for capacity, in their order."""
    lanes = torch.arange(p1.shape[0], device=p1.device)
    out = []
    for c, k in stages:
        if lanes.numel() == 0:
            break
        ones = torch.ones(lanes.numel(), dtype=torch.bool, device=p1.device)
        rows = fused_epa.epa_phase(make_hull_support(p1[lanes], p2[lanes]),
                                   simplex[lanes], ones, c, c.epa_max_faces,
                                   k, cause=True)
        out.append((lanes, *rows))
        lanes = lanes[rows[3] == Status.HIT_EPA_CAPACITY]
    return out


def k2_carries(exits, stages):
    """The tiers K2's ladder carries a polytope into, counted from the plain
    ladder's exits: each stop by free faces before a tier with as many
    faces or more and as large a K or larger."""
    count = 0
    for t in range(len(exits) - 1):
        (c, k), (c2, k2) = stages[t], stages[t + 1]
        if c2.epa_max_faces >= c.epa_max_faces and k2 >= k:
            count += int((exits[t][5] == fused_epa.BY_FREE).sum())
    return count


def _cases():
    yield "facets", _hits(1, 384, 255, "cpu"), cascade_plan(CFG)
    for name, tiers in LADDERS.items():
        yield name, _hits(2, 256, 24, "cpu"), _ladder(tiers)


@pytest.fixture(scope="module")
def cases():
    """Each case's hits and ladder and the plain ladder's exits."""
    out = {}
    for name, (p1, p2, simplex, _, order, n_act), stages in _cases():
        lanes = order[:int(n_act)].long()
        q1, q2, s = p1[lanes], p2[lanes], simplex[lanes]
        out[name] = (q1, q2, s, stages, tier_exits(q1, q2, s, stages))
    return out


@pytest.mark.parametrize("name", ["facets", "carry"])
def test_a_larger_tier_repeats_a_stop_by_free_faces(cases, name):
    """Every lane a tier stops by free faces at iteration e: the next tier,
    as many faces or more and as large a K or larger, run from the simplex
    with ``epa_max_iters`` = e, gives its depth, normal and iterations bit
    for bit."""
    q1, q2, s, stages, exits = cases[name]
    seen = 0
    for t in range(len(exits) - 1):
        (c, k), (c2, k2) = stages[t], stages[t + 1]
        if c2.epa_max_faces < c.epa_max_faces or k2 < k:
            continue
        lanes, depth, normal, iters, _, why = exits[t]
        free = why == fused_epa.BY_FREE
        for e in iters[free].unique().tolist():
            pick = free & (iters == e)
            sub = lanes[pick]
            ones = torch.ones(sub.numel(), dtype=torch.bool)
            d2, n2, i2, _ = fused_epa.epa_phase(
                make_hull_support(q1[sub], q2[sub]), s[sub], ones,
                c2.replace(epa_max_iters=e), c2.epa_max_faces, k2)
            assert torch.equal(d2, depth[pick])
            assert all(torch.equal(a, b[pick]) for a, b in zip(n2, normal))
            assert torch.equal(i2, iters[pick])
            seen += sub.numel()
    assert seen > (40 if name == "facets" else 10)


def test_the_facets_recipe_carries_most_48_face_stops(cases):
    """At 255 points the 48-face tier stops only by free faces, so each of
    its stops is carried into the 88-face tier, and counted."""
    _, _, _, stages, exits = cases["facets"]
    lanes, *_, status, why = exits[0]
    cap = status == Status.HIT_EPA_CAPACITY
    assert int(cap.sum()) > 0.3 * lanes.numel()
    assert bool((why[cap] == fused_epa.BY_FREE).all())
    assert k2_carries(exits, stages) >= int(cap.sum())


def test_each_ladder_reaches_its_way_in(cases):
    """The forced ladders reach what the card tests need: on A, stops by
    free faces (carries) and by visible faces (restarts) in each tier
    before the last; on B, stops by free faces before a smaller tier and
    then a smaller K, so no carry (only restarts)."""
    for name in LADDERS:
        assert len(cases[name][4]) == 3
    exits = cases["carry"][4]
    for t in range(2):
        assert int((exits[t][5] == fused_epa.BY_FREE).sum()) > 5
        assert int((exits[t][5] == fused_epa.BY_VISIBLE).sum()) > 5
    assert k2_carries(exits, cases["carry"][3]) > 10
    exits = cases["restart"][4]
    for t in range(2):
        assert int((exits[t][5] == fused_epa.BY_FREE).sum()) > 5
    assert k2_carries(exits, cases["restart"][3]) == 0


def test_plain_cause_leaves_the_rows_alone():
    """``epa_phase(..., cause=True)`` returns the rows it returns without."""
    p1, p2, simplex, _, order, n_act = _hits(3, 128, 24, "cpu")
    lanes = order[:int(n_act)].long()
    c, k = _ladder(LADDERS["carry"])[0]
    ones = torch.ones(lanes.numel(), dtype=torch.bool)
    args = (make_hull_support(p1[lanes], p2[lanes]), simplex[lanes], ones,
            c, c.epa_max_faces, k)
    plain = fused_epa.epa_phase(*args)
    *rows, why = fused_epa.epa_phase(*args, cause=True)
    assert torch.equal(rows[0], plain[0]) and torch.equal(rows[2], plain[2])
    assert torch.equal(rows[3], plain[3])
    assert all(torch.equal(a, b) for a, b in zip(rows[1], plain[1]))
    cap = plain[3] == Status.HIT_EPA_CAPACITY
    assert bool((why[cap] > 0).all()) and bool((why[~cap] == 0).all())


# -- on the card ---------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _k2_against_plain(args, team, **variant):
    """K2 at ``team`` lanes under a tally against the plain ladder: rows
    bit for bit, the hits finishing in each tier as in the plain ladder,
    the pool's masks clear, the pool's carries in the launch those counted
    from the plain exits (every launch is handed the counter); returns
    (the carries, whether a tier was pooled)."""
    p1, p2, simplex, _, order, n_act, stages = args
    dev = p1.device
    carries = fused_epa.tier_carries(dev)
    with fused_epa.k2_tally(dev) as tally:
        rows = fused_epa._epa_cascade_cuda(*args, team=team, **variant)
    torch.cuda.synchronize(dev)
    got = fused_epa.tier_carries(dev) - carries
    assert not any(bool(m.any()) for _, m in fused_epa._POOLS.values())
    want = fused_epa.epa_cascade_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(rows, want))
    lanes = order[:int(n_act)].long()
    exits = tier_exits(p1[lanes], p2[lanes], simplex[lanes], stages)
    ended = [int((e[4] != Status.HIT_EPA_CAPACITY).sum()) for e in exits]
    ended[-1] = exits[-1][0].numel()
    tiers = tally.tolist()[:fused_epa.MAX_TIERS]
    assert tiers == ended + [0] * (fused_epa.MAX_TIERS - len(ended))
    near = variant.get("near_faces")
    if near is None:
        facts = fused_epa.k2_device(dev, team)
        near = fused_epa.k2_near_faces(stages, fused_epa.k2_smem_bytes(team),
                                       facts.blocks, facts.sm_bytes,
                                       facts.reserve)
    assert got == k2_carries(exits, stages)
    return got, any(c.epa_max_faces > near for c, _ in stages)


@pytest.mark.cuda
@pytest.mark.parametrize("team", [16, 32])
def test_k2_carries_the_facets_recipe_bit_for_bit(team):
    """The facets cell's recipe at 255 points, at least 16,384 hits, the
    default ladder (48 and 88 faces in shared memory at 32 lanes, 88
    pooled at 16: a carry in the same store, or into the pool): rows bit
    for bit, and the pool's carry counter equal to the carries counted
    from the plain exits, about 43% of the hits."""
    dev = _card()
    args = (*_hits(2 ** 31 + 41, 16448, 255, dev), cascade_plan(CFG))
    hits = int(args[5])
    assert hits >= 16384
    carried, pooled = _k2_against_plain(args, team)
    assert pooled
    assert 0.35 * hits < carried < 0.5 * hits


@pytest.mark.cuda
@pytest.mark.parametrize("team", [16, 32])
@pytest.mark.parametrize("near", [None, 16, 0],
                         ids=["shared", "shared_then_pool", "pool"])
@pytest.mark.parametrize("ladder", list(LADDERS))
def test_k2_forced_ladders_carry_and_restart(ladder, near, team):
    """Deep 24-vertex hits over each forced ladder, every tier in shared
    memory (the rule: no tier pooled), the 16-face tier alone there
    (carries copied into the pool), or every tier in the pool: rows bit
    for bit, and the carry counter equal to the plain exits' count."""
    dev = _card()
    args = (*_hits(2 ** 31 + 43, 4096, 24, dev), _ladder(LADDERS[ladder]))
    assert int(args[5]) > 3000
    carried, pooled = _k2_against_plain(args, team, near_faces=near)
    assert pooled == (near is not None)
    assert (carried > 0) == (ladder != "restart")
