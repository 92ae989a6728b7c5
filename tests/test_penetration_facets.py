"""The 255-point penetration cell's plain reference and check, small on the
CPU.

``benchmark/reference_penetration_facets.py`` gives the exact penetration
depth and normal of two vertex clouds from their hulls' facets and edges,
in float64.  Here it is held against closed forms (overlapping cubes, a
cube inside a cube, separated cubes) and against the brute-force
``benchmark/reference_penetration.py`` on 8-, 12- and 24-vertex lanes; the
port's ``fused_gjkepa_hulls`` (its plain versions on CPU tensors) is held
against it at 255 vertices; the cell ``hull255_64k.deep_penetration_facets``
runs small through the harness, correct, while its bfloat16 control fails
every compared number; K2's pool keeps its claim counter in the word before
its slot masks; and the readers the cell lists read made-up traces of its
kernels.
Two tests, marked ``cuda``, run K2 at 255 vertices on the card and its
claim counter against the tally:

    python -m pytest tests/test_penetration_facets.py -q -m cuda \
        --noconftest -o addopts="" -p no:cacheprovider
"""

import itertools
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark import check, run, spec, trace, traffic, window
from benchmark import reference_penetration as rp
from benchmark import reference_penetration_facets as rpf
from gjkepa_tpu_torch import GJKEPAConfig, fused_gjkepa_hulls
from gjkepa_tpu_torch.ops import fused_epa
from gjkepa_tpu_torch.ops.fused import cascade_plan, round_cfg
from gjkepa_tpu_torch.types import Status

CELL = "hull255_64k.deep_penetration_facets"


def _cube(center, half):
    return torch.tensor([[c + s * half for c, s in zip(center, signs)]
                         for signs in itertools.product((-1, 1), repeat=3)],
                        dtype=torch.float64)


def _pairs(pairs):
    a = torch.stack([_cube(*p[0]) for p in pairs])
    b = torch.stack([_cube(*p[1]) for p in pairs])
    return rpf.penetration(a, b)


def _deep(seed, pairs, vertices):
    """The cell's recipe (``deep_penetration_facets.json``'s sides) on the
    CPU."""
    g = torch.Generator().manual_seed(seed)
    return (traffic.draw_side(g, pairs, vertices, 2.0, 0.0, "cpu"),
            traffic.draw_side(g, pairs, vertices, 0.5, 0.2, "cpu"))


@pytest.mark.parametrize("offset", [(0.3, 0.1, -0.2), (-0.05, 0.45, 0.2),
                                    (0.1, -0.2, -0.6)])
def test_overlapping_cubes_give_the_least_axis_overlap(offset):
    """Unit cubes, B moved by ``offset``: the depth is the least overlap of
    the three axes, 1 - |offset_i|, along that axis towards B."""
    r = _pairs([(((0, 0, 0), 0.5), (offset, 0.5))])
    k = max(range(3), key=lambda i: abs(offset[i]))
    normal = torch.zeros(3, dtype=torch.float64)
    normal[k] = 1.0 if offset[k] > 0 else -1.0
    assert bool(r["penetrating"][0])
    assert float(r["depth"][0]) == pytest.approx(1 - abs(offset[k]),
                                                 abs=1e-15)
    assert torch.equal(r["normal"][0], normal)


@pytest.mark.parametrize("center, depth, normal", [
    ((0.1, -0.3, 0.05), 0.95, (0.0, -1.0, 0.0)),
    ((0.0, 0.0, 0.0), 1.25, (1.0, 0.0, 0.0))])
def test_small_cube_in_a_big_one(center, depth, normal):
    """A cube of half 0.25 at ``center`` inside one of half 1: depth 1 +
    0.25 - max |center_i|, along the axis nearest a face; at the centre
    every axis ties, and any tied normal meets the depth."""
    r = _pairs([(((0, 0, 0), 1.0), (center, 0.25))])
    assert float(r["depth"][0]) == pytest.approx(depth, abs=1e-15)
    if center != (0.0, 0.0, 0.0):
        assert torch.equal(r["normal"][0].abs(),
                           torch.tensor(normal, dtype=torch.float64).abs())
    h = rp.minkowski_height(_cube((0, 0, 0), 1.0)[None],
                            _cube(center, 0.25)[None], r["normal"])
    assert float(h[0]) == pytest.approx(depth, abs=1e-15)


def test_separated_cubes_do_not_penetrate():
    r = _pairs([(((0, 0, 0), 0.5), ((1.5, 0, 0), 0.5)),
                (((0, 0, 0), 0.5), ((1.0, 0, 0), 0.5))])    # touching
    assert not r["penetrating"].any()
    assert torch.equal(r["depth"], torch.zeros(2, dtype=torch.float64))
    assert torch.equal(r["normal"], torch.zeros((2, 3), dtype=torch.float64))


def test_a_cube_has_six_faces_of_facets():
    """A cube's hull: its 8 corners, the 4 triples of each face's corners
    (24 facets, normals the 6 axes), and every pair on a face (12 edges
    and 12 face diagonals); nothing inside it."""
    cand, tri, normals, facet, edges, edge = rpf.hull_facets(
        _cube((0.1, 0, 0), 0.5)[None])
    assert cand.shape == (1, 8, 3) and tri.shape == (1, 24, 3)
    assert bool(facet.all()) and bool(edge.all())
    axes = {tuple(n) for n in normals[0].round(decimals=12).tolist()}
    assert axes == {tuple(s * e for e in row) for row in torch.eye(
        3, dtype=torch.float64).tolist() for s in (1.0, -1.0)}
    assert edges.shape == (1, 24, 2)


@pytest.mark.parametrize("vertices", [8, 12, 24])
def test_facets_agree_with_the_brute_force_reference(vertices):
    """16 deep lanes: the same depths within 1e-12 (float64 rounding at
    coordinates of order 2, with room), the same penetrating lanes, and the
    facet reference's normal meets the brute-force depth; at 8 vertices
    some small hulls poke out."""
    p1, p2 = (p.double() for p in _deep(5 + vertices, 16, vertices))
    want = rp.penetration(p1, p2)
    got = rpf.penetration(p1, p2)
    assert torch.equal(got["penetrating"], want["penetrating"])
    assert float((got["depth"] - want["depth"]).abs().max()) < 1e-12
    inside = want["penetrating"]
    h = rp.minkowski_height(p1[inside], p2[inside], got["normal"][inside])
    assert float((h - want["depth"][inside]).abs().max()) < 1e-12


def test_the_probe_drops_only_inner_vertices():
    """At 255 vertices the probe leaves a few dozen candidates a hull, and
    the facets over them (about 2 V - 4 for V hull vertices) leave every
    vertex of the cloud, dropped ones included, on their inner side."""
    p1, _ = _deep(3, 4, 255)
    p1 = p1.double()
    cand, tri, normals, facet, _, edge = rpf.hull_facets(p1)
    assert 4 <= cand.shape[1] < 128
    for p, c, t, n, f in zip(p1, cand, tri, normals, facet):
        t, n = t[f], n[f]
        assert t.shape[0] > 0
        side = p @ n.T - (c[t[:, 0]] * n).sum(1)
        assert float(side.max()) < 1e-12
    assert bool((edge.sum(1) < 3 * cand.shape[1]).all())


def test_port_against_the_facet_reference_at_255_vertices():
    """The port's CPU path (K1's and K2's plain versions, as on the card:
    the team of 32 and the streamed K1 compute the same rows) on 8 deep
    pairs of 255-vertex hulls.  Tolerance 2e-5: EPA stops once a probe
    gains less than eps_coincide (1e-5), so its depth and its face
    normal's support height lie within that gain of the exact depth, and
    float32 rounding at coordinates of order 2 adds ~1e-6."""
    p1, p2 = _deep(7, 8, 255)
    out = fused_gjkepa_hulls(p1, p2, cfg=GJKEPAConfig.for_f32())
    r = rpf.penetration(p1, p2)
    assert bool(r["penetrating"].all())
    assert torch.equal(out.hit, r["penetrating"])
    assert bool((out.status == Status.HIT).all())
    assert float((out.depth.double() - r["depth"]).abs().max()) < 2e-5
    excess = rp.minkowski_height(p1, p2, out.normal) - r["depth"]
    assert float(excess.abs().max()) < 2e-5


def _small(seed):
    return run.Setup(spec.cell(CELL), seed, torch.device("cpu"), pairs=4,
                     pool=2)


def test_cell_runs_small_and_correct():
    result, lines = run.run_cell(spec.cell(CELL), 2 ** 33 + 5, 0.3, False,
                                 torch.device("cpu"), time.perf_counter(),
                                 lambda m: None, pairs=4, pool=2)
    assert result["correct"] is True, result["check"]
    assert list(result["check"]) == ["depth_err", "normal_excess"]
    assert all(line.endswith(" ok") for line in lines)
    assert set(result["metrics"]) == {"pair_queries_per_s", "call_p95_ms",
                                      "setup_s"}


def test_cell_control_fails_every_compared_number():
    s = _small(13)
    kept = window.run(s.call, s.pool, s.device, s.in_flight, calls=4,
                      keep=4).kept
    limits = spec.cell(CELL).traffic["check"]["limits"]
    got = s.readings(kept, 13)
    assert got["reference_lanes"] == 16
    assert got["epa_status_off_share"] == 0.0
    assert check.judge(got, limits)[0] is True
    correct, numbers = check.judge(s.readings(kept, 13, control=True), limits)
    assert correct is False
    assert all(c["value"] > c["limit"] for c in numbers.values()), numbers


def test_readings_take_only_the_lanes_asked_for():
    s = _small(3)
    kept = window.run(s.call, s.pool, s.device, s.in_flight, calls=2,
                      keep=2).kept
    got = s.query.readings(kept, s.pool, {"reference_lanes": 3},
                           np.random.default_rng(0))
    assert got["reference_lanes"] == 3


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, torch, benchmark.reference_penetration_facets; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'gjkepa_tpu', 'gjkepa_tpu_torch', 'native')), "
            "torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT).stdout
    assert out.strip() == "[] False False"


def test_pool_keeps_its_claim_counter_before_the_masks(monkeypatch):
    """K2's pool (a stand-in library's facts, no card): two int32 words
    before the slot masks, zeroed with them, the claim counter the kernel
    adds to at ``mask[-2]``, which ``pool_claims`` reads, and the carry
    counter at ``mask[-1]``, which ``tier_carries`` reads, each summed over
    the device's pools."""
    library = types.SimpleNamespace(epa_scratch_words_per_face=lambda: 17)
    monkeypatch.setattr(fused_epa._build, "load", lambda: library)
    monkeypatch.setattr(fused_epa, "_POOLS", {})
    cpu = torch.device("cpu")
    facts = fused_epa.K2Device(blocks=16, hits=1, sm_bytes=233472,
                               reserve=1024, slots=64, sm_ids=132)
    faces, mask = fused_epa.k2_pool(cpu, 208, facts)
    assert mask.shape == (132, 2) and not mask.any()
    assert fused_epa.pool_claims(cpu) == fused_epa.tier_carries(cpu) == 0
    counter = mask.as_strided((1,), (1,), 0)
    carries = mask.as_strided((1,), (1,), 1)
    assert mask.data_ptr() == counter.data_ptr() + 8
    assert mask.data_ptr() == carries.data_ptr() + 4
    assert mask.untyped_storage().nbytes() == 4 * (2 + mask.numel())
    counter += 5
    carries += 7
    assert fused_epa.pool_claims(cpu) == fused_epa.pool_claims() == 5
    assert fused_epa.tier_carries(cpu) == fused_epa.tier_carries() == 7
    assert fused_epa.k2_pool(cpu, 208, facts)[1] is mask
    assert fused_epa.pool_claims(torch.device("cuda", 0)) == 0
    assert fused_epa.tier_carries(torch.device("cuda", 0)) == 0


def test_pool_without_pooled_tiers_keeps_its_counters(monkeypatch):
    """Where every tier stays in shared memory (``far_faces`` 0), K2's
    pool has no face store but keeps its masks and both counters, so that
    every launch counts its carries; the counters add to those of the
    device's other pools."""
    library = types.SimpleNamespace(epa_scratch_words_per_face=lambda: 17)
    monkeypatch.setattr(fused_epa._build, "load", lambda: library)
    monkeypatch.setattr(fused_epa, "_POOLS", {})
    cpu = torch.device("cpu")
    facts = fused_epa.K2Device(blocks=16, hits=1, sm_bytes=233472,
                               reserve=1024, slots=64, sm_ids=132)
    faces, mask = fused_epa.k2_pool(cpu, 0, facts)
    assert faces is None
    assert mask.shape == (132, 2) and not mask.any()
    assert mask.untyped_storage().nbytes() == 4 * (2 + mask.numel())
    mask.as_strided((1,), (1,), 1).add_(3)
    other = fused_epa.k2_pool(cpu, 208, facts)[1]
    other.as_strided((1,), (1,), 1).add_(4)
    assert fused_epa.tier_carries(cpu) == 7
    assert fused_epa.pool_claims(cpu) == 0


K2_32 = ("void gjkepa::(anonymous namespace)::epa_hulls_kernel<32>(float "
         "const*, float const*)")
K1_STREAMED = ("void gjkepa::(anonymous namespace)::gjk_hulls_kernel<8, "
               "true, false>(float const*, float const*)")


def _view(device_ops, least_s=None):
    return trace.View(calls=2, device_ops=device_ops, window_s=1e-3,
                      busy_s=1e-4, host_s=[1e-3], least_s=least_s or {},
                      program_kernels=frozenset({"epa_hulls_kernel",
                                                 "gjk_hulls_kernel"}))


def _read(name, view):
    return spec.load_module("metrics", name).read(view)


@pytest.mark.parametrize("name,want", [("k2_device_ms", 0.3),
                                       ("k2_roofline", 5.0)])
def test_k2_readers_read_the_cells_32_lane_kernel(name, want):
    """The cell lists the accepted K2 readers, which read its one K2
    instantiation, the 32-lane one, as they read the 16-lane one of
    ``deep_penetration``."""
    assert name in [m["name"] for m in spec.cell(CELL).per_layer]
    ops = [(K2_32, 0, 300), (K2_32, 400, 700),
           ("epa_hulls_big_kernel", 0, 999), (K1_STREAMED, 0, 50)]
    assert _read(name, _view(ops, {"epa_hulls": 3e-5})) == pytest.approx(
        want)
    assert _read(name, _view(ops[2:], {"epa_hulls": 1.0})) is None


def test_k1_roofline_reads_the_cells_streamed_kernel():
    """The cell lists the accepted ``k1_roofline``, which reads K1's
    streamed instantiation (every K1 launch of the cell) as it reads the
    staged one of ``overlap``."""
    assert "k1_roofline" in [m["name"] for m in spec.cell(CELL).per_layer]
    ops = [(K1_STREAMED, 0, 200), (K1_STREAMED.replace("true, false",
                                                       "false, false"),
                                   300, 500), ("gjk_hulls_big_kernel", 0, 999)]
    view = _view(ops, {"gjk_hulls": 4e-5})
    assert _read("k1_roofline", view) == pytest.approx(10.0)
    assert _read("k1_roofline", _view(ops[2:], {"gjk_hulls": 1.0})) is None


def test_k2_pool_claims_per_call(monkeypatch):
    monkeypatch.setattr(fused_epa, "LAUNCHES_BY_TEAM", {16: 2, 32: 8})
    monkeypatch.setattr(fused_epa, "pool_claims", lambda dev=None: 25)
    view = _view([(K2_32, 0, 50)])
    assert _read("k2_pool_claims_per_call", view) == 2.5
    assert _read("k2_pool_claims_per_call", _view([])) is None
    monkeypatch.setattr(fused_epa, "LAUNCHES_BY_TEAM", {16: 0, 32: 0})
    assert _read("k2_pool_claims_per_call", view) is None
    # a program without the counter: no value
    monkeypatch.setattr(fused_epa, "LAUNCHES_BY_TEAM", {16: 2, 32: 8})
    monkeypatch.delattr(fused_epa, "pool_claims")
    assert _read("k2_pool_claims_per_call", view) is None


def test_k2_carries_per_call(monkeypatch):
    """The pool's carry counter over K2's launches, both over the process;
    None without device operations or K2 launches, and for a program
    without the counter (the parent of the carry)."""
    monkeypatch.setattr(fused_epa, "LAUNCHES_BY_TEAM", {16: 2, 32: 8})
    monkeypatch.setattr(fused_epa, "tier_carries", lambda dev=None: 285000)
    view = _view([(K2_32, 0, 50)])
    assert _read("k2_carries_per_call", view) == 28500.0
    assert _read("k2_carries_per_call", _view([])) is None
    monkeypatch.setattr(fused_epa, "LAUNCHES_BY_TEAM", {16: 0, 32: 0})
    assert _read("k2_carries_per_call", view) is None
    monkeypatch.setattr(fused_epa, "LAUNCHES_BY_TEAM", {16: 2, 32: 8})
    monkeypatch.delattr(fused_epa, "tier_carries")
    assert _read("k2_carries_per_call", view) is None


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _k2_args(dev, seed, pairs, vertices):
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    from gjkepa_tpu_torch.ops.fused_gjk import gjk_hulls
    g = torch.Generator(device=dev).manual_seed(seed)
    p1 = traffic.draw_side(g, pairs, vertices, 2.0, 0.0, dev)
    p2 = traffic.draw_side(g, pairs, vertices, 0.5, 0.2, dev)
    cfg = round_cfg(GJKEPAConfig.for_f32())
    gr = gjk_hulls(p1, p2, cfg, True)
    order, n_act = hit_first_order(gr.hit)
    return (p1, p2, gr.simplex, gr.status, order, n_act, cascade_plan(cfg))


def _tallied(args, **variant):
    """K2 under a tally: (rows, tally as a list, the pool counter's claims
    in the launch); its pool's masks end clear."""
    dev = args[0].device
    claims = fused_epa.pool_claims(dev)
    with fused_epa.k2_tally(dev) as tally:
        rows = (fused_epa._epa_cascade_cuda(*args, **variant) if variant
                else fused_epa.epa_cascade(*args))
    torch.cuda.synchronize(dev)
    assert not any(bool(m.any()) for _, m in fused_epa._POOLS.values())
    return rows, tally.tolist(), fused_epa.pool_claims(dev) - claims


@pytest.mark.cuda
def test_k2_at_255_vertices_on_32_lanes_is_bit_equal_to_plain():
    """The cell's hulls through K2's dispatcher: 32 lanes a hit, at least
    16,384 hits, rows bit for bit against the plain cascade, with no host
    read; the tally counts every hit once and the pool's counter its
    claims."""
    dev = _card()
    args = _k2_args(dev, 2 ** 31 + 29, 16448, 255)
    assert int(args[5]) >= 16384
    reads, launches = fused_epa.STORE_READS, fused_epa.LAUNCHES_BY_TEAM[32]
    rows, tally, claims = _tallied(args)
    assert fused_epa.STORE_READS == reads
    assert fused_epa.LAUNCHES_BY_TEAM[32] == launches + 1
    assert sum(tally[:fused_epa.MAX_TIERS]) == int(args[5])
    assert claims == tally[fused_epa.TALLY_CLAIMS]
    want = fused_epa.epa_cascade_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(rows, want))


@pytest.mark.cuda
@pytest.mark.parametrize("team", [16, 32])
def test_pool_counter_equals_the_tallys_claims(team):
    """Every tier in the pool (``near_faces`` 0): each of 8,192 deep hits
    claims a slot, and the counter and the tally both count every one; on
    ``deep_penetration``'s mix at the default ladder the counter equals
    the tally's claims, the few hits that pass the shared tiers."""
    dev = _card()
    args = _k2_args(dev, 2 ** 31 + 31, 8192, 24)
    rows, tally, claims = _tallied(args, near_faces=0, team=team)
    assert claims == tally[fused_epa.TALLY_CLAIMS] == int(args[5])
    args = _k2_args(dev, 2 ** 31 + 37, 65536, 24)
    rows, tally, claims = _tallied(args)
    assert claims == tally[fused_epa.TALLY_CLAIMS]
    assert claims <= sum(tally[1:fused_epa.MAX_TIERS])
