"""The penetration cell's plain reference and check, small on the CPU.

``benchmark/reference_penetration.py`` gives the exact penetration depth
and normal of two vertex clouds by brute-force separation in float64.  Here
it is held against closed forms (overlapping cubes, a cube inside a cube,
separated cubes) and against the frozen float64 oracle
(``benchmark/oracle.py``); the port's ``fused_gjkepa_hulls`` (its plain
versions on CPU tensors) is held against it; the cell
``hull24_64k.deep_penetration`` runs small through the harness, correct,
while its bfloat16 control fails every compared number; K13's host read
of the hit count (``fused_epa.face_stores``, which K2 no longer takes:
its far tiers run in a pool no host read sizes) is counted and spanned;
and the cell's two new metric readers read made-up traces.  One test,
marked ``cuda``, runs K2 at the cell's 65,536 hits on the card:

    python -m pytest tests/test_penetration_reference.py -q -m cuda \
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

from benchmark import check, reference_penetration as rp, run, spec, trace
from benchmark import traffic, window
from gjkepa_tpu_torch import GJKEPAConfig, fused_gjkepa_hulls
from gjkepa_tpu_torch.ops import fused_epa
from gjkepa_tpu_torch.ops.fused import cascade_plan, round_cfg
from gjkepa_tpu_torch.types import Status

CELL = "hull24_64k.deep_penetration"
H100_LIMIT = 232_448     # an H100 block's opt-in shared memory


def _cube(center, half):
    return torch.tensor([[c + s * half for c, s in zip(center, signs)]
                         for signs in itertools.product((-1, 1), repeat=3)],
                        dtype=torch.float64)


def _pairs(pairs):
    a = torch.stack([_cube(*p[0]) for p in pairs])
    b = torch.stack([_cube(*p[1]) for p in pairs])
    return rp.penetration(a, b)


def _deep(seed, pairs, vertices):
    """The cell's recipe (``deep_penetration.json``'s sides) on the CPU."""
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
    0.25 - max |center_i|, along the axis nearest a face.  At the centre
    every axis ties; the first candidate, A's first face (x), is kept."""
    r = _pairs([(((0, 0, 0), 1.0), (center, 0.25))])
    assert float(r["depth"][0]) == pytest.approx(depth, abs=1e-15)
    assert torch.equal(r["normal"][0].abs(),
                       torch.tensor(normal, dtype=torch.float64).abs())
    # a tied normal is judged by its support height, which every tie meets
    h = rp.minkowski_height(_cube((0, 0, 0), 1.0)[None],
                            _cube(center, 0.25)[None], r["normal"])
    assert float(h[0]) == pytest.approx(depth, abs=1e-15)


def test_separated_cubes_do_not_penetrate():
    r = _pairs([(((0, 0, 0), 0.5), ((1.5, 0, 0), 0.5)),
                (((0, 0, 0), 0.5), ((1.0, 0, 0), 0.5))])    # touching
    assert not r["penetrating"].any()
    assert torch.equal(r["depth"], torch.zeros(2, dtype=torch.float64))


def test_reference_agrees_with_the_oracle():
    """16 deep pairs of 24 vertices: the oracle's EPA stops on an unchanged
    polytope, a facet of A - B, so both give the exact depth; 1e-12 is
    float64 rounding at coordinates of order 2, with room."""
    from benchmark import oracle
    p1, p2 = (p.double() for p in _deep(5, 16, 24))
    r = rp.penetration(p1, p2)
    depth, normal = [], []
    for a, b in zip(p1.numpy(), p2.numpy()):
        o = oracle.gjkepa_oracle(a, b)
        assert o.hit and not o.epa_capped
        depth.append(o.depth)
        normal.append(torch.from_numpy(o.normal))
    assert bool(r["penetrating"].all())
    gap = (torch.tensor(depth, dtype=torch.float64) - r["depth"]).abs()
    assert float(gap.max()) < 1e-12
    h = rp.minkowski_height(p1, p2, torch.stack(normal))
    assert float((h - r["depth"]).abs().max()) < 1e-12


@pytest.mark.parametrize("vertices", [8, 24])
def test_port_against_the_reference(vertices):
    """The port's CPU path (K1's and K2's plain versions) on 64 deep pairs.
    Tolerance 2e-5: EPA stops once a probe gains less than eps_coincide
    (1e-5), so its depth and its face normal's support height lie within
    that gain of the exact depth, and float32 rounding adds ~1e-6.  At 8
    vertices some small hulls poke out: those read depth 0 on both sides
    when they miss."""
    p1, p2 = _deep(7, 64, vertices)
    out = fused_gjkepa_hulls(p1, p2, cfg=GJKEPAConfig.for_f32())
    r = rp.penetration(p1, p2)
    assert torch.equal(out.hit, r["penetrating"])
    assert bool((out.status[out.hit] == Status.HIT).all())
    depth = torch.where(out.hit, out.depth.double(), 0.0)
    assert float((depth - r["depth"]).abs().max()) < 2e-5
    inside = r["penetrating"]
    excess = rp.minkowski_height(p1[inside], p2[inside], out.normal[inside]) \
        - r["depth"][inside]
    assert float(excess.abs().max()) < 2e-5


def _small(seed):
    return run.Setup(spec.cell(CELL), seed, torch.device("cpu"), pairs=32,
                     pool=2)


def test_cell_runs_small_and_correct():
    cpu = torch.device("cpu")
    result, lines = run.run_cell(spec.cell(CELL), 2 ** 31 + 17, 0.3, False,
                                 cpu, time.perf_counter(), lambda m: None,
                                 pairs=32, pool=2)
    assert result["correct"] is True, result["check"]
    assert list(result["check"]) == ["depth_err", "normal_excess"]
    assert all(line.endswith(" ok") for line in lines)
    assert set(result["metrics"]) == {"pair_queries_per_s", "call_p95_ms",
                                      "setup_s"}


def test_cell_control_fails_every_compared_number():
    s = _small(11)
    kept = window.run(s.call, s.pool, s.device, s.in_flight, calls=4,
                      keep=4).kept
    limits = spec.cell(CELL).traffic["check"]["limits"]
    got = s.readings(kept, 11)
    assert got["reference_lanes"] == 128
    assert got["epa_status_off_share"] == 0.0
    assert check.judge(got, limits)[0] is True
    correct, numbers = check.judge(s.readings(kept, 11, control=True), limits)
    assert correct is False
    assert all(c["value"] > c["limit"] for c in numbers.values()), numbers


def test_readings_take_only_the_lanes_asked_for():
    s = _small(3)
    kept = window.run(s.call, s.pool, s.device, s.in_flight, calls=2,
                      keep=2).kept
    got = s.query.readings(kept, s.pool, {"reference_lanes": 5},
                           np.random.default_rng(0))
    assert got["reference_lanes"] == 5


@pytest.fixture
def k2_store(monkeypatch):
    """``face_stores`` (K13's) over the default ladder on the CPU: an
    H100's shared memory limit and a stand-in of K13's block bytes (the
    probe exchange and one warp's scratch, 1,296 B, and 68 B a face), and a
    stand-in of the built library's face words."""
    monkeypatch.setattr(fused_epa._build, "smem_limit",
                        lambda dev: H100_LIMIT)
    library = types.SimpleNamespace(epa_scratch_words_per_face=lambda: 17)
    monkeypatch.setattr(fused_epa._build, "load", lambda: library)
    stages = cascade_plan(round_cfg(GJKEPAConfig.for_f32()))

    def stores(near_faces=None):
        before = fused_epa.STORE_READS
        hits = torch.tensor(300, dtype=torch.int32)
        near, far_faces, far = fused_epa.face_stores(
            stages, lambda f: 1296 + 68 * f, hits, torch.device("cpu"),
            near_faces)
        return fused_epa.STORE_READS - before, far_faces, far
    return stores


def test_default_ladder_reads_nothing_back(k2_store):
    assert k2_store() == (0, 0, None)


@pytest.mark.parametrize("near_faces", [0, 48, 88])
def test_a_spilled_tier_reads_the_hit_count_once(k2_store, near_faces):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reads, far_faces, far = k2_store(near_faces)
    assert (reads, far_faces) == (1, 208)
    assert far.shape == (300, 17, 208)
    names = [e.name for e in prof.events()]
    assert names.count("gjkepa.store_read") == 1


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference_penetration; print(sorted(m for m"
            " in sys.modules if m.split('.')[0] in ('jax', 'gjkepa_tpu', "
            "'gjkepa_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT).stdout
    assert out.strip() == "[]"


K2 = ("gjkepa::(anonymous namespace)::epa_hulls_kernel(float const*, "
      "float const*)")


def _view(device_ops, host_ops):
    view = trace.View(calls=2, device_ops=device_ops, window_s=1e-3,
                      busy_s=1e-4, host_s=[1e-3], least_s={},
                      program_kernels=frozenset({"epa_hulls_kernel"}))
    view.host_ops = host_ops
    return view


def _read(name, view):
    return spec.load_module("metrics", name).read(view)


def test_k2_device_ms_reads_k2_alone():
    ops = [(K2, 0, 300), (K2, 400, 700), ("epa_hulls_big_kernel", 0, 999)]
    assert _read("k2_device_ms", _view(ops, [])) == pytest.approx(0.3)
    assert _read("k2_device_ms", _view([("other", 0, 9)], [])) is None


def test_store_reads_per_call(monkeypatch):
    spans = [("bench.call", 0, 100), ("gjkepa.k2", 10, 90),
             ("gjkepa.store_read", 20, 30), ("bench.call", 100, 200),
             ("gjkepa.k2", 110, 190)]
    view = _view([(K2, 0, 50)], spans)
    assert _read("store_reads_per_call", view) == 0.5
    assert _read("store_reads_per_call", _view([(K2, 0, 50)], spans[:2])) == 0
    # a program without the counter has no span to read: no value
    monkeypatch.delattr(fused_epa, "STORE_READS")
    assert _read("store_reads_per_call", view) is None


@pytest.mark.cuda
def test_k2_at_the_cells_hits_on_card():
    """K2 over 65,536 deep hits (the cell's batch) bit for bit against its
    plain version on the same tensors, with no host read; its tally counts
    every hit once and its pool's masks end clear."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gjkepa_tpu_torch.ops.fused_gjk import gjk_hulls
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2 ** 31 + 3)
    p1 = traffic.draw_side(g, 65536, 24, 2.0, 0.0, dev)
    p2 = traffic.draw_side(g, 65536, 24, 0.5, 0.2, dev)
    cfg = round_cfg(GJKEPAConfig.for_f32())
    stages = cascade_plan(cfg)
    gr = gjk_hulls(p1, p2, cfg, True)
    order, n_act = hit_first_order(gr.hit)
    reads = fused_epa.STORE_READS
    with fused_epa.k2_tally(dev) as tally:
        k = fused_epa.epa_cascade(p1, p2, gr.simplex, gr.status, order,
                                  n_act, stages)
    assert fused_epa.STORE_READS == reads
    assert int(tally[:fused_epa.MAX_TIERS].sum()) == int(n_act)
    assert not any(bool(m.any()) for _, m in fused_epa._POOLS.values())
    plain = fused_epa.epa_cascade_plain(p1, p2, gr.simplex, gr.status, order,
                                        n_act, stages)
    assert int(n_act) > 65000
    assert all(torch.equal(x, y) for x, y in zip(k, plain))
