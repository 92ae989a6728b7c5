"""The port's bench, ``gjkepa_tpu_torch.bench``, on the CPU.

  * its import leaves jax and gjkepa_tpu out, and without a card it runs
    nothing;
  * its keys are root ``bench.py``'s (an ``ast`` walk of its ``results``
    assignments);
  * its inputs are ``bench.py``'s draws bit for bit, replayed here with
    ``bench.random_hulls`` and the JAX package's shape constructors;
  * its timer, on a fake clock: K doubles from ``k0`` until a run lasts
    0.4 s or K reaches ``kmax``, one host read a run, warm-up untimed;
  * each config function at a small size (64 pairs, 8 and 27 boxes)
    through the plain versions, with a timer that calls each query once;
    its diagnostics against the JAX package's same calls (interpret mode),
    hit counts, hit fraction and max EPA iterations exact, mean EPA
    iterations and contact points a hit within 1% (FMA: ROADMAP Queue 3);
  * ``main``'s filter, key check and output line.
"""

import ast
import importlib.util
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from gjkepa_tpu import GJKEPAConfig as JaxConfig
from gjkepa_tpu import gjkepa as jax_gjkepa
from gjkepa_tpu import manifold_batch as jax_manifold_batch
from gjkepa_tpu.api import gjkepa_batch_fused as jax_batch_fused
from gjkepa_tpu.models import (boxes, capsules, concat_shapes, cylinders,
                               spheres)
from gjkepa_tpu.models.shapes import ShapeBatch as JaxShapes
from gjkepa_tpu.ops import fused as jfused
from gjkepa_tpu_torch import GJKEPAConfig, ShapeBatch, bench
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.parallel import pair_mesh
from gjkepa_tpu_torch.sim import SimConfig, init_boxes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CFG = GJKEPAConfig.for_f32()
JAX_CFG = JaxConfig.for_f32()
SHAPE_FIELDS = ("kind", "params", "pos", "rot")


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.cpu().numpy()


def _same_shapes(port: ShapeBatch, ref) -> None:
    for f in SHAPE_FIELDS:
        got, want = _np(getattr(port, f)), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


# -- the package boundary -----------------------------------------------------

def test_import_leaves_jax_out_and_no_card_runs_nothing():
    code = ("import sys, gjkepa_tpu_torch.bench; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'gjkepa_tpu.')) "
            "or m == 'gjkepa_tpu'); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run([sys.executable, "-m", "gjkepa_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_keys_are_bench_py_results_keys():
    """bench.py's ``results[...] = ...`` keys, the f-strings expanded over
    its loops: ``tag`` over hull4k/hull64k, ``seed`` over 0-2."""
    loops = {"tag": ("hull4k", "hull64k"), "seed": (0, 1, 2)}
    keys = []
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "results"):
            continue
        key = node.targets[0].slice
        if isinstance(key, ast.Constant):
            keys.append(key.value)
            continue
        names = [v.value.id for v in key.values
                 if isinstance(v, ast.FormattedValue)]
        template = "".join(v.value if isinstance(v, ast.Constant)
                           else "{" + v.value.id + "}" for v in key.values)
        keys += [template.format(**dict(zip(names, values)))
                 for values in itertools.product(*(loops[n] for n in names))]
    assert len(keys) == len(set(keys)) == len(bench.KEYS) == 20
    assert sorted(keys) == sorted(bench.KEYS)


# -- the inputs: bench.py's draws bit for bit ---------------------------------

def _mk3(seed_rng, B3=65536):
    """bench.py:203-212, with the JAX package's constructors."""
    q = B3 // 4
    pos = lambda: seed_rng.normal(size=(q, 3)).astype(np.float32) * 1.2  # noqa
    u = lambda size=q: seed_rng.random(size).astype(np.float32)  # noqa
    return concat_shapes(
        spheres(0.4 + 0.4 * u(), pos=pos()),
        boxes(0.3 + 0.4 * u((q, 3)), pos=pos()),
        capsules(0.2 + 0.2 * u(), 0.3 + 0.3 * u(), pos=pos()),
        cylinders(0.2 + 0.3 * u(), 0.3 + 0.3 * u(), pos=pos()),
    )


def _c3b_and_c4(rb, rng):
    """bench.py:257-282 from ``rng`` where it stands."""
    hulls_m = rb.random_hulls(rng, 16384, 24)
    qm = 4096
    posm = lambda: rng.normal(size=(qm, 3)).astype(np.float32) * 0.8  # noqa
    shm = concat_shapes(
        spheres(0.3 + 0.4 * rng.random(qm).astype(np.float32), pos=posm()),
        boxes(0.25 + 0.3 * rng.random((qm, 3)).astype(np.float32), pos=posm()),
        capsules(0.2 + 0.2 * rng.random(qm).astype(np.float32),
                 0.25 + 0.25 * rng.random(qm).astype(np.float32), pos=posm()),
        cylinders(0.2 + 0.25 * rng.random(qm).astype(np.float32),
                  0.25 + 0.25 * rng.random(qm).astype(np.float32), pos=posm()),
    )
    big = rb.random_hulls(rng, 16384, 24, spread=0.0) * 2.0
    small = rb.random_hulls(rng, 16384, 24, spread=0.0) * 0.5
    small += rng.normal(size=(16384, 1, 3)).astype(np.float32) * 0.2
    return (hulls_m, shm), (big, small)


@pytest.fixture(scope="module")
def hull_draws():
    """An unfiltered run's draws of c2, c3b and c4 from bench.py's one
    generator (bench.py:141, :171-173, :257-282)."""
    rb = _root_bench()
    rng = np.random.default_rng(0)
    c2 = {tag: (rb.random_hulls(rng, b, 64), rb.random_hulls(rng, b, 64))
          for tag, b in (("hull4k", 4096), ("hull64k", 65536))}
    return rb, c2, *_c3b_and_c4(rb, rng)


def test_c2_inputs_are_bench_draws(hull_draws):
    _, c2, _, _ = hull_draws
    got = list(bench.c2_inputs("cpu"))
    assert [g[0] for g in got] == ["hull4k", "hull64k"]
    for tag, p1, p2 in got:
        for x, want in zip((p1, p2), c2[tag]):
            assert x.dtype == torch.float32
            np.testing.assert_array_equal(_np(x), want, err_msg=tag)


def test_c3_inputs_are_bench_draws():
    """Seeds 0-2 (bench.py:216-218), then seed 0 shuffled (:240-246)."""
    got = bench.c3_inputs("cpu")
    for seed in (0, 1, 2):
        srng = np.random.default_rng(seed)
        tag, a, b = next(got)
        assert tag == f"seed{seed}"
        _same_shapes(a, _mk3(srng))
        _same_shapes(b, _mk3(srng))
    srng = np.random.default_rng(0)
    a, b = _mk3(srng), _mk3(srng)
    perm = srng.permutation(65536)
    b = type(b)(kind=b.kind[perm], params=b.params[perm],
                pos=b.pos[perm], rot=b.rot[perm])
    a = type(a)(kind=a.kind[perm], params=a.params[perm],
                pos=a.pos[perm], rot=a.rot[perm])
    tag, ga, gb = next(got)
    assert tag == "shuffled"
    _same_shapes(ga, a)
    _same_shapes(gb, b)
    assert next(got, None) is None


def test_c3b_inputs_are_bench_draws(hull_draws):
    _, _, (hulls, shapes), _ = hull_draws
    got_hulls, got_shapes = bench.c3b_inputs("cpu")
    np.testing.assert_array_equal(_np(got_hulls), hulls)
    _same_shapes(got_shapes, shapes)


def test_c4_inputs_are_the_unfiltered_draws(hull_draws):
    """The port's c4 pairs are an unfiltered bench.py run's whatever the
    filter (c4_inputs takes none); a filtered ``python bench.py c4`` draws
    others (the module docstring's documented difference)."""
    rb, _, _, (big, small) = hull_draws
    p1, p2 = bench.c4_inputs("cpu")
    np.testing.assert_array_equal(_np(p1), big)
    np.testing.assert_array_equal(_np(p2), small)
    _, (fbig, _) = _c3b_and_c4(rb, np.random.default_rng(0))
    assert not np.array_equal(fbig, big)


# -- the timer on a fake clock ------------------------------------------------

class HostReads(TorchFunctionMode):
    """Counts ``Tensor.item``, the timer's one way to read back."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.item:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def clock(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(bench, "perf_counter", lambda: now[0])
    return now


def _fake_query(clock, cost, untimed):
    """A query whose first ``untimed`` calls (the first call and the
    warm-up) take 1 s of the fake clock and the rest ``cost`` each."""
    calls = []

    def fn():
        calls.append(None)
        clock[0] += 1.0 if len(calls) <= untimed else cost
        return torch.ones(3)
    return fn, calls


@pytest.mark.parametrize("cost,k0,kmax,ks", [
    (1 / 16, 4, 4096, (4, 8)),                # 8 calls reach 0.5 s >= 0.4
    (2.0 ** -20, 2, 16, (2, 4, 8, 16)),       # kmax stops the doubling
])
def test_timer_doubles_k_with_one_read_a_run(clock, cost, k0, kmax, ks):
    warmup, reps = 7, 3
    fn, calls = _fake_query(clock, cost, 1 + warmup)
    with HostReads() as reads:
        t, first = bench.Timer("cpu").time(fn, lambda r: r, reps=reps,
                                           warmup=warmup, k0=k0, kmax=kmax)
    assert t == cost                         # no warm-up call in a window
    assert torch.equal(first, torch.ones(3))
    runs = len(ks) + reps - 1
    assert len(calls) == 1 + warmup + sum(ks) + ks[-1] * (reps - 1)
    assert reads.n == 1 + runs               # the first call's, one a run


def test_sync_latency_is_the_least_single_call(clock):
    costs = iter([0.5, 0.125, 0.25, 1.0, 0.375])

    def fn():
        clock[0] += next(costs)
        return torch.ones(1)
    with HostReads() as reads:
        t = bench.Timer("cpu").sync_latency(fn, lambda r: r)
    assert t == 0.125 and reads.n == 5


def test_profile_hook_writes_a_trace_only_when_asked(monkeypatch, tmp_path):
    timer = bench.Timer("cpu")
    monkeypatch.delenv("GJKEPA_PROFILE", raising=False)
    timer.profile("c9", lambda: torch.ones(4) * 2, lambda r: r)
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv("GJKEPA_PROFILE", str(tmp_path))
    timer.profile("c9", lambda: torch.ones(4) * 2, lambda r: r)
    trace = json.loads((tmp_path / "c9" / "trace.json").read_text())
    assert trace["traceEvents"]


# -- each config at a small size against the JAX package ----------------------

class OneCall:
    """The timer's interface with each query called once, then read back
    (host wall of that call)."""

    def time(self, fn, probe, **policy):
        t0 = time.perf_counter()
        r = fn()
        probe(r).sum().item()
        return max(time.perf_counter() - t0, 1e-9), r

    def sync_latency(self, fn, probe):
        return self.time(fn, probe)[0]

    def profile(self, name, fn, probe, calls=5):
        pass


def _positive(results, keys):
    assert list(results) == list(keys)
    for k, v in results.items():
        assert math.isfinite(v) and v > 0, (k, v)


def test_c1_matches_jax():
    p1, p2 = bench.c1_inputs("cpu")
    results, diag = bench.c1(OneCall(), p1, p2, CFG)
    _positive(results, bench.KEYS[:2])
    ref = jax_gjkepa(jnp.asarray(_np(p1)), jnp.asarray(_np(p2)), cfg=JAX_CFG)
    assert diag["hit"] and bool(ref.hit)
    assert abs(diag["depth"] - 0.5) < 1e-4
    assert abs(diag["depth"] - float(ref.depth)) <= 1e-6


def test_c2_small():
    rng = np.random.default_rng(3)
    pairs = [(tag, *(torch.from_numpy(fixtures.random_hulls(rng, 64, 16))
                     for _ in range(2))) for tag in ("hull4k", "hull64k")]
    results, diag = bench.c2(OneCall(), pairs, CFG)
    _positive(results, bench.KEYS[2:6])
    assert diag == {}


def test_c3_matches_jax():
    n = 64
    pairs = [(f"seed{s}", *fixtures.c3_pairs(s, n)) for s in (0, 1, 2)]
    pairs.append(("shuffled", *fixtures.c3_shuffled(0, n)[:2]))
    results, diag = bench.c3(OneCall(), [
        (tag, *(ShapeBatch.from_numpy(*p, device="cpu") for p in (a, b)))
        for tag, a, b in pairs], CFG)
    spread = results.pop("c3_seed_spread")
    assert math.isfinite(spread) and 0 <= spread < 1
    _positive(results, ("c3_seed0_qps", "c3_seed1_qps", "c3_seed2_qps",
                        "c3_shuffled_qps", "c3_analytic64k_qps"))
    for tag, a, b in pairs:
        ref = jfused.fused_gjkepa_shapes(
            *(JaxShapes(*(jnp.asarray(x) for x in p)) for p in (a, b)),
            cfg=JAX_CFG, interpret=True)
        want = {"hits": int(jnp.sum(ref.hit)),
                "max_epa_iters": int(jnp.max(ref.epa_iters))}
        assert diag[tag] == want, tag
    assert diag["seed0"]["hits"] > 0 and diag["seed0"]["max_epa_iters"] > 0
    assert diag["shuffled"] == diag["seed0"]


def test_c3b_small():
    hulls, shp = fixtures.hull_kind_pairs(0, 64, 24)
    results, diag = bench.c3b(OneCall(), torch.from_numpy(hulls),
                              ShapeBatch.from_numpy(*shp, device="cpu"), CFG)
    _positive(results, ("c3_mixed_hull_shape_qps",))
    assert diag == {}


@pytest.fixture(scope="module")
def deep64():
    return fixtures.deep_pairs(np.random.default_rng(0), 64, 24)


def test_c4_matches_jax(deep64):
    big, small = deep64
    results, diag = bench.c4(OneCall(), torch.from_numpy(big),
                             torch.from_numpy(small), CFG)
    _positive(results, ("c4_deep16k_qps", "c4_hit_fraction",
                        "c4_manifold_qps"))
    a, b = jnp.asarray(big), jnp.asarray(small)
    r = jax_batch_fused(a, b, cfg=JAX_CFG, interpret=True)
    m = jax_manifold_batch(a, b, r.normal, r.depth, r.hit, r.contact_point,
                           cfg=JAX_CFG)
    hits = float(jnp.sum(r.hit.astype(jnp.float32)))
    assert diag["hit_fraction"] == float(jnp.mean(r.hit.astype(jnp.float32)))
    assert results["c4_hit_fraction"] == diag["hit_fraction"]
    assert diag["max_epa_iters"] == int(jnp.max(r.epa_iters))
    np.testing.assert_allclose(
        diag["mean_epa_iters"],
        float(jnp.mean(r.epa_iters.astype(jnp.float32))), rtol=0.01)
    np.testing.assert_allclose(diag["points_per_hit"],
                               float(jnp.sum(m.mask)) / max(hits, 1.0),
                               rtol=0.01)
    assert hits > 0 and diag["points_per_hit"] >= 1


def test_c6_small(deep64):
    results, diag = bench.c6(OneCall(), pair_mesh(2, device="cpu"),
                             *(torch.from_numpy(x) for x in deep64), CFG)
    assert results.pop("c6_n_devices") == 2
    _positive(results, ("c6_sharded_fused_qps",))
    assert diag == {}


def test_c5_small():
    scenes = [(init_boxes(n, height=1.0, spread=2.5, device="cpu"),
               SimConfig(max_pairs=64)) for n in (8, 27)]
    results, diag = bench.c5(OneCall(), *scenes)
    _positive(results, bench.KEYS[-2:])
    assert diag == {}


# -- main ---------------------------------------------------------------------

def test_main_c1_on_the_cpu(capsys):
    assert bench.main(["c1"], device="cpu") == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "gjkepa_pair_queries_per_sec_64k_batch"
    assert line["unit"] == "queries/s"
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert list(line["configs"]) == list(bench.KEYS[:2])
    assert all(v > 0 for v in line["configs"].values())
    depth = float(re.search(r"depth=([0-9.]+)\)", err).group(1))
    assert abs(depth - 0.5) < 1e-4


def test_main_without_a_card_runs_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


@pytest.fixture
def stub_configs(monkeypatch):
    """Every config and input maker replaced by a stub that records its
    run and returns its keys (1.0 each); returns the run list."""
    ran = []
    prefixes = {"c1": "c1_", "c2": "c2_", "c3": "c3_", "c3b": "c3_mixed",
                "c4": "c4_", "c6": "c6_", "c5": "c5_"}

    def stub(name):
        def config(*args):
            ran.append(name)
            keys = [k for k in bench.KEYS if k.startswith(prefixes[name])]
            if name == "c3":
                keys.remove("c3_mixed_hull_shape_qps")
            return {k: 1.0 for k in keys}, {}
        return config

    for name in prefixes:
        monkeypatch.setattr(bench, name, stub(name))
        if name != "c6":
            monkeypatch.setattr(bench, f"{name}_inputs", lambda dev: ())
    return ran


@pytest.mark.parametrize("argv,runs", [
    ([], ["c1", "c2", "c3", "c3b", "c4", "c6", "c5"]),
    (["c3"], ["c3", "c3b"]),
    (["c4", "c2", "-v"], ["c2", "c4"]),
    (["c3b"], ["c3b"]),
])
def test_main_filter_and_output(stub_configs, capsys, argv, runs):
    assert bench.main(argv, device="cpu") == 0
    line = json.loads(capsys.readouterr().out)
    assert stub_configs == runs
    want = [k for k in bench.KEYS
            if any(k.startswith({"c3b": "c3_mixed"}.get(r, r + "_"))
                   and not (r == "c3" and k == "c3_mixed_hull_shape_qps")
                   for r in runs)]
    assert list(line["configs"]) == want
    assert line["value"] == (1.0 if "c3" in runs else 0.0)
    assert line["vs_baseline"] == line["value"] / 50e6


def test_main_refuses_a_short_unfiltered_run(stub_configs, monkeypatch):
    monkeypatch.setattr(bench, "c5", lambda *a: ({}, {}))
    with pytest.raises(AssertionError, match="bench.py's"):
        bench.main([], device="cpu")
