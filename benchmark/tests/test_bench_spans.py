"""The readers of the program's spans (``benchmark/spans.py``:
``kernel_host_ms``, ``glue_host_ms``, ``program_idle_share``) on made-up
views, and their host operations found inside ``run.per_layer``."""

import types

import pytest

from benchmark import run, spans, spec, trace, window

from .conftest import CELLS, SMALL

KERNEL = ("void gjkepa::(anonymous namespace)::distance_hulls_kernel<4>"
          "(float const*)")


def _view(host_ops=None, **kw):
    args = dict(calls=2, device_ops=[(KERNEL, 0, 10)], window_s=1e-3,
                busy_s=10e-6, host_s=[0.001], least_s={},
                program_kernels=frozenset({"distance_hulls_kernel"}))
    args.update(kw)
    view = trace.View(**args)
    if host_ops is not None:
        view.host_ops = host_ops
    return view


def _read(name, view):
    return spec.load_module("metrics", name).read(view)


def _call(t0, k8=(10, 20, 10), order=(45, 55)):
    """One ``bench.call`` at ``t0`` with the distance query's spans; the
    first K8 span, from ``k8[0]`` to ``k8[1] + k8[2]``, holds a (made-up)
    nested glue span of the last ``k8[2]`` µs."""
    a, b, nested = k8
    return [("bench.call", t0, t0 + 100),
            ("gjkepa.fused_gjk_distance_hulls", t0 + 2, t0 + 98),
            ("gjkepa.k8", t0 + a, t0 + b + nested),
            ("gjkepa.fill", t0 + b, t0 + b + nested),
            ("gjkepa.order", t0 + order[0], t0 + order[1]),
            ("aten::cumsum", t0 + 46, t0 + 48),
            ("gjkepa.k8", t0 + 60, t0 + 90)]


def test_self_time_leaves_out_nested_program_spans():
    rows = spans.program_spans(_call(0))
    got = {(n, s): self_us for n, s, _, self_us in rows}
    # the entry (96 µs) less its three direct children (20 + 10 + 30);
    # K8 less the nested fill;
    # an aten op counts in no program span's children
    assert got == {("gjkepa.fused_gjk_distance_hulls", 2): 36,
                   ("gjkepa.k8", 10): 10, ("gjkepa.fill", 20): 10,
                   ("gjkepa.order", 45): 10, ("gjkepa.k8", 60): 30}


@pytest.mark.parametrize("name, sums_us", [
    ("kernel_host_ms", (40, 50, 55)), ("glue_host_ms", (20, 20, 5))])
def test_host_readers_take_the_median_over_calls(name, sums_us):
    # three calls whose first K8 holds 10, 20 and 25 µs of its own, whose
    # fill runs 10, 10 and 5 µs and whose order runs 10, 10 and 0 µs; a
    # program span outside every call is left out
    ops = (_call(0) + _call(1000, k8=(10, 30, 10))
           + _call(2000, k8=(10, 35, 5), order=(45, 45))
           + [("gjkepa.k8", 5000, 9000)])
    want = sorted(sums_us)[1] / 1e3
    assert _read(name, _view(ops)) == pytest.approx(want)


def test_host_readers_read_nothing_without_spans_or_device_ops():
    plain = [("bench.call", 0, 100), ("aten::empty", 10, 20)]
    for name in ("kernel_host_ms", "glue_host_ms", "program_idle_share"):
        assert _read(name, _view(plain)) is None, name
        assert _read(name, _view(_call(0), device_ops=[])) is None, name
        assert _read(name, _view([])) is None, name


def test_program_idle_share_is_the_exact_overlap():
    dev = [(KERNEL, 0, 10), ("Memset (Device)", 20, 30), (KERNEL, 50, 60),
           (KERNEL, 55, 58)]
    # idle (10, 20) and (30, 50): 30 µs; the entries cover 15-25 and 32-40
    # (two spans, the second nested in a third), 5 + 8 µs of it
    host = [("bench.call", 0, 100),
            ("gjkepa.fused_gjkepa_hulls", 15, 25),
            ("gjkepa.gjkepa_batch_fused", 32, 40),
            ("gjkepa.fused_gjkepa_hulls", 33, 39),
            ("gjkepa.k1", 40, 48), ("aten::empty", 12, 19)]
    got = _read("program_idle_share", _view(host, device_ops=dev))
    assert got == pytest.approx(100.0 * 13 / 30)
    busy = [(KERNEL, 0, 10), (KERNEL, 10, 20)]
    assert _read("program_idle_share", _view(host, device_ops=busy)) is None
    assert _read("program_idle_share", _view(
        [("gjkepa.k1", 12, 18)], device_ops=dev)) is None


def test_overlap_and_merge():
    assert spans.merged([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
    assert spans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_us([], [(0, 1)]) == 0


def test_host_ops_from_the_callers_frame():
    """A view without the field: the ops the caller holds beside it."""
    view = _view()
    host_ops = _call(0)
    assert _read("kernel_host_ms", view) == pytest.approx(0.04)
    assert spans.host_ops(view) is host_ops
    assert spans.host_ops(_view()) == []


def test_per_layer_hands_the_readers_its_host_ops(cpu, monkeypatch):
    """A small traced run on the CPU through ``run.per_layer``: a reader
    finds the traced window's host operations, the program's spans among
    them, one K1 span in each call."""
    s = run.Setup(spec.cell(CELLS[0]), 2 ** 31 + 3, cpu, **SMALL)
    r = window.run(s.call, s.pool, cpu, s.in_flight, calls=2)
    seen = []

    def read(view):
        seen.append(list(spans.host_ops(view)))
        return None

    monkeypatch.setattr(spec, "load_module",
                        lambda *a: types.SimpleNamespace(read=read))
    metrics, _, _ = run.per_layer(s, r, lambda msg: None, calls=2)
    assert metrics == {} and seen
    names = [n for n, _, _ in seen[0]]
    assert names.count("bench.call") == names.count("gjkepa.k1") >= 2
    assert "gjkepa.fill" in names and "gjkepa.fused_gjkepa_hulls" in names
