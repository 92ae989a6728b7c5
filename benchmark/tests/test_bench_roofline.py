"""The roofline counts from fixed iteration counts, the trace reductions on
made-up intervals, and the per-layer readers on a made-up view."""

import pytest
import torch

from benchmark import roofline, spec, trace

from .conftest import CELLS


def test_k1_bytes_bound():
    # 1,000 lanes of 24 + 24 vertices, all active, 5,000 GJK iterations
    t, by = roofline.k1(1000, 48, 1000, 5000)
    assert by == "bytes"
    assert t == pytest.approx(1000 * (48 * 12 + 61) / 3.35e12)
    ops = 1000 * 48 * 12 + (1000 * 6 + 5000) * 5 * 48 + 5000 * 400
    assert ops / 67e12 < t


def test_k2_operations_bound():
    t, by = roofline.k2(10, 48, 100000)
    assert by == "operations"
    assert t == pytest.approx(100000 * (5 * 48 + 48 * 20) / 67e12)


def test_k8():
    t, by = roofline.k8(65536, 128, 400000)
    ops = (65536 + 400000) * 5 * 128 + 400000 * 500
    assert t == pytest.approx(max(65536 * (128 * 12 + 34) / 3.35e12,
                                  ops / 67e12))


def test_query_least_s_sums_calls():
    contact = spec.load_module("queries", "contact")
    status = torch.tensor([3, 0, 2, 3], dtype=torch.int32)
    works = [(status, torch.tensor([4, 0, 6, 5], dtype=torch.int32),
              torch.tensor([9, 0, 0, 11], dtype=torch.int32),
              status == 3)] * 2
    got = contact.least_s(works, 48)
    assert got["gjk_hulls"] == pytest.approx(2 * roofline.k1(4, 48, 3, 15)[0])
    assert got["epa_hulls"] == pytest.approx(2 * roofline.k2(2, 48, 20)[0])
    clearance = spec.load_module("queries", "clearance")
    got = clearance.least_s([(torch.tensor([3, 4]),)], 128)
    assert got["distance_hulls"] == pytest.approx(roofline.k8(2, 128, 7)[0])


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 38), (50, 51)]
    assert trace.union_s(iv) == pytest.approx(31e-6)
    assert trace.gaps(iv) == [(20, 30), (40, 50)]
    assert trace.union_s([]) == 0.0


def test_breakdown_labels_gaps_by_innermost_host_op():
    dev = [("void gjk_hulls_kernel<16, true>(float const*)", 0, 10),
           ("Memset (Device)", 30, 31), ("void gjk_hulls_kernel<16, true>"
                                         "(float const*)", 40, 60)]
    host = [("bench.wait", 5, 45), ("cudaEventSynchronize", 8, 35),
            ("bench.call", 32, 39)]
    b = trace.breakdown(dev, host)
    assert b["device_ops"][0] == ["void gjk_hulls_kernel<16, true>",
                                  pytest.approx(30e-6)]
    assert b["idle_gaps"] == [["cudaEventSynchronize", pytest.approx(20e-6)],
                              ["bench.call", pytest.approx(9e-6)]]


def _view(**kw):
    args = dict(calls=2, device_ops=[], window_s=1e-3, busy_s=0.0,
                host_s=[0.001, 0.003, 0.002], least_s={},
                program_kernels=frozenset({"gjk_hulls_kernel",
                                           "epa_hulls_kernel"}))
    args.update(kw)
    return trace.View(**args)


def _read(name, view):
    return spec.load_module("metrics", name).read(view)


def test_readers():
    ops = [("void gjk_hulls_kernel<8, true>(float const*)", 0, 100),
           ("void epa_hulls_kernel(float const*)", 100, 300),
           ("void at::native::vectorized_elementwise_kernel<4>()", 300, 340),
           ("void gjk_hulls_big_kernel(float const*)", 340, 360),
           ("Memset (Device)", 400, 410)]
    v = _view(device_ops=ops, busy_s=370e-6,
              least_s={"gjk_hulls": 20e-6, "epa_hulls": 1e-6})
    assert _read("host_call_ms", v) == pytest.approx(2.0)
    assert _read("launches_per_call", v) == pytest.approx(2.0)
    # the framework's kernel, the memset and a kernel the program does not
    # build (no source names it)
    assert _read("glue_device_ms", v) == pytest.approx(0.07 / 2)
    assert _read("k1_roofline", v) == pytest.approx(20.0)
    assert _read("k2_roofline", v) == pytest.approx(0.5)
    assert _read("k8_roofline", v) is None
    assert _read("device_idle_share", v) == pytest.approx(63.0)


def test_readers_without_device_ops_read_nothing():
    v = _view()
    for m in spec.load_json(spec.BENCHMARK_JSON)["per_layer"]:
        if m["name"] != "host_call_ms":
            assert _read(m["name"], v) is None, m["name"]


def test_every_cells_metrics_have_readers():
    for name in CELLS:
        for m in spec.cell(name).per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
