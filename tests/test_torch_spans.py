"""The port's spans (``gjkepa_tpu_torch/spans.py``): nothing without a
profiler, each fused entry's tree of ``gjkepa.*`` ranges under one, the
same outputs either way, and ``profile.py``'s reading of them.

The ``cuda`` case needs the card; the machine with it has no JAX, so run it
without the JAX conftest:

    python -m pytest tests/test_torch_spans.py -q -m cuda --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gjkepa_tpu_torch import (GJKEPAConfig, ShapeBatch,
                              fused_gjk_distance_hulls,
                              fused_gjkepa_hull_shapes, fused_gjkepa_hulls,
                              fused_gjkepa_shapes, gjkepa_batch_fused, spans)
from gjkepa_tpu_torch import profile as port_profile
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops.fused_streamed import fused_hulls_streamed

torch.set_num_threads(1)

CFG = GJKEPAConfig.for_f32()
BOOL = CFG.replace(epa_max_iters=0)
B = 256


def _hulls(device="cpu", b=B, n=16):
    p1, p2 = fixtures.deep_pairs(np.random.default_rng(3), b, n)
    return torch.from_numpy(p1).to(device), torch.from_numpy(p2).to(device)


def _shapes(device="cpu", b=B):
    a, c = fixtures.c3_pairs(4, b)
    return (ShapeBatch.from_numpy(*a, device=device),
            ShapeBatch.from_numpy(*c, device=device))


def _hull_shapes(device="cpu", b=B):
    hulls, shp = fixtures.hull_kind_pairs(5, b, 16, 0.5)
    return (torch.from_numpy(hulls).to(device),
            ShapeBatch.from_numpy(*shp, device=device))


def _tree(events):
    """The ``gjkepa.*`` host ranges nested by their intervals: a list of
    (name, children) in start order."""
    rows = sorted((e.time_range.start, -e.time_range.end, e.name)
                  for e in events if e.name.startswith("gjkepa.")
                  and e.device_type == torch.autograd.DeviceType.CPU)
    root, stack = [], []
    for start, neg_end, name in rows:
        while stack and stack[-1][0] <= start:
            stack.pop()
        node = (name, [])
        (stack[-1][1][1] if stack else root).append(node)
        stack.append((-neg_end, node))
    return root


def _leaves(*names):
    return [(n, []) for n in names]


def _e(name):
    return "gjkepa." + name


# (query, its tree under a profiler)
QUERIES = {
    "hulls_boolean": (
        lambda: fused_gjkepa_hulls(*_hulls(), cfg=BOOL),
        [(_e("fused_gjkepa_hulls"), _leaves(_e("k1"), _e("fill")))]),
    "hulls_epa": (
        lambda: fused_gjkepa_hulls(*_hulls(), cfg=CFG),
        [(_e("fused_gjkepa_hulls"),
          _leaves(_e("k1"), _e("order"), _e("k2")))]),
    "distance": (
        lambda: fused_gjk_distance_hulls(*_hulls(), cfg=CFG),
        [(_e("fused_gjk_distance_hulls"),
          _leaves(_e("k8"), _e("order"), _e("k8")))]),
    "batch_fused": (
        lambda: gjkepa_batch_fused(*_hulls(), cfg=CFG),
        [(_e("gjkepa_batch_fused"),
          [(_e("fused_gjkepa_hulls"),
            _leaves(_e("k1"), _e("order"), _e("k2"))),
           (_e("contact_rows"), [])])]),
    "hull_shapes": (
        lambda: fused_gjkepa_hull_shapes(*_hull_shapes(), cfg=CFG),
        [(_e("fused_gjkepa_hull_shapes"),
          _leaves(_e("broadphase"), _e("order"), _e("k9"), _e("order"),
                  _e("k10")))]),
    "hull_shapes_unsorted": (
        lambda: fused_gjkepa_hull_shapes(*_hull_shapes(), cfg=CFG,
                                         sort_hits=False),
        [(_e("fused_gjkepa_hull_shapes"),
          _leaves(_e("broadphase"), _e("k9"), _e("order"), _e("k10")))]),
    "shapes": (
        lambda: fused_gjkepa_shapes(*_shapes(), cfg=CFG),
        [(_e("fused_gjkepa_shapes"),
          _leaves(_e("broadphase"), _e("k5"), _e("order"), _e("k6a"),
                  _e("order"), _e("k7")))]),
    "shapes_unsorted": (
        lambda: fused_gjkepa_shapes(*_shapes(), cfg=CFG, sort_hits=False),
        [(_e("fused_gjkepa_shapes"),
          _leaves(_e("broadphase"), _e("k6b"), _e("order"), _e("k7")))]),
    "streamed": (
        lambda: fused_hulls_streamed(*_hulls(b=8, n=40), CFG, tile=16),
        [(_e("fused_hulls_streamed"),
          _leaves(_e("broadphase"), _e("k12"), _e("order"), _e("k13")))]),
}


def test_no_profiler_no_span():
    assert not torch.autograd._profiler_enabled()
    off = spans.span("gjkepa.a")
    assert off is spans.span("gjkepa.b") is spans._OFF
    with off:
        pass
    QUERIES["distance"][0]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.events() if e.name.startswith("gjkepa.")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("gjkepa.a"):
            pass
    assert [e.name for e in prof.events()
            if e.name.startswith("gjkepa.")] == ["gjkepa.a"]


def test_spanned_keeps_the_function():
    def step(x, *, y=2):
        """One step."""
        return x + y

    wrapped = spans.spanned("gjkepa.step")(step)
    assert wrapped(1) == 3 and wrapped(1, y=5) == 6
    assert wrapped.__name__ == "step" and wrapped.__doc__ == "One step."
    assert wrapped.__wrapped__ is step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert wrapped(2) == 4
    assert _tree(prof.events()) == [("gjkepa.step", [])]


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_entry_tree(query):
    fn, want = QUERIES[query]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    assert _tree(prof.events()) == want


@pytest.mark.parametrize("query", ["hulls_boolean", "distance", "batch_fused",
                                   "shapes", "hull_shapes"])
def test_outputs_same_under_a_profiler(query):
    fn = QUERIES[query][0]
    plain = fn()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fn()
    assert type(plain) is type(traced)
    for a, b in zip(plain, traced):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _event(name, start, end, device=False, id_=0, user=False):
    kind = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, id=id_, is_user_annotation=user,
        device_type=kind.CUDA if device else kind.CPU,
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def test_profile_span_tree_self_times():
    events = [_event("gjkepa.fused_gjk_distance_hulls", 0, 100),
              _event("gjkepa.k8", 10, 30), _event("gjkepa.order", 40, 50),
              _event("gjkepa.k8", 60, 95), _event("aten::cumsum", 41, 45),
              _event("gjkepa.k8", 200, 210)]
    got = [(n, s) for n, _, _, s in port_profile.span_tree(events)]
    assert got == [("gjkepa.fused_gjk_distance_hulls", 35),
                   ("gjkepa.k8", 20), ("gjkepa.order", 10), ("gjkepa.k8", 35),
                   ("gjkepa.k8", 10)]


def test_profile_span_summary_gives_each_launch_its_span():
    name = "void gjkepa::(anonymous namespace)::distance_hulls_kernel<4>(x)"
    events = [
        _event("gjkepa.fused_gjk_distance_hulls", 0, 100),
        _event("gjkepa.k8", 10, 30), _event("gjkepa.order", 40, 50),
        _event("cudaLaunchKernel", 20, 21, id_=7),
        _event("cudaLaunchKernel", 45, 46, id_=8),
        _event("cudaLaunchKernel", 55, 56, id_=9),
        _event(name, 100, 300, device=True, id_=7),
        _event("void at::cumsum_kernel(x)", 300, 310, device=True, id_=8),
        _event("Memset (Device)", 310, 311, device=True, id_=9),
        _event("Memcpy DtoH", 311, 312, device=True, id_=10),
        # the device shadow of a span is no operation
        _event("gjkepa.k8", 100, 300, device=True, id_=11, user=True)]
    rows, program, lost = port_profile.span_summary(events)
    assert rows == {"gjkepa.fused_gjk_distance_hulls": [70, 1, 0, 0],
                    "gjkepa.k8": [20, 200, 1, 1],
                    "gjkepa.order": [10, 10, 1, 0]}
    assert (program, lost) == (1, 1)


@pytest.mark.cuda
def test_kernel_spans_hold_their_launches_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gjkepa_tpu_torch.ops import fused_distance as fd
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops import fused_streamed as fst
    dev = "cuda"

    def counts():
        return {"gjkepa.k1": fused_gjk.LAUNCHES,
                "gjkepa.k2": fused_epa.LAUNCHES,
                "gjkepa.k5": fs.LAUNCHES["cf_shapes"],
                "gjkepa.k6a": fs.LAUNCHES["gjk_sub_shapes"],
                "gjkepa.k6b": fs.LAUNCHES["gjk_shapes"],
                "gjkepa.k7": fs.LAUNCHES["epa_shapes"],
                "gjkepa.k8": fd.LAUNCHES["distance_hulls"],
                "gjkepa.k9": fh.LAUNCHES["gjk_hull_shape"],
                "gjkepa.k10": fh.LAUNCHES["epa_hull_shape"],
                "gjkepa.k12": fst.LAUNCHES["gjk_hulls_big"],
                "gjkepa.k13": fst.LAUNCHES["epa_hulls_big"]}

    h1, h2 = _hulls(dev, 4096, 24)
    a, b = _shapes(dev, 4096)
    hs = _hull_shapes(dev, 4096)
    g1, g2 = _hulls(dev, 16, 2600)

    def run():
        fused_gjkepa_hulls(h1, h2, cfg=BOOL)
        fused_gjk_distance_hulls(h1, h2, cfg=CFG)
        gjkepa_batch_fused(h1, h2, cfg=CFG)
        fused_gjkepa_shapes(a, b, cfg=CFG)
        fused_gjkepa_shapes(a, b, cfg=CFG, sort_hits=False)
        fused_gjkepa_hull_shapes(*hs, cfg=CFG)
        fused_gjkepa_hulls(g1, g2, cfg=CFG)

    run()
    torch.cuda.synchronize()
    for _ in range(2):      # the first session in a process can lose kernels
        before = counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()}
    rows, program, lost = port_profile.span_summary(prof.events())
    assert lost == 0
    assert program == sum(delta.values()) == sum(r[3] for r in rows.values())
    for span, n in delta.items():
        assert n > 0 and rows[span][3] == n, span
