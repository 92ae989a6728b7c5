"""Profile the port's query paths on one NVIDIA GPU.

Usage, from the root of a checkout:

    python3 -m gjkepa_tpu_torch.profile [path ...]

Paths, each at its bench.py configuration (``models/fixtures.py``):

  c2        ``fused_gjkepa_hulls``, boolean, 65,536 x 64 hull pairs;
  c2dist    ``fused_gjk_distance_hulls``, two-phase, the same pairs;
  c2dist1   the same, one pass (``two_phase=False``);
  c3        ``fused_gjkepa_shapes``, 65,536 analytic shape pairs;
  c3b       ``fused_gjkepa_hull_shapes``, 16,384 24-vertex hulls against
            the four shape kinds;
  c3b_unsorted  the same with ``sort_hits=False``;
  c4        ``gjkepa_batch_fused``, 16,384 x 24 deep pairs, full contact;
  deep64k   ``fused_gjkepa_hulls``, EPA on, 65,536 x 24 deep pairs (c4's
            recipe at the batch of the cell ``hull24_64k.deep_penetration``);
  deep255   the same at 255 vertices a hull (the batch and hull size of
            the cell ``hull255_64k.deep_penetration_facets``: K1 streamed,
            K2 at 32 lanes a hit);
  big8192   ``gjkepa_batch_fused``, 256 x 8,192 hull pairs (the large-hull
            path: K12, K13), full contact;
  big2600   ``fused_gjkepa_hulls``, 4,096 x 2,600 hull pairs (K12, K13);
  c1        ``gjkepa``, the portable path (torch code, no kernel of its
            own), one unit cube against the same at +0.5 in x, float32;
  c4portable  ``gjkepa_batch``, the portable path, c4's pairs, float32;
  c4manifold  ``gjkepa_batch_fused`` then ``manifold_batch`` over
            ``fixtures.c4_pairs`` (16,384 x 24, the bench's draws);
  c5sim1024 one ``sim_step`` of 1,024 falling boxes (bench.py's config 5:
            ``init_boxes(1024, height=6, spread=14)``, ``max_pairs`` 8,192);
  c5sim16k  one ``sim_step`` of 16,384 boxes (``init_boxes(16384,
            height=8, spread=55)``, ``max_pairs`` 65,536);
  c2distportable  ``gjk_distance_batch``, the portable distance (torch
            code), c2's pairs, float32;
  c3distportable  ``gjk_distance_shapes_batch``, the same over c3's pairs;
  c4sharded4  ``gjkepa_batch_fused_sharded`` over 4 entries of the card
            (``pair_mesh(4, device="cuda:0")``), ``fixtures.c4_pairs``;
  c4checked  ``checked_fused_gjkepa_hulls`` (the sanitizer over K1/K2),
            ``fixtures.c4_pairs``.

c4 and c4portable take the first draws of ``default_rng(0)`` (the recipe
alone, as chip_smoke's phases 5, 6 and 16 do); c4manifold takes the pairs
the bench draws after its configs 2 and 3b.

Without arguments it profiles them all; named paths run in the order given,
repeats included (``c3b c3b_unsorted c3b_unsorted c3b`` compares two in
turns).  For each path it prints the host
wall per call (``torch.cuda.synchronize`` after each call, median of 7
after 2 warm-up calls), then, over 5 calls under ``torch.profiler``: the
device time per call (kernel self time), the device's busy share of the
wall, the kernel launches per call and the operations with the most device
time, K1's launches a call and how many of them took its staged kernel
(``fused_gjk.STAGED_LAUNCHES``: the hulls in shared memory), the host
reads of the hit count that size K13's face store in device memory
(``fused_epa.STORE_READS``; K2 takes none), K2's launches by the lanes of
a hit's team (``fused_epa.LAUNCHES_BY_TEAM``) and its tally
(``fused_epa.k2_tally``: the hits that finished in each tier of its ladder,
the share that took a slot of its device pool, and at 16 lanes the
pairing's efficiency, ``fused_epa.k2_pairing``) beside the claims the
pool's own counter took in the same call (``fused_epa.pool_claims``) and
the tiers its ladder carried a polytope into
(``fused_epa.tier_carries``),
with the hits' mean and largest EPA iteration count (from the rows), then
a line
a program span (``gjkepa.*``, ``spans.py``: each
kernel's dispatcher, the glue between kernels, the public entry): its host
self time a call (its length less its nested spans'), the device time and
kernel launches a call of the operations launched under it (the innermost
span around the runtime call of each), and how many of the program's
kernel launches lie in their own dispatcher's span.  These span lines
took the place of the step timers that re-ran a dispatch's steps one by
one from outside.  The first line of a path names the card and its power
limit, the second K2's hits an SM at the default ladder at each width
(``fused_epa.k2_resident_hits``).  Without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import bisect
import functools
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import (GJKEPAConfig, ShapeBatch, fused_gjk_distance_hulls,
               fused_gjkepa_hull_shapes, fused_gjkepa_hulls,
               fused_gjkepa_shapes, gjk_distance_batch,
               gjk_distance_shapes_batch, gjkepa, gjkepa_batch,
               gjkepa_batch_fused, manifold_batch)
from .models import fixtures

WALL_CALLS = 7
PROFILED_CALLS = 5
TOP_OPS = 8
SPAN = "gjkepa."
# The program's kernels (``csrc/``) and the spans of the dispatchers that
# launch them (``spans.py``); K7 and K10 are one kernel.
KERNEL_SPANS = {"gjk_hulls_kernel": ("gjkepa.k1",),
                "epa_hulls_kernel": ("gjkepa.k2",),
                "cf_shapes_kernel": ("gjkepa.k5",),
                "gjk_sub_shapes_kernel": ("gjkepa.k6a",),
                "gjk_shapes_kernel": ("gjkepa.k6b",),
                "epa_polish_kernel": ("gjkepa.k7", "gjkepa.k10"),
                "distance_hulls_kernel": ("gjkepa.k8",),
                "gjk_hull_shape_kernel": ("gjkepa.k9",),
                "gjk_hulls_big_kernel": ("gjkepa.k12",),
                "epa_hulls_big_kernel": ("gjkepa.k13",)}
_KERNEL = {k: re.compile(rf"(?<!\w){k}(?!\w)") for k in KERNEL_SPANS}


def wall_ms(fn, calls=WALL_CALLS, warmup=2) -> float:
    """Median host wall of ``fn()`` in ms, synchronised after each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _self_device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    raise AttributeError("profiler event without a device time")


def device_ops(events) -> list:
    """The device operations among profiler ``events``: kernels, copies and
    memsets, without the device-side shadows of host ranges (the spans)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events
            if e.device_type == cuda and not e.is_user_annotation]


def span_tree(events) -> list:
    """The program's spans (``gjkepa.*`` host ranges) among ``events`` in
    start order, each as [name, start_us, end_us, self_us]: its length
    less the part the spans nested in it cover."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, -e.time_range.end, e.name)
                   for e in events
                   if e.device_type != cuda and e.name.startswith(SPAN))
    out, open_ = [], []
    for start, neg_end, name in spans:
        row = [name, start, -neg_end, -neg_end - start]
        while open_ and open_[-1][2] <= start:
            open_.pop()
        if open_:
            open_[-1][3] -= row[3]
        open_.append(row)
        out.append(row)
    return out


def span_summary(events):
    """Per program span name: [host self us, device us, kernel launches,
    the program's kernel launches among them that are its own], each device
    operation given to the innermost span open at the host call that
    launched it (the runtime event of its correlation id); then the
    program's kernel launches and the device operations whose launch the
    trace lacks."""
    tree = span_tree(events)
    rows = {}
    for name, _, _, self_us in tree:
        rows.setdefault(name, [0.0, 0.0, 0, 0])[0] += self_us
    cuda = torch.autograd.DeviceType.CUDA
    launch_at = {e.id: e.time_range.start for e in events
                 if e.device_type != cuda and e.name.startswith("cu")}
    starts = [r[1] for r in tree]
    program = lost = 0
    for op in device_ops(events):
        at = launch_at.get(op.id)
        if at is None:
            lost += 1
            continue
        span = "(no span)"
        for i in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            if tree[i][2] >= at:
                span = tree[i][0]
                break
        row = rows.setdefault(span, [0.0, 0.0, 0, 0])
        row[1] += op.time_range.elapsed_us()
        if not op.name.startswith(("Memcpy", "Memset")):
            row[2] += 1
        for kernel, pattern in _KERNEL.items():
            if pattern.search(op.name):
                program += 1
                row[3] += span in KERNEL_SPANS[kernel]
    return rows, program, lost


def kernel_launches(fn, attempts=3) -> int:
    """Device kernels one call of ``fn`` launches, counted by
    ``torch.profiler``.  The profiled call is bracketed by two
    ``torch.cuda._sleep`` kernels (``spin_kernel``): a session that did not
    record both lost kernels (the first session in a process can, while
    CUPTI starts) and is run again, up to ``attempts`` sessions; then it
    raises rather than return a short count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        names = [e.name for e in device_ops(prof.events())]
        marks = sum("spin_kernel" in n for n in names)
        if marks == 2:
            return len(names) - marks
        seen.append(len(names))
    raise RuntimeError(f"the profiler lost kernels in each of {attempts} "
                       f"sessions (kernels recorded: {seen})")


def _epa_iters(out) -> str:
    """The mean and largest EPA iteration count over the hits of a query's
    result, where it has them."""
    hit, iters = getattr(out, "hit", None), getattr(out, "epa_iters", None)
    if hit is None or iters is None or not bool(hit.any()):
        return ""
    it = iters[hit].float()
    return (f"; hits' EPA iterations mean {float(it.mean()):.3f}, largest "
            f"{int(it.max())}")


def profile_path(name, fn, card) -> None:
    """Wall, device time, busy share, launches, top ops and the program's
    spans of one path."""
    from torch.profiler import ProfilerActivity, profile

    from .ops import fused_epa, fused_gjk
    wall = wall_ms(fn)
    k1 = (fused_gjk.LAUNCHES, fused_gjk.STAGED_LAUNCHES)
    k2 = dict(fused_epa.LAUNCHES_BY_TEAM)
    reads = fused_epa.STORE_READS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    k1 = (fused_gjk.LAUNCHES - k1[0], fused_gjk.STAGED_LAUNCHES - k1[1])
    reads = fused_epa.STORE_READS - reads
    k2 = {t: n - k2[t] for t, n in fused_epa.LAUNCHES_BY_TEAM.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    counted = fused_epa.pool_claims(dev)
    carried = fused_epa.tier_carries(dev)
    with fused_epa.k2_tally(dev) as tally:
        out = fn()
        torch.cuda.synchronize()
    tally = tally.tolist()
    counted = fused_epa.pool_claims(dev) - counted
    carried = fused_epa.tier_carries(dev) - carried
    events = prof.events()
    kernels = device_ops(events)
    device_ms = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                 / PROFILED_CALLS)
    if device_ms <= 0:
        raise RuntimeError(f"{name}: the profiler saw no device time")
    print(f"{name}: wall {wall:.4f} ms a call; device {device_ms:.4f} ms a "
          f"call, busy {device_ms / wall:.3f} of the wall; "
          f"{len(kernels) / PROFILED_CALLS:.0f} kernel launches a call "
          f"[{card}]", flush=True)
    ops = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    for e in ops[:TOP_OPS]:
        ms = _self_device_us(e) / 1e3 / PROFILED_CALLS
        print(f"  {name} op {e.key}: {ms:.4f} ms a call, "
              f"{e.count / PROFILED_CALLS:.0f} calls", flush=True)
    print(f"  {name} K1: {k1[0] / PROFILED_CALLS:.1f} launches a call, "
          f"{k1[1] / PROFILED_CALLS:.1f} of them staged", flush=True)
    print(f"  {name} K2/K13 face store: {reads / PROFILED_CALLS:.1f} host "
          "reads of the hit count a call", flush=True)
    print(f"  {name} K2: launches a call by lanes a hit "
          f"{ {t: n / PROFILED_CALLS for t, n in k2.items()} }", flush=True)
    tiers = tally[:fused_epa.MAX_TIERS]
    hits = sum(tiers)
    if hits:
        claims = tally[fused_epa.TALLY_CLAIMS]
        pairing = fused_epa.k2_pairing(tally)
        print(f"  {name} K2 tally, one call: {hits} hits, finished by tier "
              f"{tiers}; {claims} took a pool slot "
              f"({100.0 * claims / hits:.3f}% of hits; the pool's counter "
              f"{counted}); {carried} tiers carried into; pairing "
              + ("n/a (no 16-lane hit)" if pairing is None else
                 f"{pairing:.4f} ({tally[fused_epa.TALLY_ITERS]} EPA "
                 f"iterations, {tally[fused_epa.TALLY_LONGER]} of the "
                 "longer team a warp)")
              + _epa_iters(out), flush=True)
    rows, program, lost = span_summary(events)
    n = PROFILED_CALLS
    for span, (host, device, launches, _) in sorted(rows.items()):
        print(f"  {name} span {span}: host self {host / 1e3 / n:.4f} ms a "
              f"call, device {device / 1e3 / n:.4f} ms a call, "
              f"{launches / n:.1f} launches a call", flush=True)
    own = sum(r[3] for r in rows.values())
    print(f"  {name} spans: {own} of {program} program-kernel launches in "
          f"their dispatcher's span; {lost} device operations without a "
          "launch in the trace", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    from .ops import fused_epa
    from .ops.fused import cascade_plan
    cfg = GJKEPAConfig.for_f32()
    hits = {t: fused_epa.k2_resident_hits(dev, cascade_plan(cfg), t)
            for t in (16, 32)}
    print(f"K2 hits an SM at the default ladder by lanes a hit: {hits} "
          f"[{card}]", flush=True)
    order = argv or ["c2", "c2dist", "c2dist1", "c3", "c3b", "c3b_unsorted",
                     "c4", "deep64k", "deep255", "big8192", "big2600", "c1",
                     "c4portable",
                     "c4manifold", "c5sim1024", "c5sim16k",
                     "c2distportable", "c3distportable", "c4sharded4",
                     "c4checked"]
    want = set(order)

    def on_dev(*arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    paths = {}
    if want & {"c2", "c2dist", "c2dist1", "c2distportable"}:
        d1, d2 = on_dev(*fixtures.c2_hulls())
        paths["c2distportable"] = lambda: gjk_distance_batch(d1, d2,
                                                             cfg=cfg)
        bool_cfg = cfg.replace(epa_max_iters=0)
        paths["c2"] = lambda: fused_gjkepa_hulls(d1, d2, cfg=bool_cfg)
        paths["c2dist"] = lambda: fused_gjk_distance_hulls(d1, d2, cfg=cfg)
        paths["c2dist1"] = lambda: fused_gjk_distance_hulls(
            d1, d2, cfg=cfg, two_phase=False)
    if want & {"c3", "c3distportable"}:
        a3, b3 = (ShapeBatch.from_numpy(*p, device=dev)
                  for p in fixtures.c3_pairs())
        paths["c3"] = lambda: fused_gjkepa_shapes(a3, b3, cfg=cfg)
        paths["c3distportable"] = lambda: gjk_distance_shapes_batch(
            a3, b3, cfg=cfg)
    if want & {"c3b", "c3b_unsorted"}:
        hulls, shp = fixtures.c3b_pairs()
        (h3,) = on_dev(hulls)
        s3 = ShapeBatch.from_numpy(*shp, device=dev)
        paths["c3b"] = lambda: fused_gjkepa_hull_shapes(h3, s3, cfg=cfg)
        paths["c3b_unsorted"] = lambda: fused_gjkepa_hull_shapes(
            h3, s3, cfg=cfg, sort_hits=False)
    if "c1" in want:
        corners = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                            for z in (-.5, .5)], np.float32)
        c1, c2 = on_dev(corners, corners + np.float32([0.5, 0.0, 0.0]))
        paths["c1"] = lambda: gjkepa(c1, c2, cfg=cfg)
    if want & {"c4", "c4portable"}:
        m1, m2 = on_dev(*fixtures.deep_pairs(np.random.default_rng(0),
                                             16384, 24))
        paths["c4"] = lambda: gjkepa_batch_fused(m1, m2, cfg=cfg)
        paths["c4portable"] = lambda: gjkepa_batch(m1, m2, cfg=cfg)
    if "deep64k" in want:
        e1, e2 = on_dev(*fixtures.deep_pairs(np.random.default_rng(0),
                                             65536, 24))
        paths["deep64k"] = lambda: fused_gjkepa_hulls(e1, e2, cfg=cfg)
    if "deep255" in want:
        f1, f2 = on_dev(*fixtures.deep_pairs(np.random.default_rng(0),
                                             65536, 255))
        paths["deep255"] = lambda: fused_gjkepa_hulls(f1, f2, cfg=cfg)
    if want & {"c4manifold", "c4sharded4", "c4checked"}:
        from .debug import checked_fused_gjkepa_hulls
        from .parallel import (gjkepa_batch_fused_sharded, pair_mesh,
                               shard_pairs)
        q1, q2 = on_dev(*fixtures.c4_pairs())
        mesh = pair_mesh(4, device=dev)
        s1, s2 = shard_pairs(mesh, q1, q2)
        paths["c4sharded4"] = lambda: gjkepa_batch_fused_sharded(
            mesh, s1, s2, cfg=cfg)
        paths["c4checked"] = lambda: checked_fused_gjkepa_hulls(q1, q2,
                                                                 cfg=cfg)

        def c4manifold():
            r = gjkepa_batch_fused(q1, q2, cfg=cfg)
            return manifold_batch(q1, q2, r.normal, r.depth, r.hit,
                                  r.contact_point, cfg=cfg)
        paths["c4manifold"] = c4manifold
    for name, n, height, spread, max_pairs in (
            ("c5sim1024", 1024, 6.0, 14.0, 8192),
            ("c5sim16k", 16384, 8.0, 55.0, 65536)):
        if name in want:
            from .sim import SimConfig, init_boxes, sim_step
            paths[name] = functools.partial(
                sim_step, init_boxes(n, height=height, spread=spread,
                                     device=dev),
                SimConfig(max_pairs=max_pairs), cfg)
    if "big8192" in want:
        g1, g2 = on_dev(*fixtures.big_pairs_8192())
        paths["big8192"] = lambda: gjkepa_batch_fused(g1, g2, cfg=cfg)
    if "big2600" in want:
        h1, h2 = on_dev(*fixtures.big_c2_pairs())
        paths["big2600"] = lambda: fused_gjkepa_hulls(h1, h2, cfg=cfg)
    for name in order:
        profile_path(name, paths[name], card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
