"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

The port has five paths.  The hull path is the fused hull-pair query,
``gjkepa_batch_fused``: K1, the GJK hull kernel, a team of threads a pair
(``gjkepa_tpu_torch/csrc/gjk_hulls.cu``), then K2, the EPA cascade kernel,
a team of 16 lanes a hit (two a warp) where both hulls have at most 64
vertices and a warp a hit above, with the polytope in shared memory where
it fits (``csrc/epa_hulls.cu`` over ``csrc/epa_warp.cuh``), over the hit
lanes,
then the contact rows.  Hull pairs with n1 + n2 > 4096 vertices take the
large-hull path instead: the broadphase on the tile-padded hulls, K12, GJK
a block of warps a pair with both hulls staged in shared memory where they
fit (``csrc/gjk_hulls_big.cu``), then K13, the EPA cascade a block of
warps a hit with the polytope in shared memory (``csrc/epa_hulls_big.cu``
over ``csrc/epa_warp.cuh``), all over the team support K11
(``csrc/hull_stream.cuh``).  The
shape path is the analytic-shape query, ``fused_gjkepa_shapes`` and
``collide_shapes_batch_fused``: K5, the closed-form kernel, a thread a
pair (``csrc/cf_shapes.cu``), K6a, GJK a quad of threads a pair over the
GJK lanes (``csrc/gjk_quad.cuh``), or K6b over all lanes, the closed
forms a thread a pair and each block's GJK lanes a quad each
(``csrc/gjk_shapes.cu``), then K7, the capped EPA cascade with the polish,
a warp a hit with the polytope in shared memory (``csrc/epa_shapes.cu``
over ``csrc/epa_warp.cuh``).  The distance path,
``fused_gjk_distance_hulls``, launches K8, distance GJK with witnesses, a
team of threads a pair (``csrc/distance_hulls.cu``), over every pair at a
low cap and again over the unconverged pairs.  The mixed
path, ``fused_gjkepa_hull_shapes``, runs K9, GJK of a hull against an
analytic shape, a team of threads a pair (``csrc/gjk_hull_shape.cu``),
then K10, the capped EPA cascade with the polish, a warp a hit with the
polytope in shared memory (``csrc/epa_hull_shape.cu``, K7's kernel in
``csrc/epa_polish_warp.cuh``).  The contact manifolds and the rigid-body
sim are torch code over the hull path: ``manifold_batch`` after
``gjkepa_batch_fused``, and ``sim_step``, whose narrowphase on the card is
K1 and K2 over the eight corners of each box.  Sharding splits the
pair axis over a list of devices (K1 and K2 a shard), the sanitizer
checks the fused and portable queries' results on the card, and the
entry points drive the sharded pipeline.  The hull queries also run
without the broadphase (``use_broadphase=False``, K1 or K12 over every
pair), K13 keeps a tier whose polytope does not fit in shared memory
in a store in device memory, and K2 keeps its tiers past its share of an
SM's shared memory in a slot of a device pool.  The script builds
every kernel from the sources in the checkout (one nvcc per source, all at
once) and runs, in phases:

  0. environment: card name and power limit, torch and CUDA versions, build,
     and every kernel's registers, stack and spills (``-Xptxas -v``);
  1. K1 against its plain PyTorch version on the card (4096 x 64, 4096 x
     63 and 1024 x 2047 vertices), bit for bit;
  2. K2 against its plain version, bit for bit, at 16 and 32 lanes a hit:
     2048 deep pairs x 24 vertices; a tier ladder forced to overflow (F=8,
     K=2; F=16, K=4; F=208, K=16) with its tiers as the store rule places
     them, the last in the pool, and all in the pool; a face capacity past
     a block's shared memory (F=4096), which takes the pool; K2's hits an
     SM under its rule at each width and the tally of each run (its hits,
     the pool's claims, at 16 lanes the pairing's efficiency), the rows'
     mean and largest EPA iterations, the launches by width, the pool's
     slot masks all clear after each;
  3. known geometry: unit cubes at offsets 0.3, 0.7, 1.2, 2.5;
  4. the float64 reference oracle (tests/oracle_np.py) on 64 deep pairs;
  5. the main path at full size (16384 x 24 deep pairs with full contact,
     65536 x 64 boolean), with the kernels' launch counters; then the
     whole result against the plain path, and each kernel against its
     plain version at these shapes;
  6. timings, kernel path against plain path at the phase-5 sizes, and K1
     at each team size at c4 and c2 (each bit-equal to the wrapper's
     team);
  7. K5, K6a, K6b and K7 against their plain versions, rows bit for bit,
     on bench.py's c3 pairs (65,536, seed 0) in natural and shuffled
     order, the 16 rotated kind combinations (16,384), a dense
     all-cylinder batch (16,384, nearly all lanes in GJK), c3's first
     65,533 pairs and sphere pairs (no GJK lane); also at epa_max_iters 1
     and 64 on c3;
  8. known shape geometry: spheres at 1.5 (depth 0.5 exactly), sphere-box
     and box-box closed-form depths;
  9. the shape path at full size (c3, 65,536 pairs): natural and shuffled
     order, sort_hits True and False, and collide_shapes_batch_fused, each
     call with the shape kernels' launch counters set to 0 just before it
     and its exact launches checked just after; then the whole result
     against the plain path;
 10. c3's GJK iteration spread; K5's, K6a's and K6b's wrappers launch one
     kernel each (``torch.profiler``), and the shape path's device
     launches a call; timings of each shape kernel against its plain
     version (K5 also shuffled, K6a and K6b also alone through their C
     entry points, writing into rows allocated beforehand), and of the
     shape path, at c3;
 11. K8 against its plain version, rows bit for bit (4096 x 12 at spread
     2.0 and bench.py's c2, 65,536 x 64): phase 1, phase 2 into phase 1's
     rows and one pass, at c2 at every team size; two-phase equal to one
     pass bit for bit; known distances (cube gap, tetrahedron apex,
     crossing segments);
 12. K9 and K10 against their plain versions, rows bit for bit, on
     bench.py's c3b (16,384 x 24 hulls against the four shape kinds), on
     its hulls cut to 21, 22 and 23 vertices (each remainder mod 4) and on
     hulls padded through a mask (repeated vertices: first-max ties); K9
     at every team size, in the dispatch's order and in the caller's; K10
     at epa_max_iters 1, 16 and 64 on c3b; the mixed path against the
     plain path, sort_hits True = False, a mask equal to its padding,
     hull-vs-sphere depths against a float64 convex projection (scipy) and
     the separation contract;
 13. the distance and mixed paths at full size, each call with its
     kernels' launch counters set to 0 just before it and its exact
     launches checked just after, then timings of K8 (phase 1, phase 2 and
     one pass, with the team sizes used), K9 (with its team), K10, both
     paths and their plain versions;
 14. K12 and K13 against their plain versions, bit for bit, on 4096 x 2600
     pairs, on tie pairs (box corners copied one ulp apart at vertices i,
     i + 1 and i + 32k, n1 + n2 = 4200), on 256 x 8192 pairs
     (tests/test_fused_tpu.py:248-290) and on 8 x 10240 pairs, whose hulls
     do not fit in shared memory (K12's device-memory scan); K13 over a
     tier ladder forced to overflow (F=8, K=2; F=16, K=4; F=208,
     K=16) bit for bit at 512 x 2600 and 512 x 2601 (K11's scalar scan),
     K12/K13 at 512 x 2601; 2048-vertex sub-hulls through
     K1/K2 against the same padded to 8192 through K12/K13; K1/K2 against
     K12/K13 at 256 x 8192, bit for bit;
 15. the large-hull path at full width: ``gjkepa_batch_fused`` at 256 x
     8192 with full contact, ``fused_gjkepa_hulls`` at 4096 x 2600 with
     EPA and boolean, each call with the hull kernels' counters set to 0
     just before it (exactly one K12 and one K13, no K1/K2); masks against
     repeated-vertex padding bit for bit; the path against the plain path;
     timings of K12, K13, their plain versions, K1/K2 on the same inputs,
     the padded broadphase, the contact rows and both paths; K13's ms per
     EPA iteration and K12's ms per probe;
 16. the portable path (torch code, no kernel of its own) through its
     entry points: ``gjkepa`` on bench.py's c1 cubes (depth 0.5 within
     1e-4), ``gjkepa_batch`` at phase 5's 16384 x 24 deep pairs in
     float32 and a 256-pair float64 sample of them against the oracle (no
     hit mismatch, depth within 1e-6), ``collide_shapes_batch`` at c3 and
     ``collide_hull_shape_batch`` at c3b (hits equal to the fused path's
     on >= 99% of lanes), each timed (host wall, synchronised);
 17. the manifolds (torch code over the hull kernels' query): c4's pairs
     in the bench's draw order (``fixtures.c4_pairs``, 16,384 x 24)
     through ``gjkepa_batch_fused`` and ``manifold_batch`` with the
     kernels' counters set to 0 just before and read just after (one K1,
     one K2), finite, depths >= 0, a point on every hit and none on a
     miss; the first 1,024 lanes against the same call on the CPU (masks
     on >= 99.9% of lanes; on those, the kept points as sets and the
     depths within 1e-5, row by row on >= 99%); the stacked boxes of
     tests/test_manifold.py through ``manifold_shapes_batch`` and through
     ``manifold_batch`` over box corners (4 points at x, y = +-0.4, depth
     0.1), the sphere pair's single point; ``manifold_hull_shape_batch``
     at c3b; times (c4 manifold q/s, the median of 7);
 18. the sim: bench.py's scenes (1,024 boxes, ``max_pairs`` 8,192, 10
     steps; 16,384 boxes, 65,536, 3 steps), each run with K1's and K2's
     counters set to 0 just before and read just after (one of each a
     step), steps/s, ``diag`` (the device launches a step: ``profile
     c5sim1024 c5sim16k``); one step's
     candidates of the 1,024 scene through K1/K2 on the card against their
     plain versions on the CPU, bit for bit (hit, status, depth, normal);
     that step against the same branch on the CPU and against the CPU's
     portable step, at tests/test_torch_sim.py's tolerance; the 3-box
     stack of tests/test_sim.py and the same stack moved 8, 16 and 24
     along x, in one run of 300 steps on the card: each within that
     test's height bounds, K2 over real hits, the lateral walk-off logged
     (it is chaotic: the moves change only the rounding, and the
     walk-off with them);
 19. sharding (``gjkepa_tpu_torch.parallel``) at c4 (``fixtures.c4_pairs``):
     ``gjkepa_batch_fused_sharded`` over ``pair_mesh()`` (every card) and
     over 4 entries of this card, each call with K1's and K2's counters
     set to 0 just before and read just after (one of each a shard) and
     its host reads counted (none: every shard's kernels go out before
     any read), gathered bit for bit against the unsharded
     ``gjkepa_batch_fused``; ``contact_count_sharded`` over the 4 entries
     equal to the unsharded portable query's hit sum; q/s sharded and
     unsharded;
 20. the sanitizer (``gjkepa_tpu_torch.debug``) at full width: the checked
     fused hulls at c4, fused shapes at c3, manifolds at c4 and on c3's
     query, the portable query on a 1,024-pair float64 sample of c4, each
     with its kernels' counters set to 0 just before (one K1 and K2, one
     K5, K6a and K7, none) and bit for bit against the unchecked call
     with one host read more; then NaN/Inf planted at known lanes (and a
     float32 NaN, whose coordinate-range check comes first) raise the
     check and lanes the same call names on the CPU; checked and
     unchecked ms;
 21. the entry points (``gjkepa_tpu_torch.entry``): ``entry()``'s call
     once on the card against its CPU run, ``dryrun_multichip`` over the
     cards and over 4 entries of this card (one K1 and one K2 a shard);
 22. the portable distance (torch code, ``ops.distance``):
     ``gjk_distance_batch`` at c2 (65,536 x 64) and
     ``gjk_distance_shapes_batch`` at c3, each against its CPU run on 1,024
     lanes (intersecting exact, distance within 1e-5), the first also
     against K8 on every lane; ms and host reads a call (device launches
     and busy share: ``profile c2distportable c3distportable``);
 23. the calls the JAX package answers that the port once refused: K1
     without the broadphase (``use_broadphase=False``, every pair in GJK)
     bit for bit against its plain version at c2 (``fixtures.c2_hulls``, at
     every team size), c4 and 4,096 x 63, one launch a call; the large-hull
     path without the broadphase at big2600 (K12 over every lane, K13, the
     path bit for bit against the plain path); K13 over a ladder whose last
     tier (4,096 faces) is past a block's shared memory, on every hit of
     big8192, bit for bit against its plain version, with its device
     store's bytes and its one host read, and 0 host reads at the default
     ladder; ``fused_gjkepa_hulls(use_broadphase=False)`` at c2 with its
     launches counted (one K1, one K2), its first 1,024 lanes against the
     same call on the CPU (discrete fields exact, depth and distance within
     1e-5); ``gjk_distance_batch`` at c2 in chunks of 8,192 bit for bit
     against the unchunked call, the wall of each; K1's device time with
     and without the broadphase at c2;
 24. the bench (``gjkepa_tpu_torch.bench``): each config function once on
     the bench's inputs with a timer that makes each query once, every
     kernel's counter set to 0 just before and read just after (c2: one
     K1 a boolean query, two K8 a distance query; c3: one K5, K6a and K7
     a query; c3b: one K9 and K10; c4: one K1 and K2 a query; c6: one of
     each a shard; c5: one of each a step; c1: none), every K1 launch
     staged (``fused_gjk.STAGED_LAUNCHES``: one a c2 boolean, c4 and c6
     shard query, one a c5 step), the fused queries'
     host reads (none), c3's hits and c4's contact points a hit against
     the JAX bench's logged run (BENCH_r05.json); then ``python3 -m
     gjkepa_tpu_torch.bench`` in a subprocess over every config: rc 0,
     exactly bench.py's 20 keys in its order, every rate finite and
     positive, c4's hit fraction >= 0.99, ``c6_n_devices`` the card
     count, the same hits and points a hit in its detail lines; the line
     and its seconds logged.

Times are CUDA-event times.  A kernel's (``ms`` in the ``kernels`` line)
is a device time, ``device_ms``: 10 calls queued behind a sleep kernel
between two events, the median of 7, so that its wrapper's host time
does not show.  Paths, plain versions and K1/K2 at large N take
``cuda_ms``: one call between two events, the median of 7 after 2
warm-ups (the slowest plain versions 3 after 1).

Each entry of the ``kernels`` line carries a bound: the larger of the
bytes the kernel must move (inputs read once, outputs written once, over
the lanes it serves) at 3.35 TB/s and its float32 operations at 67 TFLOP/s
(the H100 SXM's published peaks), the operations counted by the model in
``work()`` at this run's iteration counts.  No single PyTorch call
computes GJK, EPA or distance, so ``library_ms`` is null.

Every check raises on failure.  It prints the ``kernels`` JSON line and
the card's name and power limit before the last line, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA device
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TIMED_CALLS = 7
PLAIN_CALLS = 3         # the slowest plain versions (host-synced loops)
SLEEP_CYCLES = 100_000_000      # device_ms's head start, ~50 ms on an H100
C3 = 65536
HBM_BYTES_PER_MS = 3.35e12 / 1e3    # H100 SXM HBM3
F32_OPS_PER_MS = 67e12 / 1e3        # H100 SXM float32, no tensor cores

# The operation model of work(): float32 operations of each step.
VERTEX_OPS = 5          # one vertex of a support scan: 3 multiplies, 2 adds
SHAPE_OPS = 40          # one analytic support side (rotate, select, rotate)
SPHERE_OPS = 12         # one vertex of a bounding-sphere pass
GJK_INIT_PROBES = 6     # support probes of the v1-v4 init
GJK_ITER_OPS = 400      # face normals, selection and tests of an iteration
EPA_FACE_OPS = 20       # min scan, repeat test and visibility, per face
EPA_FACES = 48          # faces scanned per EPA iteration (the first tier)
POLISH_PROBES = 49
DIST_ITER_OPS = 500     # the 15 candidates of a distance iteration
CF_OPS = 400            # the closed forms of one shape pair


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def random_hulls(rng, b, n, spread=0.8):
    """bench.py's hull generator (bench.py:112-116)."""
    from gjkepa_tpu_torch.models import fixtures
    return fixtures.random_hulls(rng, b, n, spread)


def deep_pairs(rng, b, n):
    """bench.py's config-4 recipe (bench.py:278-281): a small hull inside a
    big one, offset a little."""
    from gjkepa_tpu_torch.models import fixtures
    return fixtures.deep_pairs(rng, b, n)


def load_oracle():
    """tests/oracle_np.py, the float64 numpy/scipy transliteration of the
    reference, with its direction table taken from the port's own copy
    (the file imports it from the JAX package, which this script must not
    import).  The two tables are tested equal."""
    path = ROOT / "tests" / "oracle_np.py"
    src = path.read_text()
    line = "from gjkepa_tpu.ops.directions import DIRECTION_TABLE"
    check(src.count(line) == 1, f"{path}: direction-table import not found")
    src = src.replace(line, "from gjkepa_tpu_torch.ops.directions import "
                            "DIRECTION_TABLE")
    mod = types.ModuleType("oracle_np")
    mod.__file__ = str(path)
    sys.modules["oracle_np"] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def cuda_ms(fn, calls=TIMED_CALLS, warmup=2) -> float:
    """Median device time of `fn` in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls=10, reps=TIMED_CALLS) -> float:
    """Device time of one call of `fn` in ms: CUDA events around `calls`
    back-to-back calls queued behind a sleep kernel, so that the host's
    time to enqueue a call does not show, divided by `calls`; the median
    of `reps`.  For kernels shorter than their wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def ptxas_report(log_text: str) -> list[str]:
    """Registers, stack and spills of each kernel in an ``nvcc -Xptxas -v``
    log, one line a kernel (template arguments in angle brackets)."""
    import re
    out, name, frame = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(?:IL[a-z](\d+)E((?:Lb[01]E)*))?",
                          m.group(1))
            args = ([a for a in [k.group(2)] + re.findall(
                r"Lb([01])E", k.group(3) or "") if a] if k else [])
            name = (k.group(1) + (f"<{', '.join(args)}>" if args else "")
                    if k else m.group(1))
        elif "spill stores" in line:
            frame = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {frame}")
            name, frame = None, ""
    return out


def work(lanes, bytes_per_lane, ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``lanes * bytes_per_lane`` bytes and to do ``ops`` float32
    operations."""
    t_bytes = lanes * bytes_per_lane / HBM_BYTES_PER_MS
    t_ops = ops / F32_OPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, src, line, launches, err, ms, plain_ms, bound):
    """One kernel of the ``kernels`` line."""
    return {"name": name, "route": "cuda",
            "source": f"gjkepa_tpu_torch/csrc/{src}",
            "replaces": f"gjkepa_tpu/ops/fused.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None}


def isum(t) -> int:
    return int(t.long().sum())


def maxerr(*pairs) -> float:
    """The max abs difference over (x, y) tensor pairs (0 when empty)."""
    return max(float((x - y).abs().max()) if x.numel() else 0.0
               for x, y in pairs)


def rows_equal(x, y, active=None) -> bool:
    """Bit-equal rows; GJK rows' simplex on the ``active`` lanes only (the
    plain version leaves probes in the others, the kernels zeros)."""
    if active is not None:
        x, y = ((*r[:4], r.simplex[active]) for r in (x, y))
    return all(torch.equal(a, b) for a, b in zip(x, y))


def gjk_ops(active, iters, probe_ops) -> float:
    """Operations of the GJK phase: the init's probes on each active lane,
    one probe and the tests of each iteration."""
    return ((active * GJK_INIT_PROBES + iters) * probe_ops
            + iters * GJK_ITER_OPS)


def epa_ops(iters, probe_ops, lanes=0) -> float:
    """Operations of the EPA ladder (a probe and a face scan an iteration)
    and, over ``lanes`` lanes, of the polish."""
    return (iters * (probe_ops + EPA_FACES * EPA_FACE_OPS)
            + lanes * POLISH_PROBES * (probe_ops + 20))


# -- the shape path ---------------------------------------------------------

def shape_inputs(pairs, dev):
    """ShapeBatches on the card from numpy pairs, their packed rows and the
    retirement bits."""
    from gjkepa_tpu_torch import ShapeBatch
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    a, b = (ShapeBatch.from_numpy(*p, device=dev) for p in pairs)
    retired, _ = fs.retirement(a, b)
    return a, b, a.packed(), b.packed(), retired


def plain_shapes_path(a, b, cfg):
    """fused_gjkepa_shapes (sort_hits=True) through the plain versions."""
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import FusedResult, hit_first_order
    sa, sb = a.packed(), b.packed()
    retired, env_dist = fs.retirement(a, b)
    c = fs.cf_shapes_plain(sa, sb, retired, cfg)
    order, n_act = hit_first_order(c.act)
    g = fs.gjk_sub_shapes_plain(sa, sb, retired, order, n_act, cfg)
    status = torch.where(c.act, g.status, c.status)
    order, n_act = hit_first_order(g.hit)
    e = fs.epa_shapes_plain(sa, sb, g.simplex, status, c.depth, c.normal,
                            order, n_act, fs.shape_stages(cfg))
    return fs.apply_retired(FusedResult(
        torch.where(c.act, g.hit, c.hit), e.status, e.depth, e.normal,
        g.iters, e.iters, torch.where(c.act, g.sep, c.distance)),
        retired, env_dist)


def compare_shape_kernels(sa, sb, retired, cfg, what):
    """K5, K6a, K6b and K7 against their plain versions on the same inputs,
    rows bit for bit (K6b's simplex on its GJK lanes: the plain version
    leaves probes in the others, the kernel zeros); returns each kernel's
    max abs error over its float outputs."""
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import hit_first_order

    def same(k, p, name, lanes=None):
        it_diff = int((k.iters != p.iters).sum()) if hasattr(k, "iters") \
            else 0
        check(rows_equal(k, p, lanes),
              f"{what}: {name} rows are not bit-equal to the plain version "
              f"(fields equal: {[torch.equal(x, y) for x, y in zip(k, p)]}, "
              f"iteration counts differ on {it_diff} lanes)")

    n = sa.shape[0]
    ck = fs.cf_shapes(sa, sb, retired, cfg)
    cp = fs.cf_shapes_plain(sa, sb, retired, cfg)
    torch.cuda.synchronize()
    same(ck, cp, "K5")
    e5 = maxerr((ck.depth, cp.depth), (ck.normal, cp.normal),
                (ck.distance, cp.distance))

    order, n_act = hit_first_order(cp.act)
    gk = fs.gjk_sub_shapes(sa, sb, retired, order, n_act, cfg)
    gp = fs.gjk_sub_shapes_plain(sa, sb, retired, order, n_act, cfg)
    torch.cuda.synchronize()
    same(gk, gp, "K6a")     # every row: the kernel writes the inactive ones
    e6a = maxerr((gk.sep, gp.sep), (gk.simplex, gp.simplex))

    hk = fs.gjk_shapes(sa, sb, retired, cfg)
    hp = fs.gjk_shapes_plain(sa, sb, retired, cfg)
    torch.cuda.synchronize()
    same(hk, hp, "K6b", cp.act)
    check(all(torch.equal(x, y) for x, y in zip(hk[5:], hp[5:])),
          f"{what}: K6b's closed-form channel is not bit-equal")
    e6b = maxerr((hk.sep, hp.sep), (hk.simplex[cp.act], hp.simplex[cp.act]),
                 (hk.cf_depth, hp.cf_depth), (hk.cf_normal, hp.cf_normal))

    epa = hp.hit & ~hp.final
    order, n_act = hit_first_order(epa)
    args = (sa, sb, hp.simplex, hp.status, hp.cf_depth, hp.cf_normal, order,
            n_act, fs.shape_stages(cfg))
    ek, ep = fs.epa_shapes(*args), fs.epa_shapes_plain(*args)
    torch.cuda.synchronize()
    e7 = maxerr((ek.depth, ep.depth), (ek.normal, ep.normal))
    same(ek, ep, "K7")
    log(f"{what} shape kernels vs plain, {n} pairs: K5, K6a over "
        f"{int(cp.act.sum())} GJK lanes, K6b, K7 over {int(n_act)} hits: "
        f"rows bit for bit")
    return {"cf_shapes": e5, "gjk_sub_shapes": e6a, "gjk_shapes": e6b,
            "epa_shapes": e7}


def shape_phases(gt, dev, cfg, card, n3=C3) -> list[dict]:
    """Phases 7-10, the shape path; returns the shape kernels' entries of
    the ``kernels`` line."""
    import ctypes

    from gjkepa_tpu_torch import _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    from gjkepa_tpu_torch.profile import kernel_launches

    # -- phase 7: the shape kernels vs their plain versions ------------------
    rng = np.random.default_rng(3)
    dense = (fixtures.kind_batch(3, n3 // 4, rng, spread=0.2),
             fixtures.kind_batch(3, n3 // 4, rng, spread=0.2))
    c3_np = fixtures.c3_pairs(0, n3)
    *c3s_np, perm = fixtures.c3_shuffled(0, n3)
    shape_err = {k: 0.0 for k in fs.LAUNCHES}
    mixed16 = fixtures.mixed16_pairs(n3 // 64, 7)
    odd = tuple(tuple(x[: n3 - 3] for x in side) for side in c3_np)
    spheres = (fixtures.kind_batch(0, n3 // 64, rng),
               fixtures.kind_batch(0, n3 // 64, rng))
    for what, pairs in (("phase 7 c3", c3_np), ("phase 7 c3 shuffled", c3s_np),
                        ("phase 7 mixed16", mixed16),
                        ("phase 7 dense cylinders", dense),
                        (f"phase 7 c3's first {n3 - 3} pairs", odd),
                        ("phase 7 spheres (no GJK lanes)", spheres)):
        errs = compare_shape_kernels(*shape_inputs(pairs, dev)[2:], cfg, what)
        shape_err = {k: max(v, errs[k]) for k, v in shape_err.items()}
    for iters in (1, 64):       # the shape ladder caps EPA at 16 iterations
        errs = compare_shape_kernels(
            *shape_inputs(c3_np, dev)[2:], cfg.replace(epa_max_iters=iters),
            f"phase 7 c3 epa_max_iters={iters}")
        shape_err = {k: max(v, errs[k]) for k, v in shape_err.items()}

    # -- phase 8: known shape geometry ---------------------------------------
    eye = np.eye(3, dtype=np.float32)
    known = (  # kind a, params a, pos a, kind b, params b, pos b, depth
        (0, (1, 0, 0), (0, 0, 0), 0, (1, 0, 0), (1.5, 0, 0), 0.5),
        (0, (0.5, 0, 0), (0.9, 0.1, 0), 1, (0.5, 0.5, 0.5), (0, 0, 0), 0.1),
        (1, (0.5, 0.5, 0.5), (0, 0, 0), 1, (0.5, 0.5, 0.5), (0.7, 0.2, 0),
         0.3),
        (2, (0.3, 0.5, 0), (0, 0, 0), 0, (0.4, 0, 0), (0.6, 0, 0.2), 0.1))
    side = [tuple(np.array([k[j + o] for k in known], dt) for j, dt in
                  ((0, np.int32), (1, np.float32), (2, np.float32)))
            + (np.stack([eye] * len(known)),) for o in (0, 3)]
    ka, kb = (gt.ShapeBatch.from_numpy(*x, device=dev) for x in side)
    kr = gt.collide_shapes_batch_fused(ka, kb, cfg=cfg)
    want = np.array([k[6] for k in known], np.float32)
    got = kr.depth.cpu().numpy()
    check(bool(kr.hit.all()) and got[0] == 0.5,
          f"phase 8: unit spheres at 1.5 give depth {got[0]}")
    check(float(np.abs(got - want).max()) <= 1e-6,
          f"phase 8: known depths {got} vs {want}")
    log(f"phase 8 known shape geometry: spheres at 1.5 depth exactly 0.5; "
        f"sphere-box, box-box and capsule-sphere depths {got.tolist()} "
        f"within 1e-6 of {want.tolist()}")

    # -- phase 9: the shape path at full size, launches counted ---------------
    a3, b3 = shape_inputs(c3_np, dev)[:2]
    a3s, b3s = shape_inputs(c3s_np, dev)[:2]
    perm = torch.from_numpy(perm).to(dev)
    split = {"cf_shapes": 1, "gjk_sub_shapes": 1, "gjk_shapes": 0,
             "epa_shapes": 1}   # sort_hits=True: K5, K6a, K7
    legacy = {"cf_shapes": 0, "gjk_sub_shapes": 0, "gjk_shapes": 1,
              "epa_shapes": 1}  # sort_hits=False: K6b, K7
    per_path = {}

    def counted(what, want, fn):
        """fn() with the shape counters set to 0 just before it; checks the
        exact launches it made."""
        torch.cuda.synchronize()
        for k in fs.LAUNCHES:
            fs.LAUNCHES[k] = 0
        out = fn()
        torch.cuda.synchronize()
        per_path[what] = dict(fs.LAUNCHES)
        check(per_path[what] == want,
              f"phase 9: {what} launched {per_path[what]}, expected {want}")
        return out

    nat = counted("natural", split,
                  lambda: gt.fused_gjkepa_shapes(a3, b3, cfg=cfg))
    shuf = counted("shuffled", split,
                   lambda: gt.fused_gjkepa_shapes(a3s, b3s, cfg=cfg))
    unsorted = counted("sort_hits=False", legacy,
                       lambda: gt.fused_gjkepa_shapes(a3, b3, cfg=cfg,
                                                      sort_hits=False))
    full3 = counted("collide", split,
                    lambda: gt.collide_shapes_batch_fused(a3, b3, cfg=cfg))
    # the c3 path's launches: the natural call, and K6b's own path
    shape_launches = dict(per_path["natural"],
                          gjk_shapes=per_path["sort_hits=False"]["gjk_shapes"])
    check(all(n > 0 for n in shape_launches.values()),
          f"phase 9: a shape kernel never launched: {shape_launches}")
    check(torch.equal(a3s.pos, a3.pos[perm]), "phase 9: shuffle permutation")
    for name, x, y, z in zip(nat._fields, nat, shuf, unsorted):
        check(torch.equal(y, x[perm]),
              f"phase 9: shuffled {name} is not the shuffled natural {name}")
        check(torch.equal(z, x), f"phase 9: sort_hits=False {name} differs")
    check(full3.nearest_points.shape == (n3, 2, 3)
          and full3.contact_point.shape == (n3, 3), "phase 9: bad shapes")
    for name, t in full3._asdict().items():
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"phase 9: {name} not finite")
    check(torch.equal(full3.hit, nat.hit) and torch.equal(full3.depth,
                                                          nat.depth),
          "phase 9: collide_shapes_batch_fused disagrees with the query")
    ps = plain_shapes_path(a3, b3, cfg)
    check(torch.equal(ps.hit, nat.hit) and torch.equal(ps.status, nat.status),
          "phase 9: shape path hit/status differ from the plain path")
    path_err = float((ps.depth - nat.depth).abs().max())
    check(path_err <= 1e-5, f"phase 9: depth differs from plain by {path_err}")
    ret_gpu, _ = fs.retirement(a3, b3)
    ret_cpu, _ = fs.retirement(*(gt.ShapeBatch(*(t.cpu() for t in x))
                                 for x in (a3, b3)))
    ret_diff = int((ret_gpu.cpu() != ret_cpu).sum())
    check(ret_diff == 0, f"phase 9: retirement differs on {ret_diff} lanes "
                         "between the card and the CPU")
    hits = int(nat.hit.sum())
    log(f"phase 9 shape path: c3 {n3} pairs, {hits} hits "
        f"({int((nat.epa_iters > 0).sum())} through K7, max epa_iters "
        f"{int(nat.epa_iters.max())}), {int(ret_gpu.sum())} retired (0 lanes "
        f"differ from the CPU's decision); shuffled order = shuffled "
        f"results, sort_hits True = False, collide_shapes_batch_fused finite, "
        f"equal to the plain path (depth err {path_err:.3g}); launches per "
        f"call {per_path}")

    # -- phase 10: shape timings, kernels vs plain, path -----------------------
    _, _, sa3, sb3, ret3 = shape_inputs(c3_np, dev)
    _, _, sa3s, sb3s, ret3s = shape_inputs(c3s_np, dev)
    c5 = fs.cf_shapes(sa3, sb3, ret3, cfg)
    o6, n6 = hit_first_order(c5.act)
    k6a = (sa3, sb3, ret3, o6, n6)
    g6 = fs.gjk_sub_shapes(*k6a, cfg)
    st6 = torch.where(c5.act, g6.status, c5.status)
    o7, n7 = hit_first_order(g6.hit)
    k7 = (sa3, sb3, g6.simplex, st6, c5.depth, c5.normal, o7, n7,
          fs.shape_stages(cfg))
    it6 = g6.iters[c5.act].float()
    log(f"phase 10 c3's GJK lanes: {int(n6)} (kinds a/b "
        f"{sorted(set(zip(a3.kind[c5.act].tolist(), b3.kind[c5.act].tolist())))}"
        f"), iterations mean {float(it6.mean()):.3f}, p99 "
        f"{float(torch.quantile(it6, 0.99)):.0f}, max {int(it6.max())}; "
        f"{int(g6.hit.sum())} hits")
    # K5's, K6a's and K6b's wrappers launch their kernel and nothing else:
    # K6a and K6b write every row (no zero fills)
    wrapper_launches = {
        "cf_shapes": kernel_launches(lambda: fs.cf_shapes(sa3, sb3, ret3,
                                                          cfg)),
        "gjk_sub_shapes": kernel_launches(lambda: fs.gjk_sub_shapes(*k6a,
                                                                    cfg)),
        "gjk_shapes": kernel_launches(lambda: fs.gjk_shapes(sa3, sb3, ret3,
                                                            cfg))}
    check(all(v == 1 for v in wrapper_launches.values()),
          f"phase 10: a shape wrapper launched more than its kernel: "
          f"{wrapper_launches}")
    path_launches = kernel_launches(
        lambda: gt.fused_gjkepa_shapes(a3, b3, cfg=cfg))
    log(f"phase 10 device launches: {wrapper_launches} a wrapper call; "
        f"fused_gjkepa_shapes at c3 {path_launches} a call")
    dirs = fs.INIT_DIRS.ctypes.data_as(ctypes.c_void_p)

    def kernel_alone(name, ins, outs):
        """``name``'s kernel through its C entry point, writing into rows
        allocated once: no allocation or compaction in the call."""
        ins, outs = [_build.ptr(t) for t in ins], [_build.ptr(t) for t in outs]
        return lambda: _build.launch(name, dev, {name: 0}, *ins, dirs, *outs,
                                     n3, *fs.gjk_args(cfg))

    k6b = fs.gjk_shapes(sa3, sb3, ret3, cfg)
    stimes = {
        "k5_c3": device_ms(lambda: fs.cf_shapes(sa3, sb3, ret3, cfg)),
        "k5_c3_shuffled": device_ms(lambda: fs.cf_shapes(sa3s, sb3s, ret3s,
                                                         cfg)),
        "k5_c3_plain": cuda_ms(lambda: fs.cf_shapes_plain(sa3, sb3, ret3,
                                                          cfg)),
        "k6a_c3": device_ms(lambda: fs.gjk_sub_shapes(*k6a, cfg)),
        "k6a_c3_kernel": device_ms(kernel_alone("gjk_sub_shapes", k6a, g6)),
        "k6a_c3_plain": cuda_ms(lambda: fs.gjk_sub_shapes_plain(
            sa3, sb3, ret3, o6, n6, cfg)),
        "k6b_c3": device_ms(lambda: fs.gjk_shapes(sa3, sb3, ret3, cfg)),
        "k6b_c3_kernel": device_ms(kernel_alone(
            "gjk_shapes", (sa3, sb3, ret3), k6b)),
        "k6b_c3_plain": cuda_ms(lambda: fs.gjk_shapes_plain(sa3, sb3, ret3,
                                                           cfg)),
        "k7_c3": device_ms(lambda: fs.epa_shapes(*k7)),
        "k7_c3_plain": cuda_ms(lambda: fs.epa_shapes_plain(*k7)),
        "path_c3": cuda_ms(lambda: gt.fused_gjkepa_shapes(a3, b3, cfg=cfg)),
        "path_c3_shuffled": cuda_ms(
            lambda: gt.fused_gjkepa_shapes(a3s, b3s, cfg=cfg)),
        "path_c3_unsorted": cuda_ms(lambda: gt.fused_gjkepa_shapes(
            a3, b3, cfg=cfg, sort_hits=False)),
        "path_c3_plain": cuda_ms(lambda: plain_shapes_path(a3, b3, cfg)),
        "collide_c3": cuda_ms(
            lambda: gt.collide_shapes_batch_fused(a3, b3, cfg=cfg)),
    }
    for key, ms in stimes.items():
        log(f"phase 10 time {key}: {ms:.4f} ms = {n3 / ms * 1e3:,.0f} "
            f"pairs/s [{card}]")
    log(f"phase 10 end to end: c3 {n3} pairs fused_gjkepa_shapes "
        f"{n3 / stimes['path_c3'] * 1e3:,.0f} q/s natural, "
        f"{n3 / stimes['path_c3_shuffled'] * 1e3:,.0f} q/s shuffled (plain "
        f"path {n3 / stimes['path_c3_plain'] * 1e3:,.0f}); "
        f"collide_shapes_batch_fused {n3 / stimes['collide_c3'] * 1e3:,.0f} "
        f"q/s [{card}]")

    # bounds at c3, from this run's lanes and iterations (see work())
    hk3, e7 = fs.gjk_shapes(sa3, sb3, ret3, cfg), fs.epa_shapes(*k7)
    n_gjk, n_epa, probe = int(n6), int(n7), 2 * SHAPE_OPS
    bounds = {
        "cf_shapes": work(n3, 129 + 26, n3 * CF_OPS),
        # the GJK lanes' rows, retirement and order entries; every other
        # pair's order entry and its written row
        "gjk_sub_shapes": work(1, n_gjk * 133 + (n3 - n_gjk) * (4 + 61),
                               gjk_ops(n_gjk, isum(g6.iters), probe)),
        "gjk_shapes": work(n3, 129 + 78, n3 * CF_OPS
                           + gjk_ops(n_gjk, isum(hk3.iters), probe)),
        "epa_shapes": work(n_epa, 180 + 24,
                           epa_ops(isum(e7.iters), probe, n_epa)),
    }
    return [entry(name, src, line, shape_launches[name], shape_err[name],
                  stimes[key], stimes[key + "_plain"], bounds[name])
            for name, src, line, key in (
                ("cf_shapes", "cf_shapes.cu", 1880, "k5_c3"),
                ("gjk_sub_shapes", "gjk_shapes.cu", 1910, "k6a_c3"),
                ("gjk_shapes", "gjk_shapes.cu", 1935, "k6b_c3"),
                ("epa_shapes", "epa_shapes.cu", 2131, "k7_c3"))]


# -- the distance and mixed paths ----------------------------------------------

def known_distance_pairs():
    """Known float32 distances, hulls padded to 8 vertices by repeating a
    vertex: cube gap 1, overlapping cubes, a tetrahedron apex 1 from a cube
    face, two segments crossing at height 0.3."""
    def cube(x):
        return np.array([[x + a, b, c] for a in (-.5, .5) for b in (-.5, .5)
                         for c in (-.5, .5)], np.float32)

    def pad(v):
        return np.concatenate([v, np.repeat(v[:1], 8 - len(v), 0)])

    tet = np.array([[1.0, 0, 0], [0, 0.6, 0.1], [0, -0.5, 0.4],
                    [0, -0.1, -0.6]], np.float32)
    seg1 = np.array([[-1.0, 0, 0], [1.0, 0, 0]], np.float32)
    seg2 = np.array([[0.0, -1, 0.3], [0.0, 1, 0.3]], np.float32)
    p1 = np.stack([cube(0.0), cube(0.0), pad(tet), pad(seg1)])
    p2 = np.stack([cube(2.0), cube(0.5), cube(2.5), pad(seg2)])
    return p1, p2, np.array([1.0, 0.0, 1.0, 0.3], np.float32)


def compare_k8(gt, p1, p2, cfg, what, teams=(None,)):
    """K8 against its plain version, rows bit for bit: phase 1 (cap 10),
    phase 2 (cap 64 over phase 1's unconverged pairs, into phase 1's rows)
    and one pass (cap 64), at each of ``teams`` (None: the wrapper's
    team); and the two-phase dispatch against one pass.  Returns the max
    abs error."""
    from gjkepa_tpu_torch.ops import fused_distance as fd
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    low = fd.distance_hulls_plain(p1, p2, cfg, 10)
    order, n_act = hit_first_order(~low.converged)
    p = fd.distance_hulls_plain(p1, p2, cfg, 64)
    restart = fd.DistanceRows(*(t.clone() for t in low))
    fd.distance_hulls_plain(p1, p2, cfg, 64, order, n_act, out=restart)
    check(rows_equal(restart, p), f"{what}: K8's plain restart differs from "
                                  "its one pass")
    err = 0.0
    for team in teams:
        runs = (("phase 1", fd._distance_hulls_cuda(p1, p2, cfg, 10,
                                                    team=team), low),
                ("phase 2", fd._distance_hulls_cuda(
                    p1, p2, cfg, 64, order, n_act, team=team,
                    out=fd.DistanceRows(*(t.clone() for t in low))), p),
                ("one pass", fd._distance_hulls_cuda(p1, p2, cfg, 64,
                                                     team=team), p))
        torch.cuda.synchronize()
        for name, k, want in runs:
            e = max(float((x - y).abs().max()) for x, y in (
                (k.distance, want.distance), (k.point_a, want.point_a),
                (k.point_b, want.point_b)))
            err = max(err, e)
            check(rows_equal(k, want),
                  f"{what}: K8 {name} (team {team or 'of the wrapper'}) is not "
                  f"bit-equal to the plain version (distance/witness err {e}, "
                  f"iters differ on {int((k.iters != want.iters).sum())} "
                  "lanes)")
    two = gt.fused_gjk_distance_hulls(p1, p2, cfg=cfg)
    one = gt.fused_gjk_distance_hulls(p1, p2, cfg=cfg, two_phase=False)
    for name, x, y in zip(one._fields, two, one):
        check(torch.equal(x, y), f"{what}: two-phase {name} differs from one "
                                 "pass")
    n1, n2 = p1.shape[1], p2.shape[1]
    log(f"{what} K8 vs plain, {p1.shape[0]} x {n1}: phase 1, phase 2 "
        f"({int(n_act)} pairs restarted) and one pass rows bit for bit at "
        f"teams {[t or fd.team_size(n1, n2, False) for t in teams]} (the "
        f"wrapper's: {fd.team_size(n1, n2, False)} over every pair, "
        f"{fd.team_size(n1, n2, True)} restarting); "
        f"{int(p.intersecting.sum())} intersecting, "
        f"{int((~p.converged).sum())} at the cap, mean iters "
        f"{float(p.iters.float().mean()):.3f}; two-phase = one pass bit for "
        "bit")
    return err


def mixed_plain_path(p1, shapes, cfg):
    """fused_gjkepa_hull_shapes (sort_hits=True) through the plain
    versions."""
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import FusedResult, hit_first_order
    sb = shapes.packed()
    env = fh.hull_shape_retirement(p1, sb, cfg)
    order, _ = hit_first_order(~env.retired)
    g = fh.gjk_hull_shape_plain(p1, sb, env.retired, order, cfg)
    order, n_act = hit_first_order(g.hit)
    e = fh.epa_hull_shape_plain(p1, sb, g.simplex, g.status, order, n_act,
                                fs.shape_stages(cfg))
    return FusedResult(g.hit, e.status, e.depth, e.normal, g.iters, e.iters,
                       torch.where(env.retired, env.distance, g.sep))


def compare_k9_k10(p1, sb, cfg, what, epa_iters=(None,)):
    """K9 and K10 against their plain versions on the same inputs, rows bit
    for bit: K9 through its wrapper and at every team size, each in the
    dispatch's active-first order and in the caller's (the simplex on the
    lanes that ran GJK), K10 at each of ``epa_iters`` (None: ``cfg``'s).
    Returns each kernel's max abs error, K9's rows and K10's hit count."""
    from gjkepa_tpu_torch.ops import fused_gjk
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    env = fh.hull_shape_retirement(p1, sb, cfg)
    order, _ = hit_first_order(~env.retired)
    gp = fh.gjk_hull_shape_plain(p1, sb, env.retired, order, cfg)
    ran = gp.status != 0            # the lanes that ran GJK
    caller = torch.arange(p1.shape[0], dtype=torch.int32, device=p1.device)
    e9 = 0.0
    for team in (None,) + fused_gjk.TEAMS:
        for how, o in (("sorted", order), ("caller's order", caller)):
            gk = (fh.gjk_hull_shape(p1, sb, env.retired, o, cfg) if team is None
                  else fh._gjk_hull_shape_cuda(p1, sb, env.retired, o, cfg,
                                               team))
            torch.cuda.synchronize()
            err = maxerr((gk.sep, gp.sep), (gk.simplex[ran], gp.simplex[ran]))
            e9 = max(e9, err)
            check(rows_equal(gk, gp, ran),
                  f"{what}: K9 (team {team or 'of the wrapper'}, {how}) rows "
                  f"are not bit-equal to the plain version (status equal: "
                  f"{torch.equal(gk.status, gp.status)}, iters differ on "
                  f"{int((gk.iters != gp.iters).sum())} of {isum(ran)} GJK "
                  f"lanes, sep/simplex err {err})")
    order, n_act = hit_first_order(gp.hit)
    e10 = 0.0
    for iters in epa_iters:
        c = cfg if iters is None else cfg.replace(epa_max_iters=iters)
        args = (p1, sb, gp.simplex, gp.status, order, n_act,
                fs.shape_stages(c))
        ek, ep = fh.epa_hull_shape(*args), fh.epa_hull_shape_plain(*args)
        torch.cuda.synchronize()
        err = maxerr((ek.depth, ep.depth), (ek.normal, ep.normal))
        e10 = max(e10, err)
        check(rows_equal(ek, ep),
              f"{what}: K10 (epa_max_iters {c.epa_max_iters}) rows are not "
              f"bit-equal to the plain version (status equal: "
              f"{torch.equal(ek.status, ep.status)}, depth/normal err {err}, "
              f"epa_iters differ on {int((ek.iters != ep.iters).sum())} of "
              f"{int(n_act)} K10 lanes)")
    log(f"{what} K9/K10 vs plain, {p1.shape[0]} x {p1.shape[1]}: "
        f"{isum(env.retired)} retired, {isum(ran)} GJK lanes; K9 rows bit for "
        f"bit at teams {[fh.team_size(p1.shape[1])] + list(fused_gjk.TEAMS)} "
        f"(the wrapper's first), sorted and in the caller's order; K10 "
        f"{int(n_act)} lanes, rows bit for bit at epa_max_iters "
        f"{[i or cfg.epa_max_iters for i in epa_iters]}")
    return e9, e10, gp, int(n_act)


def exact_sphere_depth(verts, c, rad):
    """Float64 depth of a sphere against a convex hull by convex projection
    (scipy): r - dist(centre, hull) outside, r + clearance inside."""
    from scipy.optimize import minimize
    from scipy.spatial import ConvexHull
    eq = ConvexHull(verts).equations
    a, off = eq[:, :3], -eq[:, 3]
    s = a @ c - off
    if (s <= 0).all():
        return rad + float(-s.max())
    res = minimize(lambda x: np.sum((x - c) ** 2), x0=verts.mean(0),
                   constraints=[{"type": "ineq", "fun": lambda x: off - a @ x}])
    return rad - float(np.linalg.norm(res.x - c))


def distance_and_mixed_phases(gt, dev, cfg, card, n2=65536, cut=1):
    """Phases 11-13, the distance and mixed paths at bench.py's c2 (n2
    pairs) and c3b (every ``cut``-th pair); returns K8, K9 and K10's
    entries of the ``kernels`` line."""
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_distance as fd
    from gjkepa_tpu_torch.ops import fused_gjk
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import hit_first_order, mask_to_padding

    def on_dev(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    # -- phase 11: K8 vs plain, two-phase = one pass, known distances ---------
    rng = np.random.default_rng(0)
    k8_err = compare_k8(gt, *on_dev(random_hulls(rng, 4096, 12, 2.0),
                                    random_hulls(rng, 4096, 12, 2.0)),
                        cfg, "phase 11 spread 2.0")
    d1, d2 = on_dev(*fixtures.c2_hulls(n=n2))
    k8_err = max(k8_err, compare_k8(gt, d1, d2, cfg, "phase 11 c2",
                                    (None,) + fused_gjk.TEAMS))
    k1, k2, want = known_distance_pairs()
    kr = gt.fused_gjk_distance_hulls(*on_dev(k1, k2), cfg=cfg)
    got = kr.distance.cpu().numpy()
    pa, pb = kr.point_a.cpu().numpy(), kr.point_b.cpu().numpy()
    check(float(np.abs(got - want).max()) <= 1e-6
          and abs(pa[0, 0] - 0.5) <= 1e-6 and abs(pb[0, 0] - 1.5) <= 1e-6
          and kr.intersecting.cpu().tolist() == [False, True, False, False],
          f"phase 11: known distances {got}, witnesses {pa[0]} {pb[0]}")
    log(f"phase 11 known distances: {got.tolist()} within 1e-6 of "
        f"{want.tolist()}, cube witnesses at x = {pa[0, 0]}, {pb[0, 0]}")

    # -- phase 12: K9/K10 vs plain, the mixed path, depth contract ------------
    hulls, shp = fixtures.c3b_pairs()
    hulls, shp = hulls[::cut], tuple(x[::cut] for x in shp)
    n3b = hulls.shape[0]
    (h3,) = on_dev(hulls)
    s3 = gt.ShapeBatch.from_numpy(*shp, device=dev)
    sb3 = s3.packed()
    e9, e10, g9, n10 = compare_k9_k10(h3, sb3, cfg, "phase 12 c3b",
                                      (None, 1, 16, 64))
    # each remainder mod 4 (K11's single-vertex scan below 24), and hulls
    # padded through a mask, whose repeated vertices tie exactly
    keep = torch.from_numpy(np.random.default_rng(9).random(
        hulls.shape[:2]) > 0.2).to(dev)
    keep[:, 1] = True
    padded = mask_to_padding(h3, keep).contiguous()
    cuts = [(f"N={n}", h3[:, :n].contiguous()) for n in (21, 22, 23)]
    for what, hv in cuts + [("masked", padded)]:
        c9, c10, *_ = compare_k9_k10(hv, sb3, cfg, f"phase 12 c3b {what}")
        e9, e10 = max(e9, c9), max(e10, c10)
    by_mask = gt.fused_gjkepa_hull_shapes(h3, s3, mask1=keep, cfg=cfg)
    by_pad = gt.fused_gjkepa_hull_shapes(padded, s3, cfg=cfg)
    check(all(torch.equal(x, y) for x, y in zip(by_mask, by_pad)),
          "phase 12: the masked mixed path differs from its padding")
    mixed = gt.fused_gjkepa_hull_shapes(h3, s3, cfg=cfg)
    unsorted = gt.fused_gjkepa_hull_shapes(h3, s3, cfg=cfg, sort_hits=False)
    plain = mixed_plain_path(h3, s3, cfg)
    for name, x, y, z in zip(mixed._fields, mixed, unsorted, plain):
        check(torch.equal(x, y), f"phase 12: sort_hits=False {name} differs")
        if name in ("hit", "status"):
            check(torch.equal(x, z), f"phase 12: {name} differs from plain")
        elif x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"phase 12: {name} not "
                                                 "finite")
            err = float((x - z).abs().max())
            check(err <= 1e-5, f"phase 12: {name} differs from plain by {err}")
    hit = mixed.hit
    moved = gt.ShapeBatch(s3.kind[hit], s3.params[hit], s3.pos[hit]
                          + mixed.normal[hit] * (mixed.depth[hit]
                                                 + 1e-3)[:, None],
                          s3.rot[hit])
    apart = gt.fused_gjkepa_hull_shapes(h3[hit].contiguous(), moved, cfg=cfg)
    check(not bool(apart.hit.any()), f"phase 12: {isum(apart.hit)} of "
          f"{isum(hit)} hit pairs still touch after the separating shift")
    rng = np.random.default_rng(0)
    sp = random_hulls(rng, 32, 16, 0.5)
    rad = (0.4 + 0.4 * rng.random(32)).astype(np.float32)
    ctr = rng.normal(size=(32, 3)).astype(np.float32) * 0.5
    sr = gt.fused_gjkepa_hull_shapes(*on_dev(sp), gt.spheres(
        rad, pos=ctr, device=dev), cfg=cfg)
    sphere_err = [abs(float(sr.depth[i]) - exact_sphere_depth(
        sp[i].astype(np.float64), ctr[i].astype(np.float64), float(rad[i])))
        for i in np.nonzero(sr.hit.cpu().numpy())[0]]
    # 2e-3 on the first 12 hits as tests/test_mixed_fused.py; the capped
    # EPA and the polish leave up to 3.2e-3 on a later lane (JAX's depth
    # there is the same)
    check(len(sphere_err) >= 12 and max(sphere_err[:12]) < 2e-3
          and max(sphere_err) < 5e-3,
          f"phase 12: hull-sphere depth errors {sphere_err}")
    log(f"phase 12 mixed path: c3b {n3b} pairs, {isum(hit)} hits, sort_hits "
        f"True = False, a mask equal to its padding, equal to the plain path, "
        f"every hit pair apart after "
        f"the shift depth*normal + 1e-3; hull-sphere depth vs the float64 "
        f"projection: max err {max(sphere_err[:12]):.3g} on the first 12 "
        f"hits (tol 2e-3), {max(sphere_err):.3g} on all {len(sphere_err)} "
        "(tol 5e-3)")

    # -- phase 13: the paths at full size, launches counted, timings ----------
    per_call = {}

    def counted(what, want, fn):
        """fn() with the distance and mixed kernels' launch counters set to
        0 just before it; checks the exact launches it made."""
        torch.cuda.synchronize()
        for counts in (fd.LAUNCHES, fh.LAUNCHES):
            for k in counts:
                counts[k] = 0
        out = fn()
        torch.cuda.synchronize()
        per_call[what] = {**fd.LAUNCHES, **fh.LAUNCHES}
        want = {"distance_hulls": 0, "gjk_hull_shape": 0,
                "epa_hull_shape": 0, **want}
        check(per_call[what] == want,
              f"phase 13: {what} launched {per_call[what]}, expected {want}")
        return out

    dist = counted("distance", {"distance_hulls": 2},
                   lambda: gt.fused_gjk_distance_hulls(d1, d2, cfg=cfg))
    dist1 = counted("distance one pass", {"distance_hulls": 1},
                    lambda: gt.fused_gjk_distance_hulls(d1, d2, cfg=cfg,
                                                        two_phase=False))
    mix = counted("mixed", {"gjk_hull_shape": 1, "epa_hull_shape": 1},
                  lambda: gt.fused_gjkepa_hull_shapes(h3, s3, cfg=cfg))
    boolean = counted("mixed boolean", {"gjk_hull_shape": 1},
                      lambda: gt.fused_gjkepa_hull_shapes(
                          h3, s3, cfg=cfg.replace(epa_max_iters=0)))
    check(all(torch.equal(x, y) for x, y in zip(dist, dist1))
          and all(torch.equal(x, y) for x, y in zip(mix, mixed))
          and torch.equal(boolean.hit, mix.hit),
          "phase 13: a counted call differs from phases 11-12")
    log(f"phase 13 launches per call: {per_call}")

    p1_out = fd.distance_hulls(d1, d2, cfg, 10)
    o8, n8 = hit_first_order(~p1_out.converged)
    p2_out = fd.distance_hulls(d1, d2, cfg, 64, o8, n8,
                               out=fd.DistanceRows(*(t.clone()
                                                     for t in p1_out)))
    env = fh.hull_shape_retirement(h3, sb3, cfg)
    o9, _ = hit_first_order(~env.retired)
    o10, n10t = hit_first_order(g9.hit)
    k10 = (h3, sb3, g9.simplex, g9.status, o10, n10t, fs.shape_stages(cfg))
    times = {
        "k8_phase1_c2": device_ms(lambda: fd.distance_hulls(d1, d2, cfg, 10)),
        "k8_phase2_c2": device_ms(lambda: fd.distance_hulls(
            d1, d2, cfg, 64, o8, n8, out=p2_out)),
        "k8_one_pass_c2": device_ms(lambda: fd.distance_hulls(d1, d2, cfg,
                                                            64)),
        "k8_phase1_c2_plain": cuda_ms(lambda: fd.distance_hulls_plain(
            d1, d2, cfg, 10), PLAIN_CALLS, 1),
        "k8_phase2_c2_plain": cuda_ms(lambda: fd.distance_hulls_plain(
            d1, d2, cfg, 64, o8, n8, out=p2_out), PLAIN_CALLS, 1),
        "path_dist_c2": cuda_ms(lambda: gt.fused_gjk_distance_hulls(
            d1, d2, cfg=cfg)),
        "path_dist_c2_one_pass": cuda_ms(lambda: gt.fused_gjk_distance_hulls(
            d1, d2, cfg=cfg, two_phase=False)),
        "k9_c3b": device_ms(lambda: fh.gjk_hull_shape(h3, sb3, env.retired, o9,
                                                    cfg)),
        "k9_c3b_plain": cuda_ms(lambda: fh.gjk_hull_shape_plain(
            h3, sb3, env.retired, o9, cfg), PLAIN_CALLS, 1),
        "k10_c3b": device_ms(lambda: fh.epa_hull_shape(*k10)),
        "k10_c3b_plain": cuda_ms(lambda: fh.epa_hull_shape_plain(*k10),
                                 PLAIN_CALLS, 1),
        "path_c3b": cuda_ms(lambda: gt.fused_gjkepa_hull_shapes(h3, s3,
                                                                cfg=cfg)),
        "path_c3b_unsorted": cuda_ms(lambda: gt.fused_gjkepa_hull_shapes(
            h3, s3, cfg=cfg, sort_hits=False)),
        "path_c3b_plain": cuda_ms(lambda: mixed_plain_path(h3, s3, cfg),
                                  PLAIN_CALLS, 1),
    }
    times["path_dist_c2_plain"] = (times["k8_phase1_c2_plain"]
                                   + times["k8_phase2_c2_plain"])
    for key, ms in times.items():
        b = n3b if "c3b" in key else n2
        log(f"phase 13 time {key}: {ms:.4f} ms = {b / ms * 1e3:,.0f} pairs/s "
            f"[{card}]")
    nd1, nd2 = d1.shape[1], d2.shape[1]
    log(f"phase 13 K8 at c2: phase 1 {times['k8_phase1_c2']:.4f} ms at a "
        f"team of {fd.team_size(nd1, nd2, False)}, phase 2 "
        f"{times['k8_phase2_c2']:.4f} ms over {int(n8)} restarted pairs at a "
        f"team of {fd.team_size(nd1, nd2, True)}, one pass "
        f"{times['k8_one_pass_c2']:.4f} ms at a team of "
        f"{fd.team_size(nd1, nd2, False)} (K7 at c3: phase 10) [{card}]")
    log(f"phase 13 K9 at c3b: {times['k9_c3b']:.4f} ms at a team of "
        f"{fh.team_size(h3.shape[1])}; K10 {times['k10_c3b']:.4f} ms over "
        f"{n10} hits, a warp a hit [{card}]")
    log(f"phase 13 end to end: c2 {n2} x 64 fused_gjk_distance_hulls "
        f"{n2 / times['path_dist_c2'] * 1e3:,.0f} q/s two-phase, "
        f"{n2 / times['path_dist_c2_one_pass'] * 1e3:,.0f} q/s one pass "
        f"(plain {n2 / times['path_dist_c2_plain'] * 1e3:,.0f}); c3b {n3b} "
        f"x 24 fused_gjkepa_hull_shapes "
        f"{n3b / times['path_c3b'] * 1e3:,.0f} q/s (plain path "
        f"{n3b / times['path_c3b_plain'] * 1e3:,.0f}) [{card}]; plain "
        f"versions timed {PLAIN_CALLS} times after 1 warm-up call")

    # bounds, from this run's lanes and iterations (see work())
    nv2 = d1.shape[1] + d2.shape[1]
    nv3 = h3.shape[1]
    one = fd.distance_hulls(d1, d2, cfg, 64)
    it8 = isum(one.iters)
    k8_bound = work(n2, nv2 * 12 + 34,
                    (n2 + it8) * VERTEX_OPS * nv2 + it8 * DIST_ITER_OPS)
    probe = VERTEX_OPS * nv3 + SHAPE_OPS
    k9_bound = work(n3b, nv3 * 12 + 69 + 61, n3b * nv3 * SPHERE_OPS
                    + gjk_ops(isum(g9.status != 0), isum(g9.iters), probe))
    e10r = fh.epa_hull_shape(*k10)
    k10_bound = work(n10, nv3 * 12 + 120 + 24,
                     epa_ops(isum(e10r.iters), probe, n10))
    return [
        entry("distance_hulls", "distance_hulls.cu", 2867,
              per_call["distance"]["distance_hulls"], k8_err,
              times["k8_phase1_c2"] + times["k8_phase2_c2"],
              times["path_dist_c2_plain"], k8_bound),
        entry("gjk_hull_shape", "gjk_hull_shape.cu", 2571,
              per_call["mixed"]["gjk_hull_shape"], e9, times["k9_c3b"],
              times["k9_c3b_plain"], k9_bound),
        entry("epa_hull_shape", "epa_hull_shape.cu", 2588,
              per_call["mixed"]["epa_hull_shape"], e10, times["k10_c3b"],
              times["k10_c3b_plain"], k10_bound),
    ]


# -- the large-hull path -------------------------------------------------------

def big_phases(gt, dev, cfg, card) -> list[dict]:
    """Phases 14-15, the large-hull path (n1 + n2 > 4096) at 256 x 8192
    (tests/test_fused_tpu.py:248-290's pairs) and 4096 x 2600; returns K12
    and K13's entries of the ``kernels`` line."""
    from gjkepa_tpu_torch import _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import contact_rows, fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops import fused_streamed as fst
    from gjkepa_tpu_torch.ops.fused import (cascade_plan, hit_first_order,
                                            hulls_result)
    stages = cascade_plan(cfg)
    bool_cfg = cfg.replace(epa_max_iters=0)

    def on_dev(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    def plain_big_path(p1, p2, c):
        """fused_hulls_streamed through the plain versions."""
        active = fst.streamed_broadphase(p1, p2, c.broadphase_tol)
        g = fst.gjk_hulls_big_plain(p1, p2, active, c)
        return hulls_result(g, cascade_plan(c), lambda *a: (
            fst.epa_hulls_big_plain(p1, p2, g.simplex, g.status, *a)))

    lib = _build.load()

    def compare_big(p1, p2, what):
        """K12 and K13 against their plain versions on the same inputs, bit
        for bit; returns their max abs errors."""
        n1, n2 = p1.shape[1], p2.shape[1]
        staged = lib.gjk_hulls_big_staged(n1, n2)
        active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
        gk = fst.gjk_hulls_big(p1, p2, active, cfg)
        gp = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
        torch.cuda.synchronize()
        n_on = isum(active)
        d12 = int((gk.iters != gp.iters).sum())
        e12 = max(float((gk.sep - gp.sep).abs().max()),
                  float((gk.simplex - gp.simplex)[active].abs().max()))
        check(rows_equal(gk, gp, active),
              f"{what}: K12 rows are not bit-equal to the plain version "
              f"(hit/status equal: {torch.equal(gk.status, gp.status)}, "
              f"iters differ on {d12} of {n_on} lanes, sep/simplex err "
              f"{e12})")
        order, n_act = hit_first_order(gp.hit)
        args = (p1, p2, gp.simplex, gp.status, order, n_act, stages)
        ek, ep = fst.epa_hulls_big(*args), fst.epa_hulls_big_plain(*args)
        torch.cuda.synchronize()
        e13 = max(float((ek.depth - ep.depth).abs().max()),
                  float((ek.normal - ep.normal).abs().max()))
        d13 = int((ek.iters != ep.iters).sum())
        check(rows_equal(ek, ep),
              f"{what}: K13 rows are not bit-equal to the plain version "
              f"(status equal: {torch.equal(ek.status, ep.status)}, depth/"
              f"normal err {e13}, iters differ on {d13} of {int(n_act)})")
        log(f"{what} K12/K13 vs plain, {p1.shape[0]} x {n1} + {n2}: {n_on} "
            f"active, {int(n_act)} hits; K12 "
            + ("staged in shared memory" if staged else
               "scanning device memory")
            + ", rows bit for bit; K13 rows bit for bit")
        return e12, e13

    # -- phase 14: K12/K13 vs plain, ties, sub-hulls, K1/K2 = K12/K13 ---------
    t0 = time.perf_counter()
    h1, h2 = on_dev(*fixtures.big_c2_pairs())
    b1, b2 = on_dev(*fixtures.big_pairs_8192())
    (s1, s2), (q1, q2) = (on_dev(*x) for x in fixtures.big_subhull_pairs())
    log(f"phase 14 inputs: 4096 x 2600 and 256 x 8192 pairs made and moved "
        f"in {time.perf_counter() - t0:.2f} s")
    past = on_dev(*(fixtures.random_hulls(np.random.default_rng(14), 8,
                                          10240, 0.2) for _ in range(2)))
    check(not lib.gjk_hulls_big_staged(10240, 10240),
          "phase 14: K12 stages 10240 + 10240 vertices")
    errs = [compare_big(h1, h2, "phase 14 4096 x 2600"),
            compare_big(*on_dev(*fixtures.tie_pairs()), "phase 14 ties"),
            compare_big(b1, b2, "phase 14 256 x 8192"),
            compare_big(*past, "phase 14 past shared memory, 8 x 10240")]
    e12, e13 = (max(e[k] for e in errs) for k in (0, 1))

    # K13 over a ladder whose first tiers overflow, so that the retries run
    # over the same shared-memory store; at 2601 vertices K11 takes its
    # scalar scan (not a multiple of 4)
    ladder = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((8, 2), (16, 4), (208, 16))]
    odd = on_dev(*(fixtures.random_hulls(np.random.default_rng(12), 512, 2601)
                   for _ in range(2)))
    for l1, l2 in ((h1[:512].contiguous(), h2[:512].contiguous()), odd):
        la = fst.streamed_broadphase(l1, l2, cfg.broadphase_tol)
        lg = fst.gjk_hulls_big_plain(l1, l2, la, cfg)
        lo, ln = hit_first_order(lg.hit)
        largs = (l1, l2, lg.simplex, lg.status, lo, ln, ladder)
        lp = fst.epa_hulls_big_plain(*largs)
        check(rows_equal(fst.epa_hulls_big(*largs), lp),
              f"phase 14: K13 differs from plain on the overflow ladder at "
              f"{l1.shape[1]} vertices")
        log(f"phase 14 overflow ladder (F, K) = (8, 2), (16, 4), (208, 16): "
            f"512 x {l1.shape[1]}, {int(ln)} hits, mean epa_iters "
            f"{float(lp.iters[lg.hit].float().mean()):.3f}, K13 bit for bit")
    odd_err = compare_big(*odd, "phase 14 512 x 2601")
    e12, e13 = max(e12, odd_err[0]), max(e13, odd_err[1])

    rr = gt.fused_gjkepa_hulls(s1, s2, cfg=cfg)      # n1 + n2 = 4096: K1/K2
    rs = gt.fused_gjkepa_hulls(q1, q2, cfg=cfg)      # padded to 8192: K12/K13
    hit = rr.hit
    sub_err = float((rs.depth - rr.depth)[hit].abs().max())
    check(torch.equal(rs.hit, rr.hit) and sub_err <= 1e-6,
          f"phase 14: sub-hulls padded to 8192 differ from the resident "
          f"path (depth err {sub_err})")
    log(f"phase 14 sub-hulls: 256 x 2048 through K1/K2 and padded to 8192 "
        f"through K12/K13: hit equal ({isum(hit)} hits), depth err "
        f"{sub_err:.3g} (tol 1e-6)")

    # K1/K2 on the 256 x 8192 pairs, where every lane is active on both
    act = fst.streamed_broadphase(b1, b2, cfg.broadphase_tol)
    g1 = fused_gjk.gjk_hulls(b1, b2, cfg)
    g12 = fst.gjk_hulls_big(b1, b2, act, cfg)
    check(bool(act.all()) and bool((g1.status != 0).all()),
          "phase 14: a 256 x 8192 lane is inactive")
    check(rows_equal(g1, g12), "phase 14: K1 rows differ from K12's")
    o8, n8 = hit_first_order(g12.hit)
    k2_rows = fused_epa.epa_cascade(b1, b2, g12.simplex, g12.status, o8, n8,
                                    stages)
    k13_rows = fst.epa_hulls_big(b1, b2, g12.simplex, g12.status, o8, n8,
                                 stages)
    check(rows_equal(k2_rows, k13_rows), "phase 14: K2 rows differ from K13's")
    log("phase 14 K1/K2 against K12/K13 at 256 x 8192: every lane active on "
        "both, GJK and EPA rows bit for bit")

    # -- phase 15: the large-hull path at full width, launches counted -------
    per_call = {}

    def counted(what, want, fn):
        """fn() with the hull kernels' counters set to 0 just before it;
        checks the exact launches it made."""
        torch.cuda.synchronize()
        fused_gjk.LAUNCHES = fused_epa.LAUNCHES = 0
        for k in fst.LAUNCHES:
            fst.LAUNCHES[k] = 0
        out = fn()
        torch.cuda.synchronize()
        per_call[what] = {"gjk_hulls": fused_gjk.LAUNCHES,
                          "epa_hulls": fused_epa.LAUNCHES, **fst.LAUNCHES}
        want = {"gjk_hulls": 0, "epa_hulls": 0, "gjk_hulls_big": 1,
                "epa_hulls_big": 0, **want}
        check(per_call[what] == want,
              f"phase 15: {what} launched {per_call[what]}, expected {want}")
        return out

    full = counted("256 x 8192 contact", {"epa_hulls_big": 1},
                   lambda: gt.gjkepa_batch_fused(b1, b2, cfg=cfg))
    c2r = counted("4096 x 2600", {"epa_hulls_big": 1},
                  lambda: gt.fused_gjkepa_hulls(h1, h2, cfg=cfg))
    c2b = counted("4096 x 2600 boolean", {},
                  lambda: gt.fused_gjkepa_hulls(h1, h2, cfg=bool_cfg))
    for name, t in (*full._asdict().items(), *c2r._asdict().items()):
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"phase 15: {name} not "
                                                 "finite")
    check(isum(full.hit) > 50, f"phase 15: {isum(full.hit)} hits at 8192")
    check(torch.equal(c2b.hit, c2r.hit), "phase 15: boolean hits differ")

    # masks equal repeated-vertex padding: 10% of rows out, row 0 kept
    rng = np.random.default_rng(15)
    m1, m2 = (torch.from_numpy(rng.random((256, 8192)) > 0.1).to(dev)
              for _ in range(2))
    m1[:, 0] = m2[:, 0] = True
    pad1 = torch.where(m1[:, :, None], b1, b1[:, :1])
    pad2 = torch.where(m2[:, :, None], b2, b2[:, :1])
    masked = gt.gjkepa_batch_fused(b1, b2, m1, m2, cfg=cfg)
    padded = gt.fused_gjkepa_hulls(pad1, pad2, cfg=cfg)
    for name in ("hit", "status", "depth", "gjk_iters", "epa_iters",
                 "distance"):
        check(torch.equal(getattr(masked, name), getattr(padded, name)),
              f"phase 15: masked {name} differs from repeated-vertex "
              "padding")
    for name, t in masked._asdict().items():
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"phase 15: masked {name} "
                                                 "not finite")

    # the whole path against the plain path
    pr = plain_big_path(b1, b2, cfg)
    pc = plain_big_path(h1, h2, cfg)
    check(torch.equal(pr.hit, full.hit) and torch.equal(pr.status, full.status)
          and torch.equal(pc.hit, c2r.hit) and torch.equal(pc.status,
                                                           c2r.status),
          "phase 15: hit/status differ from the plain path")
    depth_err = max(float((pr.depth - full.depth).abs().max()),
                    float((pc.depth - c2r.depth).abs().max()))
    check(depth_err <= 1e-5, f"phase 15: depth differs by {depth_err}")
    _, cp, _, ct = contact_rows.derive_contact_rows(b1, b2, pr.normal, cfg)
    ph = pr.hit & ((pr.normal * full.normal).sum(1) > 1.0 - 1e-5)
    cp_err = float((cp[ph] - full.contact_point[ph]).abs().max())
    check(cp_err <= 1e-5 and torch.equal(ct[ph], full.colli_type[ph]),
          f"phase 15: contact rows differ from plain by {cp_err}")
    log(f"phase 15 large-hull path: gjkepa_batch_fused 256 x 8192 full "
        f"contact v2: finite, {isum(full.hit)} hits, mean gjk_iters "
        f"{float(full.gjk_iters.float().mean()):.3f}, mean epa_iters "
        f"{float(full.epa_iters.float().mean()):.3f}; fused_gjkepa_hulls "
        f"4096 x 2600: {isum(c2r.hit)} hits, "
        f"{isum(c2r.status == 0)} broadphase misses; masked 10% = "
        f"repeated-vertex padding bit for bit; equal to the plain path "
        f"(depth err {depth_err:.3g}, contact point err {cp_err:.3g} on "
        f"{isum(ph)} lanes); launches per call {per_call}")

    # -- timings -------------------------------------------------------------
    rows = {}
    for key, p1, p2 in (("8192", b1, b2), ("2600", h1, h2)):
        a = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
        g = fst.gjk_hulls_big(p1, p2, a, cfg)
        o, n = hit_first_order(g.hit)
        rows[key] = (p1, p2, a, g, o, n)
    times = {}
    for key, (p1, p2, a, g, o, n) in rows.items():
        k13 = (p1, p2, g.simplex, g.status, o, n, stages)
        times.update({
            f"broadphase_{key}": cuda_ms(lambda: fst.streamed_broadphase(
                p1, p2, cfg.broadphase_tol)),
            f"k12_{key}": device_ms(lambda: fst.gjk_hulls_big(p1, p2, a, cfg)),
            f"k12_{key}_plain": cuda_ms(lambda: fst.gjk_hulls_big_plain(
                p1, p2, a, cfg), PLAIN_CALLS, 1),
            f"k13_{key}": device_ms(lambda: fst.epa_hulls_big(*k13)),
            f"k13_{key}_plain": cuda_ms(lambda: fst.epa_hulls_big_plain(
                *k13), PLAIN_CALLS, 1),
            f"k1_{key}": cuda_ms(lambda: fused_gjk.gjk_hulls(p1, p2, cfg)),
            f"k2_{key}": cuda_ms(lambda: fused_epa.epa_cascade(*k13)),
            f"query_{key}": cuda_ms(lambda: gt.fused_gjkepa_hulls(
                p1, p2, cfg=cfg)),
            f"query_{key}_plain": cuda_ms(lambda: plain_big_path(
                p1, p2, cfg), PLAIN_CALLS, 1),
        })
    times["path_8192"] = cuda_ms(lambda: gt.gjkepa_batch_fused(b1, b2,
                                                               cfg=cfg))
    times["contact_8192"] = cuda_ms(lambda: gt.derive_contact_batch(
        b1, b2, full, cfg))
    times["query_2600_boolean"] = cuda_ms(lambda: gt.fused_gjkepa_hulls(
        h1, h2, cfg=bool_cfg))
    times["query_2048_resident"] = cuda_ms(lambda: gt.fused_gjkepa_hulls(
        s1, s2, cfg=cfg))
    for key, ms in times.items():
        b = 4096 if "2600" in key else 256
        log(f"phase 15 time {key}: {ms:.4f} ms = {b / ms * 1e3:,.0f} pairs/s "
            f"[{card}]")
    ratio = times["query_8192"] / (4 * times["query_2048_resident"])
    log(f"phase 15 end to end: gjkepa_batch_fused 256 x 8192 full contact "
        f"{256 / times['path_8192'] * 1e3:,.0f} q/s; fused_gjkepa_hulls "
        f"256 x 8192 {256 / times['query_8192'] * 1e3:,.0f} q/s (plain "
        f"{256 / times['query_8192_plain'] * 1e3:,.0f}), 4096 x 2600 "
        f"{4096 / times['query_2600'] * 1e3:,.0f} q/s (boolean "
        f"{4096 / times['query_2600_boolean'] * 1e3:,.0f}, plain "
        f"{4096 / times['query_2600_plain'] * 1e3:,.0f}); K1/K2 on the same "
        f"inputs {times['k1_8192']:.4f}/{times['k2_8192']:.4f} ms at 8192, "
        f"{times['k1_2600']:.4f}/{times['k2_2600']:.4f} ms at 2600 against "
        f"K12/K13 {times['k12_8192']:.4f}/{times['k13_8192']:.4f} and "
        f"{times['k12_2600']:.4f}/{times['k13_2600']:.4f} ms; scaling "
        f"t(8192) / (4 t(2048 resident)) = {ratio:.3f} (observed, no "
        f"limit) [{card}]")

    def bounds(key):
        """K12's and K13's bounds, from this run's lanes and iterations
        (see work())."""
        p1, p2, a, g, o, n = rows[key]
        nv = p1.shape[1] + p2.shape[1]
        e = fst.epa_hulls_big(p1, p2, g.simplex, g.status, o, n, stages)
        return (work(p1.shape[0], nv * 12 + 1 + 61,
                     gjk_ops(isum(a), isum(g.iters), VERTEX_OPS * nv)),
                work(int(n), nv * 12 + 56 + 24,
                     epa_ops(isum(e.iters), VERTEX_OPS * nv)))

    (k12_bound, k13_bound), (b12, b13) = bounds("8192"), bounds("2600")
    for key, (p1, p2, a, g, o, n) in rows.items():
        e = fst.epa_hulls_big(p1, p2, g.simplex, g.status, o, n, stages)
        epa_it = isum(e.iters) / max(int(n), 1)
        probes = (isum(g.iters) + GJK_INIT_PROBES * isum(a)) / max(isum(a), 1)
        per_probe = times[f"k12_{key}"] / probes
        log(f"phase 15 split {key}: K13 {times[f'k13_{key}']:.4f} ms over "
            f"{epa_it:.3f} EPA iterations a hit = "
            f"{times[f'k13_{key}'] / epa_it:.5f} ms an iteration (max "
            f"{int(e.iters.max())}); K12 {times[f'k12_{key}']:.4f} ms over "
            f"{probes:.3f} probes a pair = {per_probe:.5f} ms a block probe; "
            f"proxy K12 probe x K13 iterations = {per_probe * epa_it:.4f} ms "
            f"[{card}]")
    log(f"phase 15 bounds: 256 x 8192 K12 {k12_bound[0]:.4f} ms "
        f"({k12_bound[1]}), K13 {k13_bound[0]:.4f} ms ({k13_bound[1]}); "
        f"4096 x 2600 K12 {b12[0]:.4f} ms ({b12[1]}), K13 {b13[0]:.4f} ms "
        f"({b13[1]})")
    launches = per_call["256 x 8192 contact"]
    return [
        entry("gjk_hulls_big", "gjk_hulls_big.cu", 1073,
              launches["gjk_hulls_big"], e12, times["k12_8192"],
              times["k12_8192_plain"], k12_bound),
        entry("epa_hulls_big", "epa_hulls_big.cu", 1086,
              launches["epa_hulls_big"], e13, times["k13_8192"],
              times["k13_8192_plain"], k13_bound),
    ]


# -- the portable path -----------------------------------------------------------

def portable_phase(gt, dev, card, n4=16384, n3=C3, n3b=None,
                   oracle_pairs=256) -> None:
    """Phase 16: the portable path (``gjkepa``, ``gjkepa_batch``,
    ``collide_shapes_batch``, ``collide_hull_shape_batch``: torch code, no
    kernel of its own) on the card through its entry points."""
    from gjkepa_tpu_torch.models import fixtures
    cfg = gt.GJKEPAConfig.for_f32()

    def wall_ms(fn, calls=TIMED_CALLS):
        """Median host wall of one synchronised call, ms (the portable
        loops read a device flag every iteration, so the host waits on the
        card anyway)."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def finite(r, what):
        for name, t in r._asdict().items():
            check(t.device == dev, f"phase 16: {what} {name} on {t.device}")
            if t.is_floating_point():
                check(bool(torch.isfinite(t).all()),
                      f"phase 16: {what} {name} not finite")

    # c1: one cube pair (bench.py:144-162)
    corners = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                        for z in (-.5, .5)], np.float32)
    c1 = torch.from_numpy(corners).to(dev)
    c2 = torch.from_numpy(corners + np.array([0.5, 0, 0], np.float32)).to(dev)
    r = gt.gjkepa(c1, c2, cfg=cfg)
    finite(r, "c1")
    check(bool(r.hit) and abs(float(r.depth) - 0.5) < 1e-4,
          f"phase 16: c1 depth {float(r.depth)}, status {int(r.status)}")
    times = {"c1": wall_ms(lambda: gt.gjkepa(c1, c2, cfg=cfg))}

    # c4: deep pairs in float32, then a sample in float64 against the oracle
    rng = np.random.default_rng(0)                  # phase 5's recipe
    m1, m2 = (torch.from_numpy(a).to(dev) for a in deep_pairs(rng, n4, 24))
    r4 = gt.gjkepa_batch(m1, m2, cfg=cfg)
    finite(r4, "c4")
    hit4 = float(r4.hit.float().mean())
    check(r4.contact_point.shape == (n4, 3) and hit4 >= 0.9,
          f"phase 16: c4 hit fraction {hit4}")
    times["c4"] = wall_ms(lambda: gt.gjkepa_batch(m1, m2, cfg=cfg), 3)
    oracle = load_oracle()
    s1, s2 = (t[:oracle_pairs].double() for t in (m1, m2))
    r64 = gt.gjkepa_batch(s1, s2)
    finite(r64, "c4 float64 sample")
    a1, a2 = s1.cpu().numpy(), s2.cpu().numpy()
    hit64, depth64 = r64.hit.cpu().numpy(), r64.depth.cpu().numpy()
    mismatch, err, compared = 0, 0.0, 0
    for i in range(oracle_pairs):
        try:
            o = oracle.gjkepa_oracle(a1[i], a2[i])
        except oracle.OracleHalt:
            continue
        mismatch += int(bool(hit64[i]) != o.hit)
        if o.hit and not o.epa_capped:
            err = max(err, abs(float(depth64[i]) - o.depth))
            compared += 1
    check(mismatch == 0 and err < 1e-6 and compared > oracle_pairs // 2,
          f"phase 16: float64 sample vs oracle: {mismatch} hit mismatches, "
          f"depth error {err} over {compared} hits")

    # c3 shapes and c3b hulls against shapes, at full width
    a3, b3 = (gt.ShapeBatch.from_numpy(*side, device=dev)
              for side in fixtures.c3_pairs(0, n3))
    r3 = gt.collide_shapes_batch(a3, b3, cfg=cfg)
    finite(r3, "c3")
    f3 = gt.fused_gjkepa_shapes(a3, b3, cfg=cfg)
    agree3 = float((r3.hit == f3.hit).float().mean())
    check(isum(r3.hit) > 0 and agree3 >= 0.99,
          f"phase 16: c3 {isum(r3.hit)} hits, {agree3} agree with fused")
    times["c3"] = wall_ms(lambda: gt.collide_shapes_batch(a3, b3, cfg=cfg), 3)
    hulls, shp = fixtures.c3b_pairs()
    hulls, shp = hulls[:n3b], tuple(x[:n3b] for x in shp)
    h3 = torch.from_numpy(hulls).to(dev)
    s3 = gt.ShapeBatch.from_numpy(*shp, device=dev)
    rb = gt.collide_hull_shape_batch(h3, s3, cfg=cfg)
    finite(rb, "c3b")
    fb = gt.fused_gjkepa_hull_shapes(h3, s3, cfg=cfg)
    agreeb = float((rb.hit == fb.hit).float().mean())
    check(isum(rb.hit) > 0 and agreeb >= 0.99,
          f"phase 16: c3b {isum(rb.hit)} hits, {agreeb} agree with fused")
    times["c3b"] = wall_ms(
        lambda: gt.collide_hull_shape_batch(h3, s3, cfg=cfg), 3)
    sizes = {"c1": 1, "c4": n4, "c3": n3, "c3b": h3.shape[0]}
    for key, ms in times.items():
        log(f"phase 16 time {key}: {ms:.4f} ms = "
            f"{sizes[key] / ms * 1e3:,.0f} q/s [{card}]")
    log(f"phase 16 portable path: c1 depth {float(r.depth):.6f} in "
        f"{times['c1'] * 1e3:.1f} us; gjkepa_batch c4 {n4} x 24 float32 hit "
        f"fraction {hit4:.4f}, mean gjk/epa iterations "
        f"{float(r4.gjk_iters.float().mean()):.3f}/"
        f"{float(r4.epa_iters.float().mean()):.3f}; float64 sample of "
        f"{oracle_pairs} vs the oracle: 0 hit mismatches, depth error "
        f"{err:.3g} over {compared} hits; collide_shapes_batch c3 "
        f"{isum(r3.hit)} hits ({agree3:.5f} agree with the fused path), "
        f"collide_hull_shape_batch c3b {isum(rb.hit)} hits ({agreeb:.5f}) "
        f"[{card}]")


# -- manifolds and the sim --------------------------------------------------------

def manifolds_agree(got, want, tol=1e-5):
    """A manifold run against another of the same rows: returns (the share
    of lanes whose masks agree, the share of those equal row by row within
    tol); on every mask-agreeing lane the kept points must agree as sets
    and the kept depths (sorted) within tol, since the 4-point reduction
    takes first maxima over ties, which a last-bit difference moves."""
    gm, wm = got.mask.cpu(), want.mask.cpu()
    same = (gm == wm).all(1)
    gp, wp = got.points.cpu(), want.points.cpu()
    gd, wd = got.depths.cpu(), want.depths.cpu()
    rows = (((gp - wp).abs().amax(2) <= tol) & ((gd - wd).abs() <= tol)
            | ~wm).all(1) & same
    for i in torch.nonzero(same & ~rows)[:, 0].tolist():
        d = torch.cdist(gp[i][wm[i]].double(), wp[i][wm[i]].double())
        check(max(float(d.amin(0).max()), float(d.amin(1).max())) <= tol
              and torch.allclose(gd[i][wm[i]].sort().values,
                                 wd[i][wm[i]].sort().values, rtol=0,
                                 atol=tol),
              f"manifold lane {i}: points or depths differ beyond {tol}")
    return float(same.float().mean()), float(rows.sum() / same.sum())


def manifold_phase(gt, dev, cfg, card, n_sample=1024) -> None:
    """Phase 17: the manifolds (torch code over the hull kernels' query)
    on the card through their entry points."""
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk

    # c4's pairs in the bench's draw order (bench.py:299-317)
    p1, p2 = (torch.from_numpy(a).to(dev) for a in fixtures.c4_pairs())
    n4 = p1.shape[0]

    def c4_manifolds():
        r = gt.gjkepa_batch_fused(p1, p2, cfg=cfg)
        return r, gt.manifold_batch(p1, p2, r.normal, r.depth, r.hit,
                                    r.contact_point, cfg=cfg)

    torch.cuda.synchronize()
    fused_gjk.LAUNCHES = 0
    fused_epa.LAUNCHES = 0
    r, m = c4_manifolds()
    torch.cuda.synchronize()
    launches = {"gjk_hulls": fused_gjk.LAUNCHES,
                "epa_hulls": fused_epa.LAUNCHES}
    check(launches == {"gjk_hulls": 1, "epa_hulls": 1},
          f"phase 17: c4 manifolds launched {launches}")
    for name, t in m._asdict().items():
        check(t.device == dev, f"phase 17: {name} on {t.device}")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()),
                  f"phase 17: {name} not finite")
    check(bool((m.depths[m.mask] >= 0).all())
          and not bool(m.mask[~r.hit].any())
          and bool(m.mask[:, 0][r.hit].all()),
          "phase 17: c4 manifolds: a negative depth, a point on a miss or "
          "a hit without one")
    hits = isum(r.hit)
    per_hit = isum(m.mask) / max(hits, 1)
    # the port's own CPU run on a sample of the same query rows
    rows = [t[:n_sample] for t in (p1, p2, r.normal, r.depth, r.hit,
                                   r.contact_point)]
    want = gt.manifold_batch(*(t.cpu() for t in rows), cfg=cfg)
    got = type(m)(*(t[:n_sample] for t in m))
    check(torch.equal(got.overflow.cpu(), want.overflow),
          "phase 17: overflow differs from the CPU run")
    masks, row_share = manifolds_agree(got, want)
    check(masks >= 0.999 and row_share >= 0.99,
          f"phase 17: against the CPU run, masks agree on {masks} of the "
          f"lanes, rows on {row_share} of those")
    times = {
        "c4_manifold": cuda_ms(c4_manifolds),
        "c4_query": cuda_ms(lambda: gt.gjkepa_batch_fused(p1, p2, cfg=cfg)),
        "manifold_batch_c4": cuda_ms(lambda: gt.manifold_batch(
            p1, p2, r.normal, r.depth, r.hit, r.contact_point, cfg=cfg)),
    }

    # the fixtures of tests/test_manifold.py
    a = gt.boxes([[0.5, 0.5, 0.5]], device=dev)
    b = gt.boxes([[0.4, 0.4, 0.5]], pos=[[0.0, 0.0, 0.9]], device=dev)
    q = gt.collide_shapes_batch_fused(a, b, cfg=cfg)
    ms = gt.manifold_shapes_batch(a, b, q.normal, q.depth, q.hit,
                                  q.contact_point, cfg=cfg)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32)
    h1 = torch.from_numpy(corners * 0.5)[None].to(dev)
    h2 = torch.from_numpy(corners * np.float32([0.4, 0.4, 0.5])
                          + np.float32([0, 0, 0.9]))[None].to(dev)
    qh = gt.gjkepa_batch_fused(h1, h2, cfg=cfg)
    mh = gt.manifold_batch(h1, h2, qh.normal, qh.depth, qh.hit,
                           qh.contact_point, cfg=cfg)
    for what, mm in (("manifold_shapes_batch", ms), ("manifold_batch", mh)):
        xy = mm.points[0, :, :2].cpu()
        check(bool(mm.mask.all())
              and float((mm.depths - 0.1).abs().max()) <= 1e-5
              and float((xy.abs() - 0.4).abs().max()) <= 1e-4
              and float((xy.sum(0)).abs().max()) <= 1e-4,
              f"phase 17: stacked boxes through {what}: {mm}")
    sa = gt.spheres([0.6], pos=[[0.0, 0.0, 0.0]], device=dev)
    sb = gt.spheres([0.6], pos=[[0.8, 0.0, 0.0]], device=dev)
    qs = gt.collide_shapes_batch_fused(sa, sb, cfg=cfg)
    mp = gt.manifold_shapes_batch(sa, sb, qs.normal, qs.depth, qs.hit,
                                  qs.contact_point, cfg=cfg)
    check(mp.mask[0].tolist() == [True, False, False, False]
          and torch.equal(mp.points[0, 0], qs.contact_point[0])
          and torch.equal(mp.depths[0, 0], qs.depth[0]),
          f"phase 17: the sphere pair's single point: {mp}")

    # hulls against shapes at c3b, the fallback point A's support centroid
    hulls, shp = fixtures.c3b_pairs()
    h3 = torch.from_numpy(hulls).to(dev)
    s3 = gt.ShapeBatch.from_numpy(*shp, device=dev)
    f3 = gt.fused_gjkepa_hull_shapes(h3, s3, cfg=cfg)
    mb = gt.manifold_hull_shape_batch(h3, s3, f3.normal, f3.depth, f3.hit,
                                      cfg=cfg)
    check(all(bool(torch.isfinite(t).all()) for t in (mb.points, mb.depths))
          and bool((mb.depths[mb.mask] >= 0).all())
          and not bool(mb.mask[~f3.hit].any())
          and bool(mb.mask[:, 0][f3.hit].all()),
          "phase 17: c3b manifolds not finite, negative, or off the hits")
    times["manifold_hull_shape_batch_c3b"] = cuda_ms(
        lambda: gt.manifold_hull_shape_batch(h3, s3, f3.normal, f3.depth,
                                             f3.hit, cfg=cfg))
    sizes = {"c4_manifold": n4, "c4_query": n4, "manifold_batch_c4": n4,
             "manifold_hull_shape_batch_c3b": h3.shape[0]}
    for key, ms_ in times.items():
        log(f"phase 17 time {key}: {ms_:.4f} ms = "
            f"{sizes[key] / ms_ * 1e3:,.0f} q/s [{card}]")
    log(f"phase 17 manifolds: c4 {n4} x 24 (fixtures.c4_pairs, the bench's "
        f"draws) gjkepa_batch_fused + manifold_batch: {hits} hits, "
        f"{per_hit:.3f} contact points a hit, {isum(m.overflow)} overflow; "
        f"launches {launches}; c4 manifold {n4 / times['c4_manifold'] * 1e3:,.0f}"
        f" q/s; against the CPU on {n_sample} lanes: masks agree on "
        f"{masks:.4f}, rows on {row_share:.4f} of those, the rest as point "
        f"sets within 1e-5; stacked boxes 4 corners at depth 0.1 (shapes and "
        f"hulls), spheres the single point; c3b hull-vs-shape "
        f"{isum(f3.hit)} hits, {isum(mb.mask)} points, finite, depths >= 0 "
        f"[{card}]")


def sim_phase(gt, dev, cfg, card) -> None:
    """Phase 18: the rigid-body sim on the card, its narrowphase K1 and K2
    over box corners."""
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops.broadphase import swept_candidate_pairs
    from gjkepa_tpu_torch.ops.geom import norm3
    from gjkepa_tpu_torch.sim import SimConfig, SimState, rigid
    from gjkepa_tpu_torch.sim import init_boxes, sim_step

    def run(state, scfg, steps):
        diags = []
        for _ in range(steps):
            state, diag = sim_step(state, scfg, cfg)
            diags.append(diag)
        return state, diags

    def finite(state, what):
        for name, t in state._asdict().items():
            check(t.device == dev and bool(torch.isfinite(t).all()),
                  f"phase 18: {what} {name} not finite or off the card")

    def close(got, want, what):
        """tests/test_torch_sim.py's tolerance; returns the max errors."""
        errs = {}
        for f, rtol, atol in (("pos", 0, 1e-6), ("quat", 0, 1e-6),
                              ("vel", 1e-5, 1e-5), ("angvel", 1e-5, 1e-5)):
            g, w = getattr(got, f).cpu(), getattr(want, f)
            check(torch.allclose(g, w, rtol=rtol, atol=atol),
                  f"phase 18: {what}: {f} differs by "
                  f"{float((g - w).abs().max())}")
            errs[f] = float((g - w).abs().max())
        return errs

    # the bench's two scenes (bench.py:340-368)
    scenes = {
        "c5_1024": (init_boxes(1024, height=6.0, spread=14.0, device=dev),
                    SimConfig(max_pairs=8192), 10),
        "c5_16k": (init_boxes(16384, height=8.0, spread=55.0, device=dev),
                   SimConfig(max_pairs=65536), 3),
    }
    times, notes = {}, []
    for name, (state, scfg, steps) in scenes.items():
        torch.cuda.synchronize()
        fused_gjk.LAUNCHES = 0
        fused_epa.LAUNCHES = 0
        end, diags = run(state, scfg, steps)
        torch.cuda.synchronize()
        k1, k2 = fused_gjk.LAUNCHES, fused_epa.LAUNCHES
        check(k1 == steps and k2 == steps,
              f"phase 18: {name}: K1 launched {k1}, K2 {k2} times in "
              f"{steps} steps")
        finite(end, name)
        times[name] = cuda_ms(lambda: run(state, scfg, steps)) / steps
        d0 = {k: v.item() for k, v in diags[0].items()}
        dl = {k: v.item() for k, v in diags[-1].items()}
        notes.append(f"{name} ({state.pos.shape[0]} boxes, max_pairs "
                     f"{scfg.max_pairs}): {1e3 / times[name]:.2f} steps/s, "
                     f"{times[name]:.3f} ms a step, K1/K2 {k1}/{k2} in "
                     f"{steps} steps; diag step 1 {d0}, step {steps} {dl}")

    # one step's candidates of the 1,024 scene: the kernels on the card
    # against their plain versions on the CPU, bit for bit
    state, scfg, _ = scenes["c5_1024"]
    cpu = SimState(*(t.cpu() for t in state))
    rot, rot_c = rigid.quat_to_mat(state.quat), rigid.quat_to_mat(cpu.quat)
    pairs, valid, _, _ = swept_candidate_pairs(
        state.pos, norm3(state.half), scfg.max_pairs, scfg.bp_window)
    pairs_c, valid_c, _, _ = swept_candidate_pairs(
        cpu.pos, norm3(cpu.half), scfg.max_pairs, scfg.bp_window)
    check(torch.equal(pairs.cpu(), pairs_c) and torch.equal(valid.cpu(),
                                                            valid_c),
          "phase 18: the card's candidate pairs differ from the CPU's")
    ins = []
    for s, r, p, v in ((state, rot, pairs, valid), (cpu, rot_c, pairs_c,
                                                    valid_c)):
        c1 = rigid._corners(s, r, p[:, 0].long())
        c2 = rigid._corners(s, r, p[:, 1].long()) + torch.where(
            v, 0.0, 4e4)[:, None, None]
        ins.append((c1, c2))
    check(all(torch.equal(x.cpu(), y) for x, y in zip(*ins)),
          "phase 18: the card's box corners differ from the CPU's")
    fk = gt.fused_gjkepa_hulls(*ins[0], cfg=cfg)
    fp = gt.fused_gjkepa_hulls(*ins[1], cfg=cfg)
    for f in ("hit", "status", "depth", "normal"):
        check(torch.equal(getattr(fk, f).cpu(), getattr(fp, f)),
              f"phase 18: the narrowphase's {f} differs from K1/K2's plain "
              "versions")
    # the whole step against the same branch on the CPU and the CPU's own
    got, gd = sim_step(state, scfg, cfg)
    want, wd = rigid._step(cpu, scfg, cfg, rigid._pair_contacts_fused)
    portable, pd = sim_step(cpu, scfg, cfg)
    for d in (wd, pd):
        check(all(torch.equal(gd[k].cpu(), v) for k, v in d.items()),
              f"phase 18: diag {gd} against the CPU's {d}")
    err_fused = close(got, want, "a step against the CPU's K1/K2 branch")
    err_port = close(got, portable, "a step against the CPU's portable step")

    # the 3-box stack of tests/test_sim.py:67-87, where K2 sees real hits,
    # and the same stack moved 8, 16 and 24 along x in the same run (too
    # far apart to meet): a stack's walk-off is chaotic, and the moves
    # change only the rounding
    shifts = (0.0, 8.0, 16.0, 24.0)
    z0 = torch.tensor([0.55, 1.6, 2.65])
    pos0 = torch.stack([torch.stack([torch.full((3,), x), torch.zeros(3), z0],
                                    1) for x in shifts]).reshape(-1, 3)
    n = pos0.shape[0]
    stack = SimState(pos0.to(dev),
                     torch.tensor([[1.0, 0, 0, 0]] * n, device=dev),
                     torch.zeros((n, 3), device=dev),
                     torch.zeros((n, 3), device=dev),
                     torch.full((n, 3), 0.5, device=dev))
    torch.cuda.synchronize()
    fused_gjk.LAUNCHES = 0
    fused_epa.LAUNCHES = 0
    t0 = time.perf_counter()
    end, diags = run(stack, SimConfig(max_pairs=16 * len(shifts)), 300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_gjk.LAUNCHES, fused_epa.LAUNCHES
    contacts = torch.stack([d["n_contacts"] for d in diags]).cpu()
    finite(end, "the 3-box stacks")
    pos = (end.pos.cpu() - pos0 * torch.tensor([1.0, 0, 0])).reshape(
        len(shifts), 3, 3)
    check(k1 == 300 and k2 == 300 and int((contacts > 0).sum()) > 100,
          f"phase 18: the stacks: K1 {k1}, K2 {k2} launches, "
          f"{int((contacts > 0).sum())} steps with box contacts")
    # test_sim.py's bounds on the heights: each stack stands, in order
    check(bool(((pos[:, :, 2] - torch.tensor([0.5, 1.5, 2.5])).abs()
                < torch.tensor([0.15, 0.25, 0.35])).all()),
          f"phase 18: a 3-box stack left test_sim.py's height bounds: {pos}")
    walk = [round(float(p[:, :2].abs().max()), 4) for p in pos]
    for note in notes:
        log(f"phase 18 sim {note} [{card}]")
    log(f"phase 18 sim: one step of c5_1024's candidates ({pairs.shape[0]} "
        f"pairs, {isum(valid)} valid, {isum(fk.hit & valid)} hits): K1/K2 on "
        f"the card = their plain versions on the CPU bit for bit (hit, "
        f"status, depth, normal); the step against the CPU's K1/K2 branch "
        f"{err_fused}, against the CPU's portable step {err_port}; the 3-box "
        f"stack and its copies moved {shifts[1:]} along x, 300 steps on the "
        f"card: {wall * 1e3 / 300:.3f} ms a step, K1/K2 {k1}/{k2}, box "
        f"contacts in {int((contacts > 0).sum())} steps, final z "
        f"{[[round(float(z), 4) for z in p[:, 2]] for p in pos]} (within "
        f"test_sim.py's height bounds), walk-off max |x|, |y| {walk} "
        f"(test_sim.py bounds it by 0.3) [{card}]")


# -- sharding, the sanitizer, the entry points, the portable distance -----------

def host_reads(fn):
    """``fn()``'s result and the host reads it made: the synchronizing CUDA
    operations that torch's sync debug mode warns on, one warning each
    (torch calls the mode a prototype that does not see every such
    operation)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in seen)


def _counter_dicts() -> tuple:
    from gjkepa_tpu_torch.ops import fused_distance as fd
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops import fused_streamed as fst
    return fs.LAUNCHES, fd.LAUNCHES, fh.LAUNCHES, fst.LAUNCHES


def zero_launches():
    """Set every kernel's launch counter to 0 (after a synchronise)."""
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
    torch.cuda.synchronize()
    fused_gjk.LAUNCHES = 0
    fused_epa.LAUNCHES = 0
    for counts in _counter_dicts():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    """Every kernel's launch counter (after a synchronise)."""
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
    torch.cuda.synchronize()
    out = {"gjk_hulls": fused_gjk.LAUNCHES, "epa_hulls": fused_epa.LAUNCHES}
    for counts in _counter_dicts():
        out.update(counts)
    return out


def launched(**want) -> dict:
    """The counters of ``want``'s kernels and of no other, zeros dropped."""
    return {k: v for k, v in read_launches().items() if v or k in want}


def fields_equal(x, y) -> bool:
    return all(torch.equal(a, b) for a, b in zip(x, y))


def sharding_phase(gt, dev, cfg, card) -> None:
    """Phase 19: the fused hull query with the pair axis sharded over the
    cards (``pair_mesh()``) and over 4 entries of this card, at c4."""
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.parallel import (contact_count_sharded,
                                           gjkepa_batch_fused_sharded,
                                           pair_mesh, shard_pairs)
    p1, p2 = (torch.from_numpy(a).to(dev) for a in fixtures.c4_pairs())
    n4 = p1.shape[0]
    want = gt.gjkepa_batch_fused(p1, p2, cfg=cfg)
    times = {"unsharded": cuda_ms(
        lambda: gt.gjkepa_batch_fused(p1, p2, cfg=cfg))}
    notes = []
    for name, mesh in (("cards", pair_mesh()),
                       ("cuda:0 x 4", pair_mesh(4, device=dev))):
        s1, s2 = shard_pairs(mesh, p1, p2)
        zero_launches()
        r, reads = host_reads(
            lambda: gjkepa_batch_fused_sharded(mesh, s1, s2, cfg=cfg))
        launches = launched(gjk_hulls=1, epa_hulls=1)
        check(launches == {"gjk_hulls": mesh.size, "epa_hulls": mesh.size},
              f"phase 19: {name}: launched {launches} over {mesh.size} "
              "shards, expected one K1 and one K2 a shard")
        # every shard's K1 and K2 issued before any host read: none at all
        check(reads == 0, f"phase 19: {name}: {reads} host reads")
        check([s.depth.device for s in r.shards] == mesh.devices,
              f"phase 19: {name}: shards off their devices")
        check(fields_equal(r.gather(), want),
              f"phase 19: {name}: the gathered result differs from the "
              "unsharded query")
        if all(d == dev for d in mesh.devices):
            times[name] = cuda_ms(
                lambda: gjkepa_batch_fused_sharded(mesh, s1, s2, cfg=cfg))
        notes.append(f"{name} ({mesh.size} shards of {n4 // mesh.size}): "
                     f"bit for bit, launches {launches}, {reads} host reads")
    # the contact count over the 4-entry mesh against the unsharded
    # portable query
    mesh = pair_mesh(4, device=dev)
    cnt = contact_count_sharded(mesh, *shard_pairs(mesh, p1, p2), cfg=cfg)
    ref = isum(gt.gjkepa_batch(p1, p2, cfg=cfg).hit)
    check(cnt.device == dev and cnt.dtype == torch.int32 and int(cnt) == ref,
          f"phase 19: contact count {int(cnt)}, unsharded portable {ref}")
    for key, ms in times.items():
        log(f"phase 19 time {key}: {ms:.4f} ms = {n4 / ms * 1e3:,.0f} q/s "
            f"[{card}]")
    log(f"phase 19 sharding: gjkepa_batch_fused_sharded at c4 "
        f"({n4} x 24, fixtures.c4_pairs): " + "; ".join(notes)
        + f"; contact_count_sharded over 4 shards {int(cnt)} = the "
        f"unsharded portable hit sum [{card}]")


def sanitizer_phase(gt, dev, cfg, card) -> None:
    """Phase 20: the five checkers on the card at full width: clean inputs
    bit for bit against the unchecked call with one host read more, a
    poison at known lanes named as the CPU names it."""
    from gjkepa_tpu_torch import debug
    from gjkepa_tpu_torch.models import fixtures

    c4 = [torch.from_numpy(a) for a in fixtures.c4_pairs()]
    c3 = [gt.ShapeBatch.from_numpy(*s, device="cpu")
          for s in fixtures.c3_pairs()]
    q4 = gt.gjkepa_batch_fused(*(t.to(dev) for t in c4), cfg=cfg)
    q3 = gt.collide_shapes_batch_fused(
        *(gt.ShapeBatch(*(t.to(dev) for t in s)) for s in c3), cfg=cfg)
    rows4 = [t.cpu() for t in (q4.normal, q4.depth, q4.hit,
                               q4.contact_point)]
    rows3 = [t.cpu() for t in (q3.normal, q3.depth, q3.hit,
                               q3.contact_point)]
    s64 = [t[:1024].double() for t in c4]

    def poison(t, lanes, value=float("nan")):
        """A copy of ``t`` with one entry of each lane set to ``value``."""
        t = t.clone()
        t.view(t.shape[0], -1)[lanes, -1] = value
        return t

    def shapes(s, params=None, rot=None):
        return gt.ShapeBatch(s.kind, s.params if params is None else params,
                             s.pos, s.rot if rot is None else rot)

    hull_k = {"gjk_hulls": 1, "epa_hulls": 1}
    shape_k = {"cf_shapes": 1, "gjk_sub_shapes": 1, "epa_shapes": 1}
    lanes = [5, 1000, 4097, 16000]
    # (name, checked, unchecked, clean args, poisoned args, the kernels a
    # call launches); args on the CPU, moved to the card for its run
    cases = [
        ("checked_fused_gjkepa_hulls c4", debug.checked_fused_gjkepa_hulls,
         gt.fused_gjkepa_hulls, c4,
         [poison(c4[0], lanes[:2]), poison(c4[1], lanes[2:], float("inf"))],
         hull_k),
        ("checked_fused_gjkepa_shapes c3", debug.checked_fused_gjkepa_shapes,
         gt.fused_gjkepa_shapes, c3,
         [shapes(c3[0], params=poison(c3[0].params, [2, 30000],
                                      float("inf"))),
          shapes(c3[1], rot=poison(c3[1].rot, [60000]))], shape_k),
        ("checked_manifold_batch c4", debug.checked_manifold_batch,
         gt.manifold_batch, c4 + rows4,
         c4 + [poison(rows4[0], lanes)] + rows4[1:], {}),
        ("checked_manifold_shapes_batch c3",
         debug.checked_manifold_shapes_batch, gt.manifold_shapes_batch,
         c3 + rows3, c3 + [poison(rows3[0], [7, 40000])] + rows3[1:], {}),
        ("checked_gjkepa_batch c4 float64 sample",
         debug.checked_gjkepa_batch, gt.gjkepa_batch, s64,
         [poison(s64[0], [17]), poison(s64[1], [700], float("inf"))], {}),
        ("checked_gjkepa_batch c4 float32 sample (NaN precedence)",
         lambda *a: debug.checked_gjkepa_batch(*a, cfg=cfg), None,
         [t.float() for t in s64], [poison(s64[0].float(), [17]),
                                    s64[1].float()], {}),
    ]

    def on(device, args):
        return [gt.ShapeBatch(*(x.to(device) for x in a))
                if isinstance(a, gt.ShapeBatch) else a.to(device)
                for a in args]

    def message(fn, args):
        try:
            fn(*args)
        except debug.DebugCheckError as e:
            return str(e)
        raise AssertionError("phase 20: a poisoned call did not raise")

    for name, checked, unchecked, clean, bad, kernels in cases:
        args = on(dev, clean)
        if unchecked is not None:
            want, reads_u = host_reads(lambda: unchecked(*args))
            zero_launches()
            got, reads_c = host_reads(lambda: checked(*args))
            counts = launched(**kernels)
            check(counts == kernels,
                  f"phase 20: {name} launched {counts}, expected {kernels}")
            check(fields_equal(got, want),
                  f"phase 20: {name}: the checked result differs from the "
                  "unchecked call's")
            check(reads_c == reads_u + 1, f"phase 20: {name}: {reads_c} "
                  f"host reads, the unchecked call {reads_u}")
            t_c = cuda_ms(lambda: checked(*args), calls=3, warmup=1)
            t_u = cuda_ms(lambda: unchecked(*args), calls=3, warmup=1)
            log(f"phase 20 time {name}: checked {t_c:.4f} ms, unchecked "
                f"{t_u:.4f} ms; host reads a call {reads_c} against "
                f"{reads_u} (one more), launches {counts} [{card}]")
        on_card = message(checked, on(dev, bad))
        on_cpu = message(checked, bad)
        check(on_card == on_cpu, f"phase 20: {name}: the card says "
              f"{on_card!r}, the CPU {on_cpu!r}")
        log(f"phase 20 sanitizer {name}: poisoned -> {on_card} (the CPU "
            f"run's) [{card}]")


def entry_phase(gt, dev, card) -> None:
    """Phase 21: the entry points: ``entry()``'s flagship call once
    on the card, and ``dryrun_multichip`` over the cards and over 4
    entries of this card."""
    from gjkepa_tpu_torch import entry as port_entry
    fn, args = port_entry.entry(device=dev)
    check(all(a.device == dev for a in args), "phase 21: entry() inputs "
          "off the card")
    t0 = time.perf_counter()
    r = fn(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    want = fn(*(a.cpu() for a in args))
    check(all(torch.equal(getattr(r, f).cpu(), getattr(want, f))
              for f in ("hit", "status", "colli_type"))
          and float((r.depth.cpu() - want.depth).abs().max()) <= 1e-5,
          "phase 21: entry()'s fn on the card differs from its CPU run")
    notes = []
    for n, device in ((torch.cuda.device_count(), None), (4, dev)):
        zero_launches()
        t0 = time.perf_counter()
        port_entry.dryrun_multichip(n, device=device)
        ms = (time.perf_counter() - t0) * 1e3
        counts = launched(gjk_hulls=1, epa_hulls=1)
        check(counts == {"gjk_hulls": n, "epa_hulls": n},
              f"phase 21: dryrun_multichip({n}) launched {counts}")
        notes.append(f"dryrun_multichip({n}, device={device}) passed in "
                     f"{ms:.1f} ms, launches {counts}")
    log(f"phase 21 entry: entry()'s fn (gjkepa_batch, 256 x 16 float32) "
        f"once on the card in {wall:.1f} ms, {isum(r.hit)} hits, = its CPU "
        f"run; " + "; ".join(notes) + f" [{card}]")


def portable_distance_phase(gt, dev, cfg, card, n_sample=1024) -> None:
    """Phase 22: the portable distance (torch code, ``ops.distance``) at
    full width: ``gjk_distance_batch`` at c2, ``gjk_distance_shapes_batch``
    at c3; against their CPU runs on a sample and against K8."""
    from gjkepa_tpu_torch.models import fixtures
    d1, d2 = (torch.from_numpy(a) for a in fixtures.c2_hulls())
    a3, b3 = (gt.ShapeBatch.from_numpy(*s, device="cpu")
              for s in fixtures.c3_pairs())
    calls = {
        "gjk_distance_batch c2": (
            gt.gjk_distance_batch, [d1.to(dev), d2.to(dev)],
            [d1[:n_sample], d2[:n_sample]]),
        "gjk_distance_shapes_batch c3": (
            gt.gjk_distance_shapes_batch,
            [gt.ShapeBatch(*(t.to(dev) for t in s)) for s in (a3, b3)],
            [gt.ShapeBatch(*(t[:n_sample] for t in s)) for s in (a3, b3)]),
    }
    for name, (fn, args, cpu_args) in calls.items():
        r, reads = host_reads(lambda: fn(*args, cfg=cfg))
        for f, t in r._asdict().items():
            check(t.device == dev and (not t.is_floating_point()
                                       or bool(torch.isfinite(t).all())),
                  f"phase 22: {name} {f} not finite or off the card")
        w = fn(*cpu_args, cfg=cfg)
        err = float((r.distance[:n_sample].cpu() - w.distance).abs().max())
        same = torch.equal(r.intersecting[:n_sample].cpu(), w.intersecting)
        check(same and err <= 1e-5, f"phase 22: {name} against its CPU run "
              f"on {n_sample} lanes: intersecting equal {same}, distance "
              f"error {err}")
        ms = cuda_ms(lambda: fn(*args, cfg=cfg), calls=3, warmup=1)
        n = r.distance.shape[0]
        log(f"phase 22 time {name}: {ms:.4f} ms = {n / ms * 1e3:,.0f} q/s, "
            f"{reads} host reads a call, max {int(r.iters.max())} "
            f"iterations, {isum(r.intersecting)} intersecting; the CPU run "
            f"on {n_sample} lanes: intersecting equal, distance error "
            f"{err:.3g} [{card}]")
        if name.startswith("gjk_distance_batch"):
            k8 = gt.fused_gjk_distance_hulls(*args, cfg=cfg)
            k8_err = float((r.distance - k8.distance).abs().max())
            k8_same = isum(r.intersecting != k8.intersecting)
            check(k8_same == 0 and k8_err <= 1e-5, f"phase 22: {name} "
                  f"against K8: intersecting differs on {k8_same} lanes, "
                  f"distance by {k8_err}")
            log(f"phase 22 {name} against K8 (fused_gjk_distance_hulls) on "
                f"all {n} lanes: intersecting equal, distance error "
                f"{k8_err:.3g} [{card}]")


def parity_phase(gt, dev, cfg, card) -> list[dict]:
    """Phase 23: the calls the JAX package answers that the port once
    refused.  K1 and the large-hull path without the broadphase, K13 past
    shared memory, ``fused_gjkepa_hulls(use_broadphase=False)`` at c2
    against its CPU run, the chunked portable distance at c2; returns the
    ``kernels`` entry of K1 without the broadphase at c2."""
    from gjkepa_tpu_torch import _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops import fused_streamed as fst
    from gjkepa_tpu_torch.ops.fused import (cascade_plan, hit_first_order,
                                            hulls_result)

    def on_dev(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    def k1_off(p1, p2, what, team=None):
        """K1 without the broadphase, one launch, its rows bit for bit
        against the plain version's (every lane runs GJK)."""
        zero_launches()
        gk = (fused_gjk.gjk_hulls(p1, p2, cfg, use_broadphase=False)
              if team is None else fused_gjk._gjk_hulls_cuda(
                  p1, p2, cfg, team, use_broadphase=False))
        n = read_launches()["gjk_hulls"]
        gp = fused_gjk.gjk_hulls_plain(p1, p2, cfg, use_broadphase=False)
        torch.cuda.synchronize()
        check(n == 1, f"phase 23: {what}: K1 launched {n} times")
        check(bool((gp.status != 0).all()), f"phase 23: {what}: a lane "
              "missed on a broadphase that is off")
        d = isum(gk.iters != gp.iters)
        check(rows_equal(gk, gp), f"phase 23: {what}: K1 without the "
              f"broadphase differs from plain (status equal "
              f"{torch.equal(gk.status, gp.status)}, gjk_iters on {d} "
              "lanes)")
        return gk

    # -- K1 without the broadphase: c2, c4, 4096 x 63, each team at c2 --------
    c1, c2 = on_dev(*fixtures.c2_hulls())
    m1, m2 = on_dev(*fixtures.deep_pairs(np.random.default_rng(0), 16384,
                                         24))
    o1, o2 = on_dev(*(fixtures.random_hulls(np.random.default_rng(23), 4096,
                                            63) for _ in range(2)))
    g_on = fused_gjk.gjk_hulls(c1, c2, cfg)
    g_off = k1_off(c1, c2, "c2")
    for team in fused_gjk.TEAMS:
        k1_off(c1, c2, f"c2 at a team of {team}", team)
    for what, p1, p2 in (("c4", m1, m2), ("c2's generator at 63", o1, o2)):
        k1_off(p1, p2, what)
    log(f"phase 23 K1 without the broadphase vs plain, rows bit for bit, "
        f"one launch a call: c2 {tuple(c1.shape[:2])} (every team "
        f"{fused_gjk.TEAMS}; "
        f"{isum(g_on.status == 0)} broadphase misses with it on, "
        f"{isum(g_off.status == gt.Status.MISS_GJK)} MISS_GJK and "
        f"{isum(g_off.hit)} hits with it off, mean gjk_iters "
        f"{float(g_off.iters.float().mean()):.3f} against "
        f"{float(g_on.iters.float().mean()):.3f}), c4 {tuple(m1.shape[:2])}, "
        f"{tuple(o1.shape[:2])} (K11's scalar scan)")

    # -- the large-hull path without the broadphase at big2600 ----------------
    h1, h2 = on_dev(*fixtures.big_c2_pairs())
    ones = torch.ones(h1.shape[0], dtype=torch.bool, device=dev)
    stages = cascade_plan(cfg)
    gk = fst.gjk_hulls_big(h1, h2, ones, cfg)
    gp = fst.gjk_hulls_big_plain(h1, h2, ones, cfg)
    check(rows_equal(gk, gp), "phase 23: K12 over every big2600 lane "
          "differs from plain")
    order, n_act = hit_first_order(gp.hit)
    args = (h1, h2, gp.simplex, gp.status, order, n_act, stages)
    check(rows_equal(fst.epa_hulls_big(*args), fst.epa_hulls_big_plain(*args)),
          "phase 23: K13 after K12 without the broadphase differs from plain")
    per_call = {}
    zero_launches()
    big = gt.fused_gjkepa_hulls(h1, h2, cfg=cfg, use_broadphase=False)
    per_call["big2600"] = launched()
    check(per_call["big2600"] == {"gjk_hulls_big": 1, "epa_hulls_big": 1},
          f"phase 23: big2600 without the broadphase launched "
          f"{per_call['big2600']}")
    plain_big = hulls_result(gp, stages, lambda *a: fst.epa_hulls_big_plain(
        h1, h2, gp.simplex, gp.status, *a))
    check(fields_equal(big, plain_big), "phase 23: big2600 without the "
          "broadphase differs from the plain path")
    on_big = gt.fused_gjkepa_hulls(h1, h2, cfg=cfg)
    log(f"phase 23 large-hull path without the broadphase at big2600 "
        f"{tuple(h1.shape[:2])}: K12 over all lanes, K13 over {int(n_act)} "
        f"hits, every "
        f"field bit for bit against the plain path; "
        f"{isum(on_big.status == 0)} broadphase misses with it on become "
        f"{isum((on_big.status == 0) & (big.status == gt.Status.MISS_GJK))}"
        f" MISS_GJK; launches {per_call['big2600']}")

    # -- K13 past shared memory, and no host read at the default ladder -------
    b1, b2 = on_dev(*fixtures.big_pairs_8192())
    lib, limit = _build.load(), _build.smem_limit(dev)
    wide = cfg.replace(epa_max_faces=4096, epa_max_verts=2050)
    ladder = cascade_plan(wide)
    near = fused_epa.near_store_faces(ladder, lib.epa_hulls_big_smem_bytes,
                                      limit)
    far = fused_epa.far_store_faces(ladder, near)
    check(lib.epa_hulls_big_smem_bytes(far) > limit and far == 4096,
          f"phase 23: the 4096-face tier fits in shared memory ({far})")
    a8 = fst.streamed_broadphase(b1, b2, cfg.broadphase_tol)
    g8 = fst.gjk_hulls_big(b1, b2, a8, cfg)
    o8, n8 = hit_first_order(g8.hit)
    wargs = (b1, b2, g8.simplex, g8.status, o8, n8, ladder)
    dargs = (b1, b2, g8.simplex, g8.status, o8, n8, stages)
    zero_launches()
    ek, reads_wide = host_reads(lambda: fst.epa_hulls_big(*wargs))
    _, reads_default = host_reads(lambda: fst.epa_hulls_big(*dargs))
    t0 = time.perf_counter()
    ep = fst.epa_hulls_big_plain(*wargs)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    check(rows_equal(ek, ep), "phase 23: K13 past shared memory differs "
          "from plain")
    check(reads_wide == 1 and reads_default == 0,
          f"phase 23: K13 host reads {reads_wide} past shared memory, "
          f"{reads_default} at the default ladder")
    default_rows = fst.epa_hulls_big(*dargs)
    third = isum(default_rows.status == gt.Status.HIT_EPA_DEGENERATE)
    store = max(int(n8), 1) * lib.epa_scratch_words_per_face() * far * 4
    t_wide = cuda_ms(lambda: fst.epa_hulls_big(*wargs), calls=3, warmup=1)
    t_default = device_ms(lambda: fst.epa_hulls_big(*dargs))
    log(f"phase 23 K13 past shared memory: ladder "
        f"{[c.epa_max_faces for c, _ in ladder]} on big8192's {int(n8)} "
        f"hits (every lane compared, plain in {t_plain:.2f} s), tiers up to "
        f"{near} faces in shared memory ({lib.epa_hulls_big_smem_bytes(near)}"
        f" B a block of {limit}), the {far}-face tier in a device store of "
        f"{store} B; rows bit for bit, max epa_iters {int(ek.iters.max())}; "
        f"host reads: {reads_wide} past shared memory, {reads_default} at "
        f"the default ladder ({third} final-tier degenerate there); ms "
        f"{t_wide:.4f} (wide: one call with its host read, median of 3) "
        f"against {t_default:.4f} (default ladder, device_ms) [{card}]")

    # -- fused_gjkepa_hulls(use_broadphase=False) at c2 against the CPU -------
    zero_launches()
    r = gt.fused_gjkepa_hulls(c1, c2, cfg=cfg, use_broadphase=False)
    per_call["c2"] = launched(gjk_hulls=1, epa_hulls=1)
    check(per_call["c2"] == {"gjk_hulls": 1, "epa_hulls": 1},
          f"phase 23: c2 without the broadphase launched {per_call['c2']}")
    n = 1024
    w = gt.fused_gjkepa_hulls(c1[:n].cpu(), c2[:n].cpu(), cfg=cfg,
                              use_broadphase=False)
    for f in ("hit", "status", "gjk_iters", "epa_iters"):
        check(torch.equal(getattr(r, f)[:n].cpu(), getattr(w, f)),
              f"phase 23: c2 without the broadphase: {f} differs from the "
              "CPU run")
    err = maxerr(*((getattr(r, f)[:n].cpu(), getattr(w, f))
                   for f in ("depth", "distance")))
    check(err <= 1e-5, f"phase 23: c2 without the broadphase: depth/"
          f"distance differ from the CPU run by {err}")
    path_ms = cuda_ms(lambda: gt.fused_gjkepa_hulls(c1, c2, cfg=cfg,
                                                    use_broadphase=False))
    path_on_ms = cuda_ms(lambda: gt.fused_gjkepa_hulls(c1, c2, cfg=cfg))
    log(f"phase 23 fused_gjkepa_hulls(use_broadphase=False) at c2 "
        f"{tuple(c1.shape[:2])} with EPA: {isum(r.hit)} hits, launches "
        f"{per_call['c2']}; the first {n} lanes against the CPU run: "
        f"discrete fields equal, depth/distance error {err:.3g} (tol "
        f"1e-5); {path_ms:.4f} ms = {c1.shape[0] / path_ms * 1e3:,.0f} q/s "
        f"against {path_on_ms:.4f} ms with the broadphase [{card}]")

    # -- the chunked portable distance at c2 ----------------------------------
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    whole, t_whole = wall(lambda: gt.gjk_distance_batch(c1, c2, cfg=cfg))
    parts, t_parts = wall(lambda: gt.gjk_distance_batch(c1, c2, cfg=cfg,
                                                        chunk_size=8192))
    check(fields_equal(whole, parts), "phase 23: the chunked portable "
          "distance differs from the unchunked call")
    log(f"phase 23 gjk_distance_batch at c2 in chunks of 8192: bit for bit "
        f"against the unchunked call; wall {t_parts:.1f} ms chunked, "
        f"{t_whole:.1f} ms unchunked (one call each) [{card}]")

    # -- times and the kernels entry of K1 without the broadphase at c2 -------
    t_off = device_ms(lambda: fused_gjk.gjk_hulls(c1, c2, cfg,
                                                  use_broadphase=False))
    t_on = device_ms(lambda: fused_gjk.gjk_hulls(c1, c2, cfg))
    t_plain_off = cuda_ms(lambda: fused_gjk.gjk_hulls_plain(
        c1, c2, cfg, use_broadphase=False), PLAIN_CALLS, 1)
    nv = c1.shape[1] + c2.shape[1]
    b = c1.shape[0]
    bound = work(b, nv * 12 + 61, gjk_ops(b, isum(g_off.iters),
                                          VERTEX_OPS * nv))
    log(f"phase 23 time K1 at c2: without the broadphase {t_off:.4f} ms "
        f"(plain {t_plain_off:.4f}), with it {t_on:.4f} ms; bound without "
        f"{bound[0]:.4f} ms ({bound[1]}) [{card}]")
    return [{**entry("gjk_hulls_no_broadphase", "gjk_hulls.cu", 1099,
                     per_call["c2"]["gjk_hulls"], 0.0, t_off, t_plain_off,
                     bound)}]


# -- phase 24: the bench ------------------------------------------------------

# The JAX bench's logged hits and contact points a hit (BENCH_r05.json
# ``tail``): data of the same inputs, not speeds.
BENCH_C3_HITS = {"seed0": 3870, "seed1": 3886, "seed2": 3866}
BENCH_C4_POINTS_PER_HIT = 3.05


class OneCallTimer:
    """``bench.Timer``'s interface with each query called once: its host
    reads counted (``host_reads``), then the probe read back."""

    def __init__(self):
        self.calls = 0
        self.reads = []

    def time(self, fn, probe, **policy):
        t0 = time.perf_counter()
        r, reads = host_reads(fn)
        probe(r).sum().item()
        self.calls += 1
        self.reads.append(reads)
        return time.perf_counter() - t0, r

    def sync_latency(self, fn, probe):
        return self.time(fn, probe)[0]

    def profile(self, name, fn, probe, calls=5):
        pass


def bench_phase(gt, dev, cfg, card) -> None:
    """Phase 24: ``gjkepa_tpu_torch.bench``: (a) each config function
    once on the bench's inputs, a query a call, its kernels' launches
    counted and the fused queries' host reads; (b) ``python3 -m
    gjkepa_tpu_torch.bench`` in a subprocess over every config, its
    output line checked."""
    from gjkepa_tpu_torch import bench
    from gjkepa_tpu_torch.ops import fused_gjk
    from gjkepa_tpu_torch.parallel import pair_mesh
    mesh = pair_mesh()
    deep = bench.c4_inputs(dev)
    # config: (its call, its launches over n queries, how many of its first
    # queries must read nothing back: None for all)
    configs = {
        "c1": (lambda t: bench.c1(t, *bench.c1_inputs(dev), cfg),
               lambda n: {}, 0),
        "c2": (lambda t: bench.c2(t, bench.c2_inputs(dev), cfg),
               lambda n: {"gjk_hulls": n // 2, "distance_hulls": n}, None),
        "c3": (lambda t: bench.c3(t, bench.c3_inputs(dev), cfg),
               lambda n: {"cf_shapes": n, "gjk_sub_shapes": n,
                          "epa_shapes": n}, None),
        "c3b": (lambda t: bench.c3b(t, *bench.c3b_inputs(dev), cfg),
                lambda n: {"gjk_hull_shape": n, "epa_hull_shape": n}, None),
        "c4": (lambda t: bench.c4(t, *deep, cfg),
               lambda n: {"gjk_hulls": n, "epa_hulls": n}, 1),
        "c6": (lambda t: bench.c6(t, mesh, *deep, cfg),
               lambda n: {"gjk_hulls": mesh.size * n,
                          "epa_hulls": mesh.size * n}, None),
        "c5": (lambda t: bench.c5(t, *bench.c5_inputs(dev)),
               lambda n: {"gjk_hulls": 10 + 3, "epa_hulls": 10 + 3}, 0),
    }
    notes = []
    diags = {}
    for name, (run, launches, quiet) in configs.items():
        timer = OneCallTimer()
        zero_launches()
        fused_gjk.STAGED_LAUNCHES = 0
        results, diags[name] = run(timer)
        got = launched()
        want = launches(timer.calls)
        check(got == want, f"phase 24: bench.{name} launched {got} over "
              f"{timer.calls} queries, expected {want}")
        # every hull of the bench fits K1's staged tile
        check(fused_gjk.STAGED_LAUNCHES == want.get("gjk_hulls", 0),
              f"phase 24: bench.{name} staged {fused_gjk.STAGED_LAUNCHES} "
              f"of its {want.get('gjk_hulls', 0)} K1 launches")
        check(not any(timer.reads[:quiet]), f"phase 24: bench.{name}'s "
              f"fused queries made host reads: {timer.reads}")
        check(set(results) <= set(bench.KEYS), f"phase 24: bench.{name} "
              f"keys {sorted(results)}")
        notes.append(f"{name}: {timer.calls} queries, launches {got} "
                     f"(K1 staged {fused_gjk.STAGED_LAUNCHES}), host reads a "
                     f"query {timer.reads}")
    check(set(diags["c3"]) == {"seed0", "seed1", "seed2", "shuffled"}
          and diags["c3"]["shuffled"] == diags["c3"]["seed0"],
          f"phase 24: c3 diagnostics {diags['c3']}")
    for seed, hits in BENCH_C3_HITS.items():
        got = diags["c3"][seed]["hits"]
        check(abs(got - hits) <= 0.01 * hits, f"phase 24: c3 {seed} has "
              f"{got} hits, the JAX bench's {hits}")
    c4 = diags["c4"]
    check(c4["hit_fraction"] >= 0.99 and abs(
        c4["points_per_hit"] - BENCH_C4_POINTS_PER_HIT)
        <= 0.02 * BENCH_C4_POINTS_PER_HIT, f"phase 24: c4 diagnostics {c4}")
    log("phase 24 bench configs, a query a call: " + "; ".join(notes)
        + f"; c3 {diags['c3']}; c4 {c4} [{card}]")

    # -- (b) the entry point as a user runs it --------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gjkepa_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"phase 24 bench stderr: {line}")
    check(proc.returncode == 0, f"phase 24: the bench exited "
          f"{proc.returncode}")
    out = json.loads(proc.stdout.splitlines()[-1])
    keys = list(out["configs"])
    check(keys == list(bench.KEYS), f"phase 24: the bench's keys {keys}")
    vals = out["configs"]
    rates = {k: v for k, v in vals.items()
             if k.endswith(("_qps", "_steps_per_sec", "_us"))}
    check(all(np.isfinite(v) and v > 0 for v in rates.values()),
          f"phase 24: a rate is not finite and positive: {rates}")
    check(out["metric"] == bench.METRIC and out["unit"] == "queries/s"
          and abs(out["value"] - vals["c3_analytic64k_qps"]) <= 1e-3
          and out["vs_baseline"] == out["value"] / 50e6,
          f"phase 24: the bench's line {out}")
    check(0 <= vals["c3_seed_spread"] < 1 and vals["c4_hit_fraction"] >= 0.99
          and vals["c6_n_devices"] == torch.cuda.device_count(),
          f"phase 24: the bench's configs {vals}")
    hits = {f"seed{s}": int(h) for s, h in re.findall(
        r"seed (\d): .*?\((\d+) hits", proc.stderr)}
    check(set(hits) == set(BENCH_C3_HITS) and all(
        abs(hits[s] - h) <= 0.01 * h for s, h in BENCH_C3_HITS.items()),
        f"phase 24: the bench's c3 hits {hits}")
    pts = [float(x) for x in re.findall(r"\(([0-9.]+) contact points/hit\)",
                                        proc.stderr)]
    check(len(pts) == 1 and abs(pts[0] - BENCH_C4_POINTS_PER_HIT)
          <= 0.02 * BENCH_C4_POINTS_PER_HIT,
          f"phase 24: the bench's c4 points a hit {pts}")
    log(f"phase 24 bench line ({seconds:.1f} s, python3 -m "
        f"gjkepa_tpu_torch.bench) [{card}]: {json.dumps(out)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    import gjkepa_tpu_torch as gt
    from gjkepa_tpu_torch import _build
    from gjkepa_tpu_torch.ops import contact_rows, fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops.fused import (cascade_plan, hit_first_order,
                                            hulls_result)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    cfg = gt.GJKEPAConfig.for_f32()
    stages = cascade_plan(cfg)

    # -- phase 0: environment and build --------------------------------------
    log(f"phase 0 env: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load()
    libs = _build.build()
    log(f"phase 0 build: {', '.join(p.name for p in libs.values())} "
        f"built and loaded in {time.perf_counter() - t0:.2f} s")
    for src in _build.SOURCES:
        for line in ptxas_report(libs[src].with_suffix(".log").read_text()):
            log(f"phase 0 ptxas {src}: {line}")

    def on_dev(*arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def plain_path(p1, p2, c):
        """fused_gjkepa_hulls through the plain versions."""
        g = fused_gjk.gjk_hulls_plain(p1, p2, c)
        return hulls_result(g, cascade_plan(c), lambda *a: (
            fused_epa.epa_cascade_plain(p1, p2, g.simplex, g.status, *a)))

    def compare_k1(p1, p2, c, what):
        """K1 against its plain version, rows bit for bit (the simplex on
        the lanes that ran GJK); returns the max abs error over sep and
        simplex."""
        gk = fused_gjk.gjk_hulls(p1, p2, c)
        gp = fused_gjk.gjk_hulls_plain(p1, p2, c)
        torch.cuda.synchronize()
        ran = gp.status != 0
        check(torch.equal(gk.hit, gp.hit), f"{what}: K1 hit differs")
        check(torch.equal(gk.status, gp.status), f"{what}: K1 status differs")
        it_diff = int((gk.iters != gp.iters).sum())
        err = max(float((gk.sep - gp.sep).abs().max()),
                  float((gk.simplex - gp.simplex)[ran].abs().max()))
        check(it_diff == 0 and err == 0.0
              and torch.equal(gk.simplex[ran], gp.simplex[ran]),
              f"{what}: K1 rows differ from plain (gjk_iters on {it_diff} "
              f"lanes, sep/simplex by {err})")
        log(f"{what} K1 vs plain, {p1.shape[0]} x {p1.shape[1]} (team of "
            f"{fused_gjk.team_size(p1.shape[1], p2.shape[1])}): rows bit for "
            f"bit, {int(gk.hit.sum())} hits, {isum(ran)} lanes ran GJK")
        return err

    def compare_k2(p1, p2, what, tiers=stages, **variant):
        """K2 against its plain version on the same K1 rows, bit for bit
        (``variant``: the shared store's faces or the team width, else the
        wrapper's); returns the max abs error over depth and normal."""
        g = fused_gjk.gjk_hulls(p1, p2, cfg)
        order, n_act = hit_first_order(g.hit)
        args = (p1, p2, g.simplex, g.status, order, n_act, tiers)
        split = dict(fused_epa.LAUNCHES_BY_TEAM)
        claims = fused_epa.pool_claims(dev)
        with fused_epa.k2_tally(dev) as tally:
            ek = (fused_epa._epa_cascade_cuda(*args, **variant) if variant
                  else fused_epa.epa_cascade(*args))
        split = {t: n - split[t] for t, n in
                 fused_epa.LAUNCHES_BY_TEAM.items()}
        ep = fused_epa.epa_cascade_plain(*args)
        torch.cuda.synchronize()
        tally = tally.tolist()
        tiers_done = tally[:fused_epa.MAX_TIERS]
        check(sum(tiers_done) == int(n_act),
              f"{what}: K2's tally {tally} does not sum to {int(n_act)} hits")
        claims = fused_epa.pool_claims(dev) - claims
        check(claims == tally[fused_epa.TALLY_CLAIMS],
              f"{what}: K2's pool counter read {claims} claims, its tally "
              f"{tally[fused_epa.TALLY_CLAIMS]}")
        busy = [int(m.count_nonzero()) for _, m in fused_epa._POOLS.values()]
        check(not any(busy), f"{what}: K2's pool masks left slots taken")
        err = max(float((ek.depth - ep.depth).abs().max()),
                  float((ek.normal - ep.normal).abs().max()))
        ei_diff = int((ek.iters != ep.iters).sum())
        check(rows_equal(ek, ep),
              f"{what}: K2 rows are not bit-equal to the plain version "
              f"(status equal: {torch.equal(ek.status, ep.status)}, depth/"
              f"normal err {err}, epa_iters differ on {ei_diff} of "
              f"{int(n_act)} hits)")
        pairing = fused_epa.k2_pairing(tally)
        log(f"{what} K2 vs plain, {p1.shape[0]} x {p1.shape[1]} deep, tiers "
            f"{[c.epa_max_faces for c, _ in tiers]}"
            + (f", {variant}" if variant else "") + f": {int(n_act)} hits, "
            f"epa_iters mean {float(ep.iters[g.hit].float().mean()):.3f} "
            f"largest {int(ep.iters.max())}, launches by lanes a hit "
            f"{split}, finished by tier {tiers_done}, "
            f"{tally[fused_epa.TALLY_CLAIMS]} pool claims, pairing "
            + ("n/a" if pairing is None else f"{pairing:.4f}")
            + ", rows bit for bit")
        return err

    # -- phase 1: K1 vs plain -------------------------------------------------
    bool_cfg = cfg.replace(epa_max_iters=0)
    rng = np.random.default_rng(0)
    k1_err = compare_k1(*on_dev(random_hulls(rng, 4096, 64),
                                random_hulls(rng, 4096, 64)),
                        bool_cfg, "phase 1")
    # vertex counts that are not a multiple of 4: K11's scalar scan, at the
    # teams the rule gives them (4 and 32)
    for b, n in ((4096, 63), (1024, 2047)):
        k1_err = max(k1_err, compare_k1(*on_dev(random_hulls(rng, b, n),
                                                random_hulls(rng, b, n)),
                                        bool_cfg, "phase 1"))

    # -- phase 2: K2 vs plain -------------------------------------------------
    rng = np.random.default_rng(0)
    deep = on_dev(*deep_pairs(rng, 2048, 24))
    k2_err = compare_k2(*deep, "phase 2")
    k2_err = max(k2_err, compare_k2(*deep, "phase 2", team=32))
    # K2's stores by its rule over the kernel's own byte count and
    # occupancy, at each width
    limit = _build.smem_limit(dev)
    for team in (16, 32):
        facts = fused_epa.k2_device(dev, team)
        nbytes = fused_epa.k2_smem_bytes(team)
        near = fused_epa.k2_near_faces(stages, nbytes, facts.blocks,
                                       facts.sm_bytes, facts.reserve)
        hits = fused_epa.k2_resident_hits(dev, stages, team)
        log(f"phase 2 K2 stores at {team} lanes a hit: {facts}; the tiers "
            f"{[c.epa_max_faces for c, _ in stages]} in shared memory up to "
            f"{near} faces ({nbytes(near)} B a block), the pool "
            f"{fused_epa.far_store_faces(stages, near)} faces a slot; "
            f"{hits} hits an SM")
        check(hits >= facts.blocks * facts.hits,
              f"phase 2: K2's store rule gives {hits} hits an SM at {team} "
              f"lanes, the registers {facts.blocks * facts.hits}")
    # a ladder whose first tiers overflow, its tiers as the rule places
    # them, the last in the pool, all in the pool; then a face capacity
    # past shared memory, which takes the pool
    ladder = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((8, 2), (16, 4), (208, 16))]
    for team in (16, 32):
        for near in (None, 16, 0):
            k2_err = max(k2_err, compare_k2(
                *deep, "phase 2 overflow ladder", ladder, near_faces=near,
                team=team))
    check(fused_epa.k2_smem_bytes(32)(4096) > limit,
          "phase 2: a 4096-face store fits in shared memory")
    k2_err = max(k2_err, compare_k2(
        *(t[:512].contiguous() for t in deep), "phase 2 past shared memory",
        [(cfg.replace(epa_max_faces=4096), 16)]))

    # -- phase 3: known geometry through the main path -------------------------
    corners = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                        for z in (-.5, .5)], np.float32)
    offsets = [0.3, 0.7, 1.2, 2.5] * 32
    c1, c2 = on_dev(np.stack([corners] * len(offsets)),
                    np.stack([corners + np.array([dx, 0, 0], np.float32)
                              for dx in offsets]))
    r = gt.gjkepa_batch_fused(c1, c2, cfg=cfg)
    hit, depth = r.hit.cpu().numpy(), r.depth.cpu().numpy()
    for i, dx in enumerate(offsets):
        if dx < 1.0:
            check(bool(hit[i]) and abs(depth[i] - (1.0 - dx)) < 1e-5,
                  f"phase 3: cube offset {dx}: hit {hit[i]} depth {depth[i]}")
        else:
            check(not hit[i], f"phase 3: cube offset {dx} reported a hit")
    log("phase 3 known geometry: cube depths 1-dx within 1e-5, misses at "
        "dx >= 1")

    # -- phase 4: float64 oracle ---------------------------------------------
    oracle = load_oracle()
    rng = np.random.default_rng(7)
    n_pairs, n_verts = 64, 16
    o1 = np.empty((n_pairs, n_verts, 3))
    o2 = np.empty((n_pairs, n_verts, 3))
    ref_depth = np.zeros(n_pairs)
    valid = np.zeros(n_pairs, dtype=bool)
    for i in range(n_pairs):
        v = rng.normal(size=(n_verts, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        o1[i] = v * (1.0 + rng.random((n_verts, 1)))
        w = rng.normal(size=(n_verts, 3))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        o2[i] = w * 0.5 * (0.5 + 0.5 * rng.random((n_verts, 1)))
        o2[i] += rng.normal(size=3) * 0.15
        try:
            o = oracle.gjkepa_oracle(o1[i], o2[i])
        except oracle.OracleHalt:
            continue
        if o.hit and not o.epa_capped:
            ref_depth[i] = o.depth
            valid[i] = True
    check(valid.sum() >= n_pairs * 3 // 4,
          f"phase 4: {valid.sum()} oracle hits")
    r = gt.gjkepa_batch_fused(*on_dev(o1.astype(np.float32),
                                      o2.astype(np.float32)), cfg=cfg)
    hit = r.hit.cpu().numpy()
    check(bool(hit[valid].all()), "phase 4: missed an oracle-converged hit")
    oracle_err = float(np.abs(r.depth.cpu().numpy()[valid]
                              - ref_depth[valid]).max())
    check(oracle_err < 1e-5, f"phase 4: depth error {oracle_err} vs oracle")
    log(f"phase 4 float64 oracle: {int(valid.sum())} converged oracle hits all "
        f"hit, depth max abs err {oracle_err:.3g} (budget 1e-5)")

    # -- phase 5: main path at full size, launches counted --------------------
    rng = np.random.default_rng(0)
    m1, m2 = on_dev(*deep_pairs(rng, 16384, 24))
    b1, b2 = on_dev(random_hulls(rng, 65536, 64), random_hulls(rng, 65536, 64))
    torch.cuda.synchronize()
    fused_gjk.LAUNCHES = 0
    fused_epa.LAUNCHES = 0
    full = gt.gjkepa_batch_fused(m1, m2, cfg=cfg)
    boolean = gt.fused_gjkepa_hulls(b1, b2, cfg=bool_cfg)
    torch.cuda.synchronize()
    launches = {"gjk_hulls": fused_gjk.LAUNCHES,
                "epa_hulls": fused_epa.LAUNCHES}
    check(all(n > 0 for n in launches.values()),
          f"phase 5: a kernel of the main path never launched: {launches}")
    check(full.nearest_points.shape == (16384, 2, 3)
          and full.contact_point.shape == (16384, 3), "phase 5: bad shapes")
    for name, t in full._asdict().items():
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"phase 5: {name} not finite")
    hit_frac = float(full.hit.float().mean())
    check(hit_frac >= 0.9, f"phase 5: c4 hit fraction {hit_frac}")
    check(bool(torch.isfinite(boolean.distance).all()), "phase 5: c2 distance")
    # the whole main path against the plain path, and each kernel against
    # its plain version at the main path's shapes (not counted above)
    pr = plain_path(m1, m2, cfg)
    check(torch.equal(pr.hit, full.hit) and torch.equal(pr.status, full.status),
          "phase 5: main path hit/status differ from the plain path")
    _, cp, _, ct = contact_rows.derive_contact_rows(m1, m2, pr.normal, cfg)
    ph = pr.hit & ((pr.normal * full.normal).sum(1) > 1.0 - 1e-5)
    cp_err = float((cp[ph] - full.contact_point[ph]).abs().max())
    check(cp_err <= 1e-5 and torch.equal(ct[ph], full.colli_type[ph]),
          f"phase 5: contact rows differ from plain by {cp_err}")
    log(f"phase 5 main path: gjkepa_batch_fused 16384 x 24 deep, full contact "
        f"v2: finite, hit fraction {hit_frac:.4f}, "
        f"{int(full.status.eq(gt.Status.HIT).sum())} HIT, mean epa_iters "
        f"{float(full.epa_iters.float().mean()):.2f}, equal to the plain path "
        f"(contact point err {cp_err:.3g} on {int(ph.sum())} lanes); "
        f"fused_gjkepa_hulls 65536 x 64 boolean: hit fraction "
        f"{float(boolean.hit.float().mean()):.4f}; launches {launches}")
    k1_err = max(k1_err, compare_k1(m1, m2, cfg, "phase 5 c4"),
                 compare_k1(b1, b2, bool_cfg, "phase 5 c2"))
    k2_err = max(k2_err, compare_k2(m1, m2, "phase 5 c4"))

    # -- phase 6: timings, kernel path vs plain path --------------------------
    g4 = fused_gjk.gjk_hulls(m1, m2, cfg)
    o4, n4 = hit_first_order(g4.hit)
    times = {
        "k1_c4": device_ms(lambda: fused_gjk.gjk_hulls(m1, m2, cfg)),
        "k1_c4_one_call": cuda_ms(lambda: fused_gjk.gjk_hulls(m1, m2, cfg)),
        "k2_c4_one_call": cuda_ms(lambda: fused_epa.epa_cascade(
            m1, m2, g4.simplex, g4.status, o4, n4, stages)),
        "k1_c4_plain": cuda_ms(lambda: fused_gjk.gjk_hulls_plain(m1, m2, cfg)),
        "k2_c4": device_ms(lambda: fused_epa.epa_cascade(
            m1, m2, g4.simplex, g4.status, o4, n4, stages)),
        "k2_c4_plain": cuda_ms(lambda: fused_epa.epa_cascade_plain(
            m1, m2, g4.simplex, g4.status, o4, n4, stages)),
        "k1_c2": device_ms(lambda: fused_gjk.gjk_hulls(b1, b2, bool_cfg)),
        "k1_c2_plain": cuda_ms(
            lambda: fused_gjk.gjk_hulls_plain(b1, b2, bool_cfg)),
        "path_c4": cuda_ms(lambda: gt.gjkepa_batch_fused(m1, m2, cfg=cfg)),
        "path_c4_plain": cuda_ms(lambda: gt.derive_contact_batch(
            m1, m2, plain_path(m1, m2, cfg), cfg)),
        "path_c2": cuda_ms(lambda: gt.fused_gjkepa_hulls(b1, b2, cfg=bool_cfg)),
        "path_c2_plain": cuda_ms(lambda: plain_path(b1, b2, bool_cfg)),
    }
    for name, p1, p2, c in (("c4", m1, m2, cfg), ("c2", b1, b2, bool_cfg)):
        want = fused_gjk.gjk_hulls(p1, p2, c)
        for team in fused_gjk.TEAMS:
            got = fused_gjk._gjk_hulls_cuda(p1, p2, c, team)
            ran = want.status != 0
            check(all(torch.equal(x, y) for x, y in zip(
                (*got[:4], got.simplex[ran]), (*want[:4], want.simplex[ran]))),
                f"phase 6: K1 at a team of {team} differs at {name}")
            times[f"k1_{name}_T{team}"] = device_ms(
                lambda: fused_gjk._gjk_hulls_cuda(p1, p2, c, team))
    for key, ms in times.items():
        b = 16384 if "c4" in key else 65536
        log(f"phase 6 time {key}: {ms:.4f} ms = {b / ms * 1e3:,.0f} pairs/s "
            f"[{card}]")
    log(f"phase 6 K1 team sizes (each bit-equal to the wrapper's team of "
        f"{fused_gjk.team_size(24, 24)} at c4, {fused_gjk.team_size(64, 64)} "
        f"at c2): " + ", ".join(
            f"T={t}: c4 {times[f'k1_c4_T{t}']:.4f} ms, c2 "
            f"{times[f'k1_c2_T{t}']:.4f} ms" for t in fused_gjk.TEAMS)
        + f" [{card}]")
    log(f"phase 6 end to end: c4 16384 x 24 full contact "
        f"{16384 / times['path_c4'] * 1e3:,.0f} q/s (plain path "
        f"{16384 / times['path_c4_plain'] * 1e3:,.0f}); c2 65536 x 64 boolean "
        f"{65536 / times['path_c2'] * 1e3:,.0f} q/s (plain path "
        f"{65536 / times['path_c2_plain'] * 1e3:,.0f}) [{card}]")

    # bounds at c4, from this run's lanes and iterations (see work())
    e4 = fused_epa.epa_cascade(m1, m2, g4.simplex, g4.status, o4, n4, stages)
    nv = m1.shape[1] + m2.shape[1]
    k1_bound = work(16384, nv * 12 + 61, 16384 * nv * SPHERE_OPS + gjk_ops(
        isum(g4.status != 0), isum(g4.iters), VERTEX_OPS * nv))
    k2_bound = work(int(n4), nv * 12 + 56 + 24,
                    epa_ops(isum(e4.iters), VERTEX_OPS * nv))
    kernels = [
        entry("gjk_hulls", "gjk_hulls.cu", 1099, launches["gjk_hulls"],
              k1_err, times["k1_c4"], times["k1_c4_plain"], k1_bound),
        entry("epa_hulls", "epa_hulls.cu", 1112, launches["epa_hulls"],
              k2_err, times["k2_c4"], times["k2_c4_plain"], k2_bound),
    ]
    kernels += shape_phases(gt, dev, cfg, card)
    kernels += distance_and_mixed_phases(gt, dev, cfg, card)
    kernels += big_phases(gt, dev, cfg, card)
    portable_phase(gt, dev, card)
    manifold_phase(gt, dev, cfg, card)
    sim_phase(gt, dev, cfg, card)
    sharding_phase(gt, dev, cfg, card)
    sanitizer_phase(gt, dev, cfg, card)
    entry_phase(gt, dev, card)
    portable_distance_phase(gt, dev, cfg, card)
    kernels += parity_phase(gt, dev, cfg, card)
    bench_phase(gt, dev, cfg, card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
