"""Block-size sweeps and parent-against-change kernel times for the
PyTorch/CUDA port (``gjkepa_tpu_torch``), on one card.

Usage, from the root of a checkout:

    python3 scripts/torch_kernel_sweep.py teams
    python3 scripts/torch_kernel_sweep.py k1
    python3 scripts/torch_kernel_sweep.py warps
    python3 scripts/torch_kernel_sweep.py k2
    python3 scripts/torch_kernel_sweep.py k12
    python3 scripts/torch_kernel_sweep.py k8
    python3 scripts/torch_kernel_sweep.py k7
    python3 scripts/torch_kernel_sweep.py k9
    python3 scripts/torch_kernel_sweep.py k10
    python3 scripts/torch_kernel_sweep.py k5
    python3 scripts/torch_kernel_sweep.py k6a
    python3 scripts/torch_kernel_sweep.py k6b [--root DIR]
    python3 scripts/torch_kernel_sweep.py times [--root DIR] [--tag NAME]

``teams``: K1 (``csrc/gjk_hulls.cu``) runs a team of T threads a pair, T
picked by ``fused_gjk.team_size`` from the hull size.  This runs every T
of ``fused_gjk.TEAMS`` on a grid of (pairs, vertices), each bit for bit
against the plain version, and prints each one's device time.

``k1``: K1 stages a block's hulls in shared memory where its tile fits
``fused_gjk.STAGED_BUDGET``: a block of K1_STAGED_PAIRS = 32 pairs, a team
of T threads each.  This rebuilds that source with ``-DK1_STAGED_PAIRS=P``
for P = 16, 32 and 64 and runs the staged kernel of each build at every T
of ``fused_gjk.STAGED_TEAMS`` where its tile fits the device, and the
streamed kernel at every T of ``fused_gjk.TEAMS``, on c2 (65,536 x 64) and
c4 (16,384 x 24) with and without the broadphase, 65,536 x 24, 16,384 x
128 and x 256, 4,096 x 63, 4,096 x 24 (a c6 shard) and 8,192 x 64 pairs,
each bit for bit against the plain version, and prints each one's device
time and tile.

``warps``: K13 (``csrc/epa_hulls_big.cu``) runs a block of 8 warps a pair.
This rebuilds that source with ``-DK13_WARPS=W`` for W = 1, 2, 4 and 8
(into ``gjkepa_tpu_torch/build/sweep/``), runs each build through the
wrapper on 4096 x 2600 and 256 x 8192 pairs and over a tier ladder forced
to overflow at 512 x 2601, bit for bit against the plain version, and
prints each one's time, registers and the least-squares fit t(W) = face +
probe / W.

``k2``: K2 (``csrc/epa_hulls.cu``) runs a warp a hit, 1 warp a block, each
tier's polytope in shared memory up to a face capacity and in a slot of
the device pool above it.  This rebuilds that source with
``-DK2_PAIRS=P`` for P = 1, 2, 4 and 8 warps a block and runs each build
with the default ladder's tiers in shared memory up to 48, 88 or 208
faces (or none), at c4, at 2048 x 24 and at 65,536 x 24, and a
forced-overflow ladder, each bit for bit against the plain version, and
prints each one's device time and warps an SM.

``k12``: K12 (``csrc/gjk_hulls_big.cu``) runs a block of W warps a pair.
This rebuilds that source with ``-DK12_WARPS=W`` for W = 2, 4, 8 and 16,
each as shipped (the hulls staged in shared memory where they fit) and
with ``-DK12_STAGE=0`` (scanned in device memory at every size), runs each
build on 4096 x 2600, 256 x 8192, 512 x 2601 and 8 x 10240 pairs (past
shared memory: both scan), bit for bit against the plain version, and
prints the times of the first two and each one's time a probe.

``k8``: K8 (``csrc/distance_hulls.cu``) runs a team of T threads a pair.
This rebuilds that source with ``-DK8_MIN_BLOCKS=B`` for B = 1, 4, 6 and 8
(the blocks an SM ptxas sizes its registers for) and runs every T of
``fused_gjk.TEAMS`` of each build at c2 (65,536 x 64) for phase 1 (every
pair at cap 10), phase 2 (the pairs phase 1 left unconverged, at cap 64,
into phase 1's rows) and one pass (every pair at cap 64), each bit for bit
against the plain version, and prints each one's device time and the
wrapper's team for each.

``k7``: K7 (``csrc/epa_shapes.cu``) runs a warp a hit, 1 warp a block.
This rebuilds that source with ``-DK7_WARPS=W`` for W = 1, 2 and 4 and
runs each build at c3 (chip_smoke.py's inputs) and on a dense
all-cylinder batch (16,384 pairs, most of them hits), bit for bit
against the plain version, and prints each one's device time.

``k9``: K9 (``csrc/gjk_hull_shape.cu``) runs a team of T threads a pair,
T picked by ``fused_hull_shapes.team_size`` from the hull size.  This runs
every T of ``fused_gjk.TEAMS`` at c3b (chip_smoke.py's inputs) and on
4,096 hulls of 256 and of 1,024 vertices against the four kinds
(``fixtures.hull_kind_pairs``), each bit for bit against the plain
version, and prints each one's device time, the GJK iteration counts
(mean, 99th percentile, max) and, at c3b, the wrapper's team's time
without the pairs above the 99th percentile of iterations (the chain that
sets a launch's length).

``k10``: K10 (``csrc/epa_hull_shape.cu``) runs a warp a hit, 1 warp a
block.  This rebuilds that source with ``-DK10_WARPS=W`` for W = 1, 2 and
4 and runs each build at c3b and on a denser mixed batch (16,384 x 24
hulls and shapes at positions ~ N(0, 0.2^2), most pairs hits), bit
for bit against the plain version, and prints each one's device time.

``k5``: K5 (``csrc/cf_shapes.cu``) runs a thread a pair.  This times it at
c3 in natural and shuffled order, on c3's box-box quarter alone and on the
rest, on c3 as whole warps of one kind in a random order and as the
shuffled pairs sorted by kind in each block of 128, and on the 16 kind
pairs, each bit for bit against the plain version, beside a kernel that
only moves K5's bytes in K5's layout (``K5_COPY_SOURCE``: the floor this
card reaches for that traffic).

``k6a``: K6a (``csrc/gjk_shapes.cu``) runs a quad of threads a GJK pair on
the blocks the card holds at once.  This rebuilds that source with
``-DK6A_PAIRS=P`` (quads a block) and runs each build on c3 (natural and
shuffled), the 16 kind pairs, 16,381 all-cylinder pairs and a batch with
no GJK lane, bit for bit against the plain version (every row, the
inactive ones too), and prints each one's time alone (through its C entry
point, on rows allocated beforehand), the GJK iteration spread and, at
c3, the shipped build's time without the pairs above the 99th percentile
of iterations; then K6a and K6b (a thread a pair) at c3 with
``gjk_max_iters`` capped at 0-16, whose slope is a GJK iteration's
latency on one chain.

``k6b``: K6b (``csrc/gjk_shapes.cu``) runs a block of K6B_PAIRS pairs on
K6B_THREADS threads: their closed forms a thread a pair, then the block's
GJK lanes a quad of threads a pair.  This rebuilds that source with
``-DK6B_THREADS=T -DK6B_PAIRS=P`` for (T, P) = (128, 128), (64, 64),
(128, 64) and (128, 32) and, with ``--root DIR``, builds DIR's
``gjk_shapes.cu`` (a parent's K6b), and runs each build on c3 (natural and shuffled), the 16
kind pairs and an all-cylinder batch, bit for bit against the plain
version (the closed-form channel too), timing each alone through its C
entry point on rows allocated beforehand, in the order parent, builds,
builds reversed, parent; then each build at c3 with ``gjk_max_iters``
capped at 0-16.

``times``: device times of K5 (c3, natural and shuffled), K6a and K6b (c3,
the wrapper and the kernel alone through its C entry point; K6b's kernel
also shuffled), K1 (c4, c2),
K2 (c4), K7 (c3), K8 (c2: phase 1, phase 2 and one pass), K9 and K10
(c3b), K12 and K13 (4096 x 2600, 256 x 8192), chip_smoke.py's inputs, the
walls of the hull paths at c4, c2, 4096 x 2600 and 256 x 8192, of the
distance path at c2 (two-phase and one pass), of the shape path at c3 and
of the mixed path at c3b, and the shape path's device launches a call,
from the package under DIR (default: this checkout), so that a parent and
a change can be timed in turn on one card.  Prints one JSON line tagged
NAME.

Device times are chip_smoke.py's ``device_ms``: CUDA events around 10
back-to-back calls queued behind a sleep kernel, so that the host's
enqueue time does not show.  ``times`` also prints chip_smoke.py's
``cuda_ms``, one call between two events, and takes the path walls so.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py of this checkout, for its input recipes and checks."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def rows_equal(x, y, active=None) -> bool:
    """Bit-equal rows; GJK rows' simplex on the ``active`` lanes only."""
    if active is not None:
        x, y = ((*r[:4], r.simplex[active]) for r in (x, y))
    return all(torch.equal(a, b) for a, b in zip(x, y))


# -- teams ---------------------------------------------------------------------

# (pairs, vertices, kind): c4, c2, phase 14's sub-hulls, a ladder of sizes,
# and vertex counts that are not a multiple of 4 (K11's scalar scan).
TEAM_GRID = ((16384, 24, "deep"), (2048, 23, "deep"), (65536, 64, "boolean"),
             (4096, 63, "boolean"), (4096, 128, "boolean"),
             (4096, 256, "boolean"), (4096, 256, "deep"),
             (65536, 256, "boolean"), (4096, 512, "boolean"),
             (4096, 1024, "boolean"), (4096, 1024, "deep"),
             (1024, 2047, "boolean"), (4096, 2048, "boolean"),
             (256, 2048, "subhull"))


def teams(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_gjk
    cfg = GJKEPAConfig.for_f32()
    bool_cfg = cfg.replace(epa_max_iters=0)
    rng = np.random.default_rng(5)
    table = []
    for b, n, kind in TEAM_GRID:
        if kind == "deep":
            pair, c = cs.deep_pairs(rng, b, n), cfg
        elif kind == "boolean":
            pair, c = (cs.random_hulls(rng, b, n),
                       cs.random_hulls(rng, b, n)), bool_cfg
        else:
            pair, c = fixtures.big_subhull_pairs(n)[0], cfg
        p1, p2 = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in pair)
        want = fused_gjk.gjk_hulls_plain(p1, p2, c)
        ran = want.status != 0
        row = {"pairs": b, "vertices": n, "kind": kind,
               "gjk_lanes": int(ran.sum()),
               "mean_iters": float(want.iters[ran].float().mean()),
               "rule": fused_gjk.team_size(n, n)}
        for t in fused_gjk.TEAMS:
            got = fused_gjk._gjk_hulls_cuda(p1, p2, c, t)
            torch.cuda.synchronize()
            if not rows_equal(got, want, ran):
                raise AssertionError(f"K1 at a team of {t} differs from plain "
                                     f"at {b} x {n} {kind}")
            row[f"T{t}"] = cs.device_ms(
                lambda: fused_gjk._gjk_hulls_cuda(p1, p2, c, t))
        best = min(fused_gjk.TEAMS, key=lambda t: row[f"T{t}"])
        row["fastest"] = best
        table.append(row)
        print(f"K1 {b} x {n} {kind}: {row['gjk_lanes']} GJK lanes, mean "
              f"iters {row['mean_iters']:.3f}; every team bit-equal to plain; "
              + ", ".join(f"T={t} {row[f'T{t}']:.4f}" for t in fused_gjk.TEAMS)
              + f" ms; fastest T={best}, rule T={row['rule']} [{card}]",
              flush=True)
        del p1, p2, want
        torch.cuda.empty_cache()
    print(json.dumps({"k1_teams": table, "card": card}), flush=True)


# -- k1 ------------------------------------------------------------------------

K1_STAGED_PAIRS = (16, 32, 64)
# (pairs, vertices, kind, broadphase)
K1_GRID = ((65536, 64, "boolean", True), (65536, 64, "boolean", False),
           (16384, 24, "deep", True), (16384, 24, "deep", False),
           (65536, 24, "boolean", True), (16384, 128, "boolean", True),
           (16384, 256, "boolean", True), (4096, 63, "boolean", True),
           (4096, 24, "deep", True), (8192, 64, "boolean", True))


def k1(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.ops import fused_gjk
    cfg = GJKEPAConfig.for_f32()
    bool_cfg = cfg.replace(epa_max_iters=0)
    builds = variants(cs, "gjk_hulls.cu", {
        p: {"K1_STAGED_PAIRS": p} for p in K1_STAGED_PAIRS})
    limit = _build.smem_limit(dev)
    rng = np.random.default_rng(22)
    table = []
    for b, n, kind, bp in K1_GRID:
        if kind == "deep":
            pair, c = cs.deep_pairs(rng, b, n), cfg
        else:
            pair, c = (cs.random_hulls(rng, b, n),
                       cs.random_hulls(rng, b, n)), bool_cfg
        p1, p2 = on_card(dev, *pair)
        want = fused_gjk.gjk_hulls_plain(p1, p2, c, bp)
        ran = want.status != 0
        row = {"pairs": b, "vertices": n, "kind": kind, "broadphase": bp,
               "gjk_lanes": int(ran.sum()), "rule": fused_gjk.team_size(n, n),
               "staged_by_rule": fused_gjk._staged(n, n),
               "staged_rule": fused_gjk.staged_team(b, n, n)}
        runs = [("streamed", t, None, False) for t in fused_gjk.TEAMS]
        runs += [(f"P{p} staged", t, ns, True) for p, ns in builds.items()
                 for t in fused_gjk.STAGED_TEAMS
                 if ns.gjk_hulls_staged_bytes(n, n) <= limit]
        for label, t, ns, staged in runs:
            def fn(t=t, staged=staged):
                return fused_gjk._gjk_hulls_cuda(p1, p2, c, t, bp, staged)
            with mock.patch.object(_build, "load",
                                   (lambda ns=ns: ns) if ns else _build.load):
                got = fn()
                torch.cuda.synchronize()
                if not rows_equal(got, want, ran):
                    raise AssertionError(f"K1 {label} T={t} differs from "
                                         f"plain at {b} x {n} {kind}")
                row[f"{label} T{t}"] = cs.device_ms(fn)
                if ns:
                    row[f"{label} tile"] = ns.gjk_hulls_staged_bytes(n, n)
        table.append(row)
        print(f"K1 {b} x {n} {kind}, broadphase {bp}: {row['gjk_lanes']} GJK "
              f"lanes; rule T={row['rule']}, staged by rule "
              f"{row['staged_by_rule']} (T={row['staged_rule']}); every run "
              "bit-equal to plain; "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                          if k.startswith(("streamed", "P"))
                          and not k.endswith("tile"))
              + f" ms [{card}]", flush=True)
        del p1, p2, want
        torch.cuda.empty_cache()
    print(json.dumps({"k1_staged": table, "card": card}), flush=True)


# -- rebuilt variants ------------------------------------------------------------

def build_variants(source: str, builds: dict, out_dir: Path,
                   csrc: dict | None = None) -> dict:
    """``source`` built once for each label of ``builds``, with its macros
    (``{"NAME": value}``) defined, all in parallel; ``csrc`` maps a label
    to another checkout's source directory (default: this one's)."""
    from gjkepa_tpu_torch import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem
    libs, jobs = {}, []
    for label, macros in builds.items():
        tag = "_".join([str(label)] + [f"{k}{v}" for k, v in macros.items()])
        libs[label] = out_dir / f"lib{stem}_{tag}.so"
        src_dir = (csrc or {}).get(label, _build.CSRC)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *(f"-D{k}={v}" for k, v in macros.items()), "-o",
               str(libs[label]), str(src_dir / source)]
        jobs.append((label, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)))
    for label, proc in jobs:
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{source} at {builds[label]}: nvcc failed:\n"
                               f"{log_text}")
        libs[label].with_suffix(".log").write_text(log_text)
    return libs


def bound_to(lib_path: Path, source: str) -> types.SimpleNamespace:
    """The port's entry points with ``source``'s taken from another build
    of it."""
    import ctypes
    from gjkepa_tpu_torch import _build
    ns = types.SimpleNamespace(**vars(_build.load()))
    lib = ctypes.CDLL(str(lib_path))
    for name, (src, argtypes) in _build.ENTRY_POINTS.items():
        if src == source:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(ns, name, fn)
    return ns


def variants(cs, source, builds, csrc=None):
    """Each rebuilt variant's entry points (label -> namespace), after its
    ptxas report."""
    from gjkepa_tpu_torch import _build
    libs = build_variants(source, builds, _build.BUILD_DIR / "sweep", csrc)
    for label, path in libs.items():
        for line in cs.ptxas_report(path.with_suffix(".log").read_text()):
            print(f"{source} {builds[label]} ptxas: {line}", flush=True)
    return {label: bound_to(p, source) for label, p in libs.items()}


def on_card(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


# -- warps ---------------------------------------------------------------------

WARPS = (1, 2, 4, 8)


def warps(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_streamed as fst
    from gjkepa_tpu_torch.ops.fused import cascade_plan, hit_first_order
    cfg = GJKEPAConfig.for_f32()
    stages = cascade_plan(cfg)
    ladder = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((8, 2), (16, 4), (208, 16))]
    builds = variants(cs, "epa_hulls_big.cu",
                      {w: {"K13_WARPS": w} for w in WARPS})
    cases = (("4096 x 2600", on_card(dev, *fixtures.big_c2_pairs()), stages,
              True),
             ("256 x 8192", on_card(dev, *fixtures.big_pairs_8192()), stages,
              True),
             ("ladder 512 x 2601", on_card(dev, *(
                 fixtures.random_hulls(np.random.default_rng(12), 512, 2601)
                 for _ in range(2))), ladder, False))
    table = []
    for what, (p1, p2), st, timed in cases:
        active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
        g = fst.gjk_hulls_big(p1, p2, active, cfg)
        order, n_act = hit_first_order(g.hit)
        args = (p1, p2, g.simplex, g.status, order, n_act, st)
        want = fst.epa_hulls_big_plain(*args)
        row = {"case": what, "hits": int(n_act),
               "mean_epa_iters": float(want.iters[g.hit].float().mean())}
        for w, ns in builds.items():
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                got = fst.epa_hulls_big(*args)
                torch.cuda.synchronize()
                if not rows_equal(got, want):
                    raise AssertionError(f"K13 at W={w} differs from plain at "
                                         f"{what}")
                if timed:
                    row[f"W{w}"] = cs.device_ms(lambda: fst.epa_hulls_big(*args))
        if timed:
            x = np.array([1.0 / w for w in WARPS])
            y = np.array([row[f"W{w}"] for w in WARPS])
            probe, face = np.polyfit(x, y, 1)
            row.update(face_ms=float(face), probe_ms_one_warp=float(probe))
        table.append(row)
        print(f"K13 {what}: {row['hits']} hits, mean epa_iters "
              f"{row['mean_epa_iters']:.3f}; every W bit-equal to plain"
              + ("; " + ", ".join(f"W={w} {row[f'W{w}']:.4f}" for w in WARPS)
                 + f" ms; fit t(W) = {row['face_ms']:.4f} + "
                   f"{row['probe_ms_one_warp']:.4f} / W ms" if timed else "")
              + f" [{card}]", flush=True)
    print(json.dumps({"k13_warps": table, "card": card}), flush=True)


# -- k2 ------------------------------------------------------------------------

K2_PAIRS = (1, 2, 4, 8)


def k2(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops.fused import cascade_plan, hit_first_order
    cfg = GJKEPAConfig.for_f32()
    stages = cascade_plan(cfg)
    ladder = [(cfg.replace(epa_max_faces=f), k)
              for f, k in ((8, 2), (16, 4), (208, 16))]
    builds = variants(cs, "epa_hulls.cu",
                      {p: {"K2_PAIRS": p} for p in K2_PAIRS})
    # shared-memory store up to F faces; the default ladder's tiers above
    # it in the pool (0: every tier there)
    splits = {"all": 208, "tiers 1-2": 88, "tier 1": 48, "none": 0}
    cases = (("c4 16384 x 24", cs.deep_pairs(np.random.default_rng(0),
                                             16384, 24), stages, splits),
             ("2048 x 24", cs.deep_pairs(np.random.default_rng(0), 2048, 24),
              stages, splits),
             ("65536 x 24", cs.deep_pairs(np.random.default_rng(0), 65536,
                                          24), stages, splits),
             ("ladder 2048 x 23", cs.deep_pairs(np.random.default_rng(12),
                                                2048, 23), ladder,
              {"all": 208, "tiers 1-2": 16, "none": 0}))
    table = []
    for what, pair, st, split in cases:
        p1, p2 = on_card(dev, *pair)
        g = fused_gjk.gjk_hulls(p1, p2, cfg)
        order, n_act = hit_first_order(g.hit)
        args = (p1, p2, g.simplex, g.status, order, n_act, st)
        want = fused_epa.epa_cascade_plain(*args)
        facts = fused_epa.k2_device(dev)
        row = {"case": what, "hits": int(n_act),
               "mean_epa_iters": float(want.iters[g.hit].float().mean()),
               "max_epa_iters": int(want.iters.max()),
               "rule_near_faces": fused_epa.k2_near_faces(
                   st, _build.load().epa_hulls_smem_bytes, facts.blocks,
                   facts.sm_bytes, facts.reserve)}
        for pairs, ns in builds.items():
            fused_epa.k2_device.cache_clear()  # this build's registers
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                row[f"P{pairs} warps an SM"] = fused_epa.k2_resident_warps(
                    dev, st)
                for name, near in split.items():
                    def fn(near=near):
                        return fused_epa._epa_cascade_cuda(*args,
                                                           near_faces=near)
                    got = fn()
                    torch.cuda.synchronize()
                    if not rows_equal(got, want):
                        raise AssertionError(
                            f"K2 at P={pairs}, shared store up to {near} "
                            f"faces, differs from plain at {what}")
                    row[f"P{pairs} {name}"] = cs.device_ms(fn)
            fused_epa.k2_device.cache_clear()
        table.append(row)
        print(f"K2 {what}: {row['hits']} hits, mean epa_iters "
              f"{row['mean_epa_iters']:.3f} (max {row['max_epa_iters']}); "
              f"every block size and store split bit-equal to plain; "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in row.items()
                          if k.startswith("P")) + f" ms [{card}]", flush=True)
        del p1, p2, g, want, args
        torch.cuda.empty_cache()
    print(json.dumps({"k2_blocks": table, "card": card}), flush=True)


# -- k12 -----------------------------------------------------------------------

K12_WARPS = (2, 4, 8, 16)


def k12(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_streamed as fst
    cfg = GJKEPAConfig.for_f32()
    builds = variants(cs, "gjk_hulls_big.cu", {
        (w, how): {"K12_WARPS": w, "K12_STAGE": int(how == "staged")}
        for w in K12_WARPS for how in ("staged", "scan")})
    rng = np.random.default_rng(14)
    cases = (("4096 x 2600", fixtures.big_c2_pairs(), True),
             ("256 x 8192", fixtures.big_pairs_8192(), True),
             ("512 x 2601", [fixtures.random_hulls(
                 np.random.default_rng(12), 512, 2601) for _ in range(2)],
              False),
             ("8 x 10240", [fixtures.random_hulls(rng, 8, 10240, 0.2)
                            for _ in range(2)], False))
    table = []
    for what, pair, timed in cases:
        p1, p2 = on_card(dev, *pair)
        active = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
        want = fst.gjk_hulls_big_plain(p1, p2, active, cfg)
        on = int(active.sum())
        probes = (6 * on + int(want.iters.sum())) / max(on, 1)
        row = {"case": what, "active": on, "probes_a_pair": probes}
        for (w, how), ns in builds.items():
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                def fn():
                    return fst.gjk_hulls_big(p1, p2, active, cfg)
                got = fn()
                torch.cuda.synchronize()
                if not rows_equal(got, want, active):
                    raise AssertionError(f"K12 at W={w} ({how}) differs "
                                         f"from plain at {what}")
                if timed:
                    row[f"W{w} {how}"] = cs.device_ms(fn)
        table.append(row)
        print(f"K12 {what}: {on} active, {probes:.3f} probes a pair; every W, "
              "staged and scanned, bit-equal to plain"
              + ("; " + ", ".join(
                  f"{k} {v:.4f} ms ({v / probes * 1e3:.3f} us a probe)"
                  for k, v in row.items() if k.startswith("W"))
                 if timed else "") + f" [{card}]", flush=True)
        del p1, p2, active, want
        torch.cuda.empty_cache()
    print(json.dumps({"k12_warps": table, "card": card}), flush=True)


# -- k8 ------------------------------------------------------------------------

K8_MIN_BLOCKS = (1, 4, 6, 8)


def k8(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_distance as fd
    from gjkepa_tpu_torch.ops import fused_gjk
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    cfg = GJKEPAConfig.for_f32()
    builds = variants(cs, "distance_hulls.cu", {m: {"K8_MIN_BLOCKS": m}
                                                for m in K8_MIN_BLOCKS})
    p1, p2 = on_card(dev, *fixtures.c2_hulls())
    n1, n2 = p1.shape[1], p2.shape[1]
    low = fd.distance_hulls_plain(p1, p2, cfg, 10)
    order, n_act = hit_first_order(~low.converged)
    full = fd.distance_hulls_plain(p1, p2, cfg, 64)
    restart = fd.distance_hulls_plain(p1, p2, cfg, 64, order, n_act,
                                      out=fd.DistanceRows(*(t.clone()
                                                            for t in low)))
    if not rows_equal(restart, full):
        raise AssertionError("K8's plain restart differs from one pass")
    scratch = fd.DistanceRows(*(t.clone() for t in low))
    phases = {  # name: (the launch at a team of t, its plain rows)
        "phase1": (lambda t: fd._distance_hulls_cuda(p1, p2, cfg, 10,
                                                     team=t), low),
        "phase2": (lambda t: fd._distance_hulls_cuda(
            p1, p2, cfg, 64, order, n_act, out=scratch, team=t), restart),
        "one_pass": (lambda t: fd._distance_hulls_cuda(p1, p2, cfg, 64,
                                                       team=t), full),
    }
    row = {"pairs": p1.shape[0], "vertices": n1, "restarted": int(n_act),
           "mean_iters": float(full.iters.float().mean()),
           "max_iters": int(full.iters.max()),
           "rule": {"phase1": fd.team_size(n1, n2, restart=False),
                    "phase2": fd.team_size(n1, n2, restart=True),
                    "one_pass": fd.team_size(n1, n2, restart=False)}}
    for m, ns in builds.items():
        with mock.patch.object(_build, "load", lambda ns=ns: ns):
            for name, (fn, want) in phases.items():
                for t in fused_gjk.TEAMS:
                    for x, y in zip(scratch, low):
                        x.copy_(y)
                    got = fn(t)
                    torch.cuda.synchronize()
                    if not rows_equal(got, want):
                        raise AssertionError(
                            f"K8 {name} at a team of {t}, min blocks {m}, "
                            "differs from plain")
                    row[f"{name} T{t} B{m}"] = cs.device_ms(lambda: fn(t))
                print(f"K8 c2 {name}, min blocks {m}: every team bit-equal "
                      "to plain; " + ", ".join(
                          f"T={t} {row[f'{name} T{t} B{m}']:.4f}"
                          for t in fused_gjk.TEAMS)
                      + f" ms; rule T={row['rule'][name]} [{card}]",
                      flush=True)
    print(f"K8 c2: {row['restarted']} pairs restarted, mean iters "
          f"{row['mean_iters']:.3f}, max {row['max_iters']} [{card}]",
          flush=True)
    print(json.dumps({"k8_teams": row, "card": card}), flush=True)


# -- k7 ------------------------------------------------------------------------

K7_WARPS = (1, 2, 4)


def k7(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    cfg = GJKEPAConfig.for_f32()
    builds = variants(cs, "epa_shapes.cu", {w: {"K7_WARPS": w}
                                            for w in K7_WARPS})
    rng = np.random.default_rng(3)
    cases = (("c3", fixtures.c3_pairs(0, cs.C3)),
             ("dense cylinders 16384", (
                 fixtures.kind_batch(3, 16384, rng, spread=0.2),
                 fixtures.kind_batch(3, 16384, rng, spread=0.2))))
    table = []
    for what, pairs in cases:
        _, _, sa, sb, retired = cs.shape_inputs(pairs, dev)
        g = fs.gjk_shapes(sa, sb, retired, cfg)
        order, n_act = hit_first_order(g.hit & ~g.final)
        args = (sa, sb, g.simplex, g.status, g.cf_depth, g.cf_normal, order,
                n_act, fs.shape_stages(cfg))
        want = fs.epa_shapes_plain(*args)
        lanes = want.iters > 0
        row = {"case": what, "hits": int(n_act),
               "mean_epa_iters": float(want.iters[lanes].float().mean())}
        for w, ns in builds.items():
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                got = fs.epa_shapes(*args)
                torch.cuda.synchronize()
                if not rows_equal(got, want):
                    raise AssertionError(f"K7 at W={w} differs from plain at "
                                         f"{what}")
                row[f"W{w}"] = cs.device_ms(lambda: fs.epa_shapes(*args))
        table.append(row)
        print(f"K7 {what}: {row['hits']} hits, mean epa_iters "
              f"{row['mean_epa_iters']:.3f}; every W bit-equal to plain; "
              + ", ".join(f"W={w} {row[f'W{w}']:.4f}" for w in K7_WARPS)
              + f" ms [{card}]", flush=True)
    print(json.dumps({"k7_warps": table, "card": card}), flush=True)


# -- k9 ------------------------------------------------------------------------

def _mixed_rows(dev, pairs):
    """The K9 inputs of chip_smoke.py phase 12 from numpy (hulls, shapes):
    hulls, shape rows, the retirement and its active-first order."""
    from gjkepa_tpu_torch import GJKEPAConfig, ShapeBatch
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    hulls, shapes = pairs
    (p1,) = on_card(dev, hulls)
    sb = ShapeBatch.from_numpy(*shapes, device=dev).packed()
    env = fh.hull_shape_retirement(p1, sb, GJKEPAConfig.for_f32())
    order, _ = hit_first_order(~env.retired)
    return p1, sb, env.retired, order


def k9(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_gjk
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    cfg = GJKEPAConfig.for_f32()
    cases = (("c3b", fixtures.c3b_pairs()),
             ("4096 x 256", fixtures.hull_kind_pairs(2, 4096, 256)),
             ("4096 x 1024", fixtures.hull_kind_pairs(3, 4096, 1024)))
    table = []
    for what, pairs in cases:
        p1, sb, retired, order = _mixed_rows(dev, pairs)
        n = p1.shape[1]
        want = fh.gjk_hull_shape_plain(p1, sb, retired, order, cfg)
        ran = want.status != 0
        it = want.iters[ran].float()
        row = {"case": what, "pairs": p1.shape[0], "vertices": n,
               "gjk_lanes": int(ran.sum()), "mean_iters": float(it.mean()),
               "p99_iters": float(torch.quantile(it, 0.99)),
               "max_iters": int(it.max()), "rule": fh.team_size(n)}
        for t in fused_gjk.TEAMS:
            def fn(t=t, p1=p1, sb=sb, retired=retired, order=order):
                return fh._gjk_hull_shape_cuda(p1, sb, retired, order, cfg, t)
            got = fn()
            torch.cuda.synchronize()
            if not rows_equal(got, want, ran):
                raise AssertionError(f"K9 at a team of {t} differs from plain "
                                     f"at {what}")
            row[f"T{t}"] = cs.device_ms(fn)
        row["fastest"] = min(fused_gjk.TEAMS, key=lambda t: row[f"T{t}"])
        if what == "c3b":
            # the same pairs without the longest GJK chains
            keep = ~(ran & (want.iters > row["p99_iters"]))
            q1, qs, qr = (x[keep].contiguous() for x in (p1, sb, retired))
            qo, _ = hit_first_order(~qr)
            row["rule_without_p99_tail"] = cs.device_ms(
                lambda: fh._gjk_hull_shape_cuda(q1, qs, qr, qo, cfg))
            row["rule_caller_order"] = cs.device_ms(
                lambda: fh._gjk_hull_shape_cuda(
                    p1, sb, retired, torch.arange(p1.shape[0],
                                                  dtype=torch.int32,
                                                  device=dev), cfg))
        table.append(row)
        print(f"K9 {what}: {row['gjk_lanes']} GJK lanes, iters mean "
              f"{row['mean_iters']:.3f}, p99 {row['p99_iters']:.0f}, max "
              f"{row['max_iters']}; every team bit-equal to plain; "
              + ", ".join(f"T={t} {row[f'T{t}']:.4f}" for t in fused_gjk.TEAMS)
              + f" ms; fastest T={row['fastest']}, rule T={row['rule']}"
              + (f"; rule without the pairs above p99 "
                 f"{row['rule_without_p99_tail']:.4f} ms, in the caller's "
                 f"order {row['rule_caller_order']:.4f} ms"
                 if what == "c3b" else "") + f" [{card}]", flush=True)
        del p1, sb, retired, order, want
        torch.cuda.empty_cache()
    print(json.dumps({"k9_teams": table, "card": card}), flush=True)


# -- k10 -----------------------------------------------------------------------

K10_WARPS = (1, 2, 4)


def k10(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    cfg = GJKEPAConfig.for_f32()
    builds = variants(cs, "epa_hull_shape.cu", {w: {"K10_WARPS": w}
                                                for w in K10_WARPS})
    cases = (("c3b", fixtures.c3b_pairs()),
             ("dense 16384 x 24", fixtures.hull_kind_pairs(1, 16384, 24,
                                                           0.2)))
    table = []
    for what, pairs in cases:
        p1, sb, retired, order = _mixed_rows(dev, pairs)
        g = fh.gjk_hull_shape_plain(p1, sb, retired, order, cfg)
        o10, n10 = hit_first_order(g.hit)
        args = (p1, sb, g.simplex, g.status, o10, n10, fs.shape_stages(cfg))
        want = fh.epa_hull_shape_plain(*args)
        lanes = want.iters > 0
        row = {"case": what, "hits": int(n10),
               "mean_epa_iters": float(want.iters[lanes].float().mean())}
        for w, ns in builds.items():
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                got = fh.epa_hull_shape(*args)
                torch.cuda.synchronize()
                if not rows_equal(got, want):
                    raise AssertionError(f"K10 at W={w} differs from plain "
                                         f"at {what}")
                row[f"W{w}"] = cs.device_ms(lambda: fh.epa_hull_shape(*args))
        table.append(row)
        print(f"K10 {what}: {row['hits']} hits, mean epa_iters "
              f"{row['mean_epa_iters']:.3f}; every W bit-equal to plain; "
              + ", ".join(f"W={w} {row[f'W{w}']:.4f}" for w in K10_WARPS)
              + f" ms [{card}]", flush=True)
    print(json.dumps({"k10_warps": table, "card": card}), flush=True)


# -- k5 ------------------------------------------------------------------------

# A kernel that moves K5's bytes in K5's layout and computes nothing: a
# thread a pair reads both 64-byte rows as float4 words and the retirement
# bit, and writes every output, the normal as three 4-byte stores 12 bytes
# apart.  Its time is the floor this card reaches for K5's traffic.
K5_COPY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void k5_copy_kernel(const float4* sa, const float4* sb, const bool* retired,
                               bool* hit, int* status, float* depth, float* normal,
                               float* dist, bool* act, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float s = 0.0f;
  for (int k = 0; k < 4; ++k) {
    const float4 a = sa[4 * i + k], b = sb[4 * i + k];
    s += a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
  }
  const bool r = retired[i];
  hit[i] = s > 0.0f;
  status[i] = r ? 1 : 0;
  depth[i] = s;
  normal[3 * i] = s;
  normal[3 * i + 1] = -s;
  normal[3 * i + 2] = 2.0f * s;
  dist[i] = 0.5f * s;
  act[i] = !r;
}
extern "C" int k5_copy_launch(const void* sa, const void* sb, const void* retired, void* hit,
                              void* status, void* depth, void* normal, void* dist,
                              void* act, int B, void* stream) {
  k5_copy_kernel<<<(B + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(sa), static_cast<const float4*>(sb),
      static_cast<const bool*>(retired), static_cast<bool*>(hit), static_cast<int*>(status),
      static_cast<float*>(depth), static_cast<float*>(normal), static_cast<float*>(dist),
      static_cast<bool*>(act), B);
  return (int)cudaGetLastError();
}
"""

def _k5_copy(out_dir: Path):
    """K5_COPY_SOURCE built with the port's flags; returns its launcher."""
    import ctypes
    from gjkepa_tpu_torch import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "k5_copy.cu", out_dir / "libk5_copy.so"
    src.write_text(K5_COPY_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).k5_copy_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def k5(cs, dev, card) -> None:
    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    cfg = GJKEPAConfig.for_f32()
    n, q = cs.C3, cs.C3 // 4
    sa, sb, ret = cs.shape_inputs(fixtures.c3_pairs(0, n), dev)[2:]
    *shuf, _ = fixtures.c3_shuffled(0, n)

    def cut(keep):
        return tuple(t[keep].contiguous() for t in (sa, sb, ret))

    idx = torch.arange(n, device=dev)
    # where the shuffled order's cost lies: whole warps of one kind in a
    # random order, and the shuffled pairs sorted by kind in each block of
    # 128 (a deal by branch in each block, done beforehand)
    rng = np.random.default_rng(1)
    warps = (rng.permutation(n // 32)[:, None] * 32
             + np.arange(32)[None]).reshape(-1)
    kinds = shuf[0][0]
    by_block = np.concatenate([
        b + np.argsort(kinds[b:b + 128], kind="stable")
        for b in range(0, n, 128)])
    nat = fixtures.c3_pairs(0, n)
    cases = {"c3": (sa, sb, ret),
             "c3_shuffled": cs.shape_inputs(shuf, dev)[2:],
             "c3_warps_shuffled": cs.shape_inputs(tuple(
                 fixtures.permute(x, warps) for x in nat), dev)[2:],
             "c3_shuffled_sorted_in_blocks": cs.shape_inputs(tuple(
                 fixtures.permute(x, by_block) for x in shuf), dev)[2:],
             "c3_box_quarter": cut((idx >= q) & (idx < 2 * q)),
             "c3_without_box": cut((idx < q) | (idx >= 2 * q)),
             "mixed16": cs.shape_inputs(fixtures.mixed16_pairs(n // 16, 7),
                                        dev)[2:]}
    want = {k: fs.cf_shapes_plain(*c, cfg) for k, c in cases.items()}
    copy = _k5_copy(_build.BUILD_DIR / "sweep")

    def copied():
        out = [torch.empty_like(t) for t in want["c3"]]
        rc = copy(*(_build.ptr(t) for t in (sa, sb, ret, *out)), n,
                  torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"k5_copy launch failed: CUDA error {rc}")

    row = {"copy_floor_c3": cs.device_ms(copied),
           "bound_c3": cs.work(n, 129 + 26, 0)[0]}
    for what, c in cases.items():
        got = fs.cf_shapes(*c, cfg)
        torch.cuda.synchronize()
        if not rows_equal(got, want[what]):
            raise AssertionError(f"K5 differs from plain at {what}")
        row[what] = cs.device_ms(lambda c=c: fs.cf_shapes(*c, cfg))
    print("K5: every case bit-equal to plain; " + ", ".join(
        f"{what} {row[what]:.4f}" for what in cases)
        + f" ms (copy floor at c3 {row['copy_floor_c3']:.4f}, bound "
        f"{row['bound_c3']:.4f}) [{card}]", flush=True)
    print(json.dumps({"k5": row, "card": card}), flush=True)


# -- k6a -----------------------------------------------------------------------

# K6a's block: quads (pairs in flight) a block.
K6A_PAIRS = (8, 16, 32, 64)
ITER_CAPS = (0, 1, 2, 4, 8, 16)     # gjk_max_iters of the chain's slope


def k6a(cs, dev, card) -> None:
    import ctypes

    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops.fused import hit_first_order
    cfg = GJKEPAConfig.for_f32()
    builds = variants(cs, "gjk_shapes.cu", {p: {"K6A_PAIRS": p}
                                           for p in K6A_PAIRS})
    dirs = fs.INIT_DIRS.ctypes.data_as(ctypes.c_void_p)

    def alone(sa, sb, ret, act, c):
        """K6a's kernel through its C entry point, on the compaction of
        ``act`` and rows allocated here, once."""
        order, n_act = hit_first_order(act)
        rows = fs.gjk_sub_shapes(sa, sb, ret, order, n_act, c)
        ptrs = [_build.ptr(t) for t in (sa, sb, ret, order, n_act)]
        outs = [_build.ptr(t) for t in rows]
        return lambda: _build.launch(
            "gjk_sub_shapes", dev, {"gjk_sub_shapes": 0}, *ptrs, dirs,
            *outs, sa.shape[0], *fs.gjk_args(c))

    rng = np.random.default_rng(3)
    *shuf, _ = fixtures.c3_shuffled(0, cs.C3)
    cases = (("c3", fixtures.c3_pairs(0, cs.C3)), ("c3_shuffled", shuf),
             ("mixed16", fixtures.mixed16_pairs(cs.C3 // 64, 7)),
             ("dense_cyl", (fixtures.kind_batch(3, 16381, rng, spread=0.2),
                            fixtures.kind_batch(3, 16381, rng, spread=0.2))),
             ("no_gjk_lanes", fixtures.mixed16_pairs(1, 1)))
    table = []
    for what, pairs in cases:
        sa, sb, ret = cs.shape_inputs(pairs, dev)[2:]
        act = fs.cf_shapes_plain(sa, sb, ret, cfg).act
        if what == "no_gjk_lanes":
            act = torch.zeros_like(act)
        order, n_act = hit_first_order(act)
        want = fs.gjk_sub_shapes_plain(sa, sb, ret, order, n_act, cfg)
        it = want.iters[act].float()
        row = {"case": what, "pairs": sa.shape[0], "gjk_lanes": int(n_act)}
        if int(n_act):
            row.update(mean_iters=float(it.mean()),
                       p99_iters=float(torch.quantile(it, 0.99)),
                       max_iters=int(it.max()))
        for label, ns in builds.items():
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                got = fs.gjk_sub_shapes(sa, sb, ret, order, n_act, cfg)
                torch.cuda.synchronize()
                if not rows_equal(got, want):
                    raise AssertionError(f"K6a at P={label} differs from "
                                         f"plain at {what}")
                row[f"P{label}"] = cs.device_ms(alone(sa, sb, ret, act, cfg))
        row["fastest"] = f"P{min(builds, key=lambda p: row[f'P{p}'])}"
        row["shipped"] = cs.device_ms(
            lambda: fs.gjk_sub_shapes(sa, sb, ret, order, n_act, cfg))
        if what == "c3":
            # the same pairs without the longest GJK chains
            keep = ~(act & (want.iters > row["p99_iters"]))
            q = [t[keep].contiguous() for t in (sa, sb, ret, act)]
            row["shipped_without_p99_tail"] = cs.device_ms(alone(*q, cfg))
        table.append(row)
        print(f"K6a {what}: {row['gjk_lanes']} GJK lanes"
              + (f", iters mean {row['mean_iters']:.3f}, p99 "
                 f"{row['p99_iters']:.0f}, max {row['max_iters']}"
                 if int(n_act) else "")
              + "; every build bit-equal to plain; " + ", ".join(
                  f"P={p} {row[f'P{p}']:.4f}" for p in builds)
              + f" ms (kernel alone); fastest {row['fastest']}; shipped "
              f"wrapper {row['shipped']:.4f} ms"
              + (f", kernel alone without the pairs above p99 "
                 f"{row['shipped_without_p99_tail']:.4f} ms"
                 if what == "c3" else "") + f" [{card}]", flush=True)
    # the chain: K6a (a quad a pair, its kernel alone) and K6b (a thread a
    # pair, over the same GJK lanes and every closed form) at c3 with the
    # iterations capped
    sa, sb, ret = cs.shape_inputs(cases[0][1], dev)[2:]
    act = fs.cf_shapes(sa, sb, ret, cfg).act
    caps = {}
    for cap in ITER_CAPS:
        c = cfg.replace(gjk_max_iters=cap)
        caps[f"k6a_cap{cap}"] = cs.device_ms(alone(sa, sb, ret, act, c))
        caps[f"k6b_cap{cap}"] = cs.device_ms(
            lambda: fs.gjk_shapes(sa, sb, ret, c))
    print("K6a and K6b at c3 by gjk_max_iters: " + ", ".join(
        f"{cap}: {caps[f'k6a_cap{cap}']:.4f} / {caps[f'k6b_cap{cap}']:.4f}"
        for cap in ITER_CAPS) + f" ms [{card}]", flush=True)
    print(json.dumps({"k6a_grid": table, "iteration_caps": caps,
                      "card": card}), flush=True)


# -- k6b -----------------------------------------------------------------------

# K6b's block: (threads, pairs); the quads a block are threads / 4
K6B_BLOCKS = ((128, 128), (64, 64), (128, 64), (128, 32))


def k6b(cs, dev, card, parent: Path | None) -> None:
    import ctypes

    from gjkepa_tpu_torch import GJKEPAConfig, _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    cfg = GJKEPAConfig.for_f32()
    specs = {f"T{t}P{p}": {"K6B_THREADS": t, "K6B_PAIRS": p}
             for t, p in K6B_BLOCKS}
    csrc = {}
    if parent is not None:
        specs["parent"] = {}
        csrc["parent"] = parent.resolve() / "gjkepa_tpu_torch" / "csrc"
    builds = variants(cs, "gjk_shapes.cu", specs, csrc)
    labels = list(builds)
    if parent is not None:          # parent, builds, builds reversed, parent
        labels = ["parent"] + [x for x in labels if x != "parent"]
    turns = labels + labels[::-1]
    dirs = fs.INIT_DIRS.ctypes.data_as(ctypes.c_void_p)

    def alone(ns, sa, sb, ret, rows, c):
        """K6b's kernel of build ``ns`` through its C entry point, on rows
        allocated beforehand."""
        ptrs = [_build.ptr(t) for t in (sa, sb, ret)]
        outs = [_build.ptr(t) for t in rows]
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

        def fn():
            rc = ns.gjk_shapes_launch(*ptrs, dirs, *outs, sa.shape[0],
                                      *fs.gjk_args(c), stream)
            if rc != 0:
                raise RuntimeError(f"gjk_shapes launch failed: CUDA error {rc}")
        return fn

    rng = np.random.default_rng(3)
    *shuf, _ = fixtures.c3_shuffled(0, cs.C3)
    cases = (("c3", fixtures.c3_pairs(0, cs.C3)), ("c3_shuffled", shuf),
             ("mixed16", fixtures.mixed16_pairs(cs.C3 // 64, 7)),
             ("dense_cyl", (fixtures.kind_batch(3, 16381, rng, spread=0.2),
                            fixtures.kind_batch(3, 16381, rng, spread=0.2))))
    table = []
    for what, pairs in cases:
        sa, sb, ret = cs.shape_inputs(pairs, dev)[2:]
        act = fs.cf_shapes_plain(sa, sb, ret, cfg).act
        want = fs.gjk_shapes_plain(sa, sb, ret, cfg)
        it = want.iters[act].float()
        row = {"case": what, "pairs": sa.shape[0], "gjk_lanes": cs.isum(act),
               "mean_iters": float(it.mean()),
               "p99_iters": float(torch.quantile(it, 0.99)),
               "max_iters": int(it.max())}
        fns = {}
        for label, ns in builds.items():
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                got = fs.gjk_shapes(sa, sb, ret, cfg)
            torch.cuda.synchronize()
            if not (rows_equal(got, want, act) and all(
                    torch.equal(x, y) for x, y in zip(got[5:], want[5:]))):
                raise AssertionError(f"K6b {label} differs from plain at "
                                     f"{what}")
            fns[label] = alone(ns, sa, sb, ret, got, cfg)
        for k, label in enumerate(turns):
            row[f"{label}_{k}"] = cs.device_ms(fns[label])
        table.append(row)
        print(f"K6b {what}: {row['gjk_lanes']} GJK lanes, iters mean "
              f"{row['mean_iters']:.3f}, p99 {row['p99_iters']:.0f}, max "
              f"{row['max_iters']}; every build bit-equal to plain; "
              + ", ".join(f"{label} {row[f'{label}_{k}']:.4f}"
                          for k, label in enumerate(turns))
              + f" ms (kernel alone) [{card}]", flush=True)
    sa, sb, ret = cs.shape_inputs(cases[0][1], dev)[2:]
    caps = {}
    for cap in ITER_CAPS:
        c = cfg.replace(gjk_max_iters=cap)
        for label, ns in builds.items():
            with mock.patch.object(_build, "load", lambda ns=ns: ns):
                rows = fs.gjk_shapes(sa, sb, ret, c)
            caps[f"{label}_cap{cap}"] = cs.device_ms(
                alone(ns, sa, sb, ret, rows, c))
    print("K6b at c3 by gjk_max_iters: " + ", ".join(
        f"{cap}: " + " / ".join(f"{label} {caps[f'{label}_cap{cap}']:.4f}"
                                for label in builds) for cap in ITER_CAPS)
        + f" ms [{card}]", flush=True)
    print(json.dumps({"k6b_grid": table, "iteration_caps": caps,
                      "card": card}), flush=True)


# -- times ---------------------------------------------------------------------

def times(cs, dev, card, tag) -> None:
    import ctypes

    import gjkepa_tpu_torch as gt
    from gjkepa_tpu_torch import _build
    from gjkepa_tpu_torch.models import fixtures
    from gjkepa_tpu_torch.ops import fused_distance as fd
    from gjkepa_tpu_torch.ops import fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
    from gjkepa_tpu_torch.ops import fused_shapes as fs
    from gjkepa_tpu_torch.ops import fused_streamed as fst
    from gjkepa_tpu_torch.ops.fused import cascade_plan, hit_first_order
    cfg = gt.GJKEPAConfig.for_f32()
    bool_cfg = cfg.replace(epa_max_iters=0)
    stages = cascade_plan(cfg)

    def on_dev(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    rng = np.random.default_rng(0)                   # chip_smoke.py phase 5
    m1, m2 = on_dev(*cs.deep_pairs(rng, 16384, 24))
    b1, b2 = on_dev(cs.random_hulls(rng, 65536, 64),
                    cs.random_hulls(rng, 65536, 64))
    g4 = fused_gjk.gjk_hulls(m1, m2, cfg)
    o4, n4 = hit_first_order(g4.hit)
    _, _, sa3, sb3, ret3 = cs.shape_inputs(fixtures.c3_pairs(0, cs.C3), dev)
    *shuf, _ = fixtures.c3_shuffled(0, cs.C3)
    _, _, sa3s, sb3s, ret3s = cs.shape_inputs(shuf, dev)
    c5 = fs.cf_shapes(sa3, sb3, ret3, cfg)           # chip_smoke.py phase 10
    o6, n6 = hit_first_order(c5.act)
    # the kernels alone through their C entry points on rows allocated
    # once (older wrappers fill rows on every call)
    k6a_in = (sa3, sb3, ret3, o6, n6)
    g6 = fs.gjk_sub_shapes(*k6a_in, cfg)
    g6b = fs.gjk_shapes(sa3, sb3, ret3, cfg)
    g6bs = fs.gjk_shapes(sa3s, sb3s, ret3s, cfg)
    dirs = fused_gjk.INIT_DIRS.ctypes.data_as(ctypes.c_void_p)

    def kernel_alone(name, ins, outs):
        rc = getattr(_build.load(), f"{name}_launch")(
            *(_build.ptr(t) for t in ins), dirs, *(_build.ptr(t) for t in outs),
            cs.C3, *fs.gjk_args(cfg),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    o7, n7 = hit_first_order(g6.hit)
    k7 = (sa3, sb3, g6.simplex, torch.where(c5.act, g6.status, c5.status),
          c5.depth, c5.normal, o7, n7, fs.shape_stages(cfg))
    hulls, shp = fixtures.c3b_pairs()                # chip_smoke.py phase 13
    (h3,) = on_dev(hulls)
    s3 = gt.ShapeBatch.from_numpy(*shp, device=dev)
    sb = s3.packed()
    env = fh.hull_shape_retirement(h3, sb, cfg)
    o9, _ = hit_first_order(~env.retired)
    g9 = fh.gjk_hull_shape_plain(h3, sb, env.retired, o9, cfg)
    o10, n10 = hit_first_order(g9.hit)
    k10 = (h3, sb, g9.simplex, g9.status, o10, n10, fs.shape_stages(cfg))
    d1, d2 = on_dev(*fixtures.c2_hulls())            # chip_smoke.py phase 13
    low = fd.distance_hulls(d1, d2, cfg, 10)
    o8, n8 = hit_first_order(~low.converged)
    rows8 = fd.DistanceRows(*(t.clone() for t in low))
    a3, b3 = cs.shape_inputs(fixtures.c3_pairs(0, cs.C3), dev)[:2]
    fns = {
        "k5_c3": lambda: fs.cf_shapes(sa3, sb3, ret3, cfg),
        "k5_c3_shuffled": lambda: fs.cf_shapes(sa3s, sb3s, ret3s, cfg),
        "k6a_c3": lambda: fs.gjk_sub_shapes(*k6a_in, cfg),
        "k6a_c3_kernel": lambda: kernel_alone("gjk_sub_shapes", k6a_in, g6),
        "k6b_c3": lambda: fs.gjk_shapes(sa3, sb3, ret3, cfg),
        "k6b_c3_kernel": lambda: kernel_alone("gjk_shapes", (sa3, sb3, ret3),
                                              g6b),
        "k6b_c3_shuffled_kernel": lambda: kernel_alone(
            "gjk_shapes", (sa3s, sb3s, ret3s), g6bs),
        "k1_c4": lambda: fused_gjk.gjk_hulls(m1, m2, cfg),
        "k1_c2": lambda: fused_gjk.gjk_hulls(b1, b2, bool_cfg),
        "k2_c4": lambda: fused_epa.epa_cascade(m1, m2, g4.simplex, g4.status,
                                               o4, n4, stages),
        "k7_c3": lambda: fs.epa_shapes(*k7),
        "k8_phase1_c2": lambda: fd.distance_hulls(d1, d2, cfg, 10),
        "k8_phase2_c2": lambda: fd.distance_hulls(d1, d2, cfg, 64, o8, n8,
                                                  out=rows8),
        "k8_one_pass_c2": lambda: fd.distance_hulls(d1, d2, cfg, 64),
        "k9_c3b": lambda: fh.gjk_hull_shape(h3, sb, env.retired, o9, cfg),
        "k10_c3b": lambda: fh.epa_hull_shape(*k10),
    }
    walls = {
        "path_c4": lambda: gt.gjkepa_batch_fused(m1, m2, cfg=cfg),
        "query_c4": lambda: gt.fused_gjkepa_hulls(m1, m2, cfg=cfg),
        "path_c2": lambda: gt.fused_gjkepa_hulls(b1, b2, cfg=bool_cfg),
        "path_dist_c2": lambda: gt.fused_gjk_distance_hulls(d1, d2, cfg=cfg),
        "path_dist_c2_one_pass": lambda: gt.fused_gjk_distance_hulls(
            d1, d2, cfg=cfg, two_phase=False),
        "path_c3": lambda: gt.fused_gjkepa_shapes(a3, b3, cfg=cfg),
        "path_c3b": lambda: gt.fused_gjkepa_hull_shapes(h3, s3, cfg=cfg),
    }
    for key, pair in (("2600", fixtures.big_c2_pairs()),        # phase 15
                      ("8192", fixtures.big_pairs_8192())):
        p1, p2 = on_dev(*pair)
        a = fst.streamed_broadphase(p1, p2, cfg.broadphase_tol)
        g = fst.gjk_hulls_big(p1, p2, a, cfg)
        o, n = hit_first_order(g.hit)
        fns[f"k12_{key}"] = (lambda p1=p1, p2=p2, a=a:
                             fst.gjk_hulls_big(p1, p2, a, cfg))
        fns[f"k13_{key}"] = (lambda p1=p1, p2=p2, g=g, o=o, n=n:
                             fst.epa_hulls_big(p1, p2, g.simplex, g.status, o,
                                               n, stages))
        walls[f"query_{key}"] = (lambda p1=p1, p2=p2:
                                 gt.fused_gjkepa_hulls(p1, p2, cfg=cfg))
        walls[f"query_{key}_boolean"] = (
            lambda p1=p1, p2=p2: gt.fused_gjkepa_hulls(p1, p2, cfg=bool_cfg))
        if key == "8192":
            walls["path_8192"] = (lambda p1=p1, p2=p2:
                                  gt.gjkepa_batch_fused(p1, p2, cfg=cfg))
    out = {"tag": tag, "root": str(Path(gt.__file__).parents[1]),
           "card": card}
    for key, fn in fns.items():
        out[key] = cs.device_ms(fn)
        out[key + "_one_call"] = cs.cuda_ms(fn)
    for key, fn in walls.items():
        out[key] = cs.cuda_ms(fn)
    from gjkepa_tpu_torch.profile import kernel_launches
    out["launches_c3"] = kernel_launches(walls["path_c3"])
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("teams", "k1", "warps", "k2", "k12", "k8",
                                     "k7", "k9", "k10", "k5", "k6a", "k6b",
                                     "times"))
    ap.add_argument("--root", type=Path, default=None,
                    help="another checkout: the package `times` imports, "
                    "the parent whose K6b `k6b` builds")
    ap.add_argument("--tag", default="change")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    root = a.root if a.what == "times" and a.root is not None else ROOT
    sys.path.insert(0, str(root.resolve()))
    cs = _chip_smoke()
    dev, card = torch.device("cuda", 0), card_name()
    {"teams": teams, "k1": k1, "warps": warps, "k2": k2, "k12": k12, "k8": k8,
     "k7": k7, "k9": k9, "k10": k10, "k5": k5, "k6a": k6a,
     "k6b": lambda *x: k6b(*x, a.root),
     "times": lambda *x: times(*x, a.tag)}[a.what](cs, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
