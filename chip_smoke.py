"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

The main path is the fused hull-pair query, ``gjkepa_batch_fused``: K1, the
GJK hull kernel (``gjkepa_tpu_torch/csrc/gjk_hulls.cu``), then K2, the EPA
cascade kernel (``csrc/epa_hulls.cu``), over the hit lanes, then the contact
rows.  The script builds both kernels from the sources in the checkout and
runs, in phases:

  0. environment: card name and power limit, torch and CUDA versions, build;
  1. K1 against its plain PyTorch version on the card (4096 x 64 vertices);
  2. K2 against its plain version (2048 deep pairs x 24 vertices);
  3. known geometry: unit cubes at offsets 0.3, 0.7, 1.2, 2.5;
  4. the float64 reference oracle (tests/oracle_np.py) on 64 deep pairs;
  5. the main path at full size (16384 x 24 deep pairs with full contact,
     65536 x 64 boolean), with the kernels' launch counters; then the
     whole result against the plain path, and each kernel against its
     plain version at these shapes;
  6. timings (CUDA events, median of 7 calls after warm-up), kernel path
     against plain path at the phase-5 sizes.

Every check raises on failure.  It prints one JSON line per kernel before
the last line, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA device
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TIMED_CALLS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def random_hulls(rng, b, n, spread=0.8):
    """bench.py's hull generator (bench.py:112-116)."""
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, n, 1))
    return (v + rng.normal(size=(b, 1, 3)) * spread).astype(np.float32)


def deep_pairs(rng, b, n):
    """bench.py's config-4 recipe (bench.py:278-281): a small hull inside a
    big one, offset a little."""
    big = random_hulls(rng, b, n, spread=0.0) * 2.0
    small = random_hulls(rng, b, n, spread=0.0) * 0.5
    small += rng.normal(size=(b, 1, 3)).astype(np.float32) * 0.2
    return big, small


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    import gjkepa_tpu_torch as gt
    from gjkepa_tpu_torch import _build
    from gjkepa_tpu_torch.ops import contact_rows, fused_epa, fused_gjk
    from gjkepa_tpu_torch.ops.fused import (FusedResult, cascade_plan,
                                            hit_first_order)

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
    log(f"phase 0 build: {_build.library_path().name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    def on_dev(*arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def plain_path(p1, p2, c):
        """fused_gjkepa_hulls through the plain versions."""
        g = fused_gjk.gjk_hulls_plain(p1, p2, c)
        st = cascade_plan(c)
        if not st:
            z = torch.zeros_like(g.sep)
            return FusedResult(g.hit, g.status, z,
                               torch.zeros_like(g.simplex[:, 0]), g.iters,
                               torch.zeros_like(g.iters), g.sep)
        order, n_act = hit_first_order(g.hit)
        e = fused_epa.epa_cascade_plain(p1, p2, g.simplex, g.status, order,
                                        n_act, st)
        return FusedResult(g.hit, e.status, e.depth, e.normal, g.iters,
                           e.iters, g.sep)

    def compare_k1(p1, p2, c, what):
        """K1 against its plain version; returns the sep max abs error."""
        gk = fused_gjk.gjk_hulls(p1, p2, c)
        gp = fused_gjk.gjk_hulls_plain(p1, p2, c)
        torch.cuda.synchronize()
        check(torch.equal(gk.hit, gp.hit), f"{what}: K1 hit differs")
        check(torch.equal(gk.status, gp.status), f"{what}: K1 status differs")
        it_diff = int((gk.iters != gp.iters).sum())
        err = float((gk.sep - gp.sep).abs().max())
        check(it_diff <= 0.005 * len(gk.iters),
              f"{what}: {it_diff} gjk_iters differ")
        check(err <= 1e-5, f"{what}: sep differs by {err}")
        log(f"{what} K1 vs plain, {p1.shape[0]} x {p1.shape[1]}: hit/status "
            f"equal, {int(gk.hit.sum())} hits, gjk_iters differ on {it_diff} "
            f"lanes, sep max abs err {err:.3g} (tol 1e-5)")
        return err

    def compare_k2(p1, p2, what):
        """K2 against its plain version on the same K1 rows; returns the
        max abs error over depth and normal."""
        g = fused_gjk.gjk_hulls(p1, p2, cfg)
        order, n_act = hit_first_order(g.hit)
        ek = fused_epa.epa_cascade(p1, p2, g.simplex, g.status, order, n_act,
                                   stages)
        ep = fused_epa.epa_cascade_plain(p1, p2, g.simplex, g.status, order,
                                         n_act, stages)
        torch.cuda.synchronize()
        check(torch.equal(ek.status, ep.status), f"{what}: K2 status differs")
        depth_err = float((ek.depth - ep.depth).abs().max())
        check(depth_err <= 1e-5, f"{what}: depth differs by {depth_err}")
        dots = (ek.normal * ep.normal).sum(dim=1)[g.hit]
        agree = float((dots > 1.0 - 1e-4).float().mean())
        check(agree >= 0.98, f"{what}: normals agree on {agree:.4f} of hits")
        ei_diff = int((ek.iters != ep.iters).sum())
        check(ei_diff <= 0.01 * len(ek.iters),
              f"{what}: {ei_diff} epa_iters differ")
        log(f"{what} K2 vs plain, {p1.shape[0]} x {p1.shape[1]} deep: status "
            f"equal, {int(g.hit.sum())} hits, depth max abs err "
            f"{depth_err:.3g} (tol 1e-5), normals agree on {agree:.4f} of "
            f"hits, epa_iters differ on {ei_diff} lanes")
        return max(depth_err, float((ek.normal - ep.normal).abs().max()))

    # -- phase 1: K1 vs plain -------------------------------------------------
    bool_cfg = cfg.replace(epa_max_iters=0)
    rng = np.random.default_rng(0)
    k1_err = compare_k1(*on_dev(random_hulls(rng, 4096, 64),
                                random_hulls(rng, 4096, 64)),
                        bool_cfg, "phase 1")

    # -- phase 2: K2 vs plain -------------------------------------------------
    rng = np.random.default_rng(0)
    k2_err = compare_k2(*on_dev(*deep_pairs(rng, 2048, 24)), "phase 2")

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
        "k1_c4": cuda_ms(lambda: fused_gjk.gjk_hulls(m1, m2, cfg)),
        "k1_c4_plain": cuda_ms(lambda: fused_gjk.gjk_hulls_plain(m1, m2, cfg)),
        "k2_c4": cuda_ms(lambda: fused_epa.epa_cascade(
            m1, m2, g4.simplex, g4.status, o4, n4, stages)),
        "k2_c4_plain": cuda_ms(lambda: fused_epa.epa_cascade_plain(
            m1, m2, g4.simplex, g4.status, o4, n4, stages)),
        "k1_c2": cuda_ms(lambda: fused_gjk.gjk_hulls(b1, b2, bool_cfg)),
        "k1_c2_plain": cuda_ms(
            lambda: fused_gjk.gjk_hulls_plain(b1, b2, bool_cfg)),
        "path_c4": cuda_ms(lambda: gt.gjkepa_batch_fused(m1, m2, cfg=cfg)),
        "path_c4_plain": cuda_ms(lambda: gt.derive_contact_batch(
            m1, m2, plain_path(m1, m2, cfg), cfg)),
        "path_c2": cuda_ms(lambda: gt.fused_gjkepa_hulls(b1, b2, cfg=bool_cfg)),
        "path_c2_plain": cuda_ms(lambda: plain_path(b1, b2, bool_cfg)),
    }
    for key, ms in times.items():
        b = 16384 if "c4" in key else 65536
        log(f"phase 6 time {key}: {ms:.4f} ms = {b / ms * 1e3:,.0f} pairs/s "
            f"[{card}]")
    log(f"phase 6 end to end: c4 16384 x 24 full contact "
        f"{16384 / times['path_c4'] * 1e3:,.0f} q/s (plain path "
        f"{16384 / times['path_c4_plain'] * 1e3:,.0f}); c2 65536 x 64 boolean "
        f"{65536 / times['path_c2'] * 1e3:,.0f} q/s (plain path "
        f"{65536 / times['path_c2_plain'] * 1e3:,.0f}) [{card}]")

    kernels = [
        {"name": "gjk_hulls", "route": "cuda",
         "source": "gjkepa_tpu_torch/csrc/gjk_hulls.cu",
         "replaces": "gjkepa_tpu/ops/fused.py:1099",
         "launches": launches["gjk_hulls"], "max_abs_err": k1_err,
         "ms": times["k1_c4"], "plain_ms": times["k1_c4_plain"]},
        {"name": "epa_hulls", "route": "cuda",
         "source": "gjkepa_tpu_torch/csrc/epa_hulls.cu",
         "replaces": "gjkepa_tpu/ops/fused.py:1112",
         "launches": launches["epa_hulls"], "max_abs_err": k2_err,
         "ms": times["k2_c4"], "plain_ms": times["k2_c4_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
