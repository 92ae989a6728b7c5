"""Run one cell of the benchmark once, on one NVIDIA GPU.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell is an entry of ``BENCHMARK.json``'s
``workloads``: a configuration (``benchmark/configs/``) under a traffic mix
(``benchmark/traffic/``), which names the query it drives
(``benchmark/queries/``).  The run

1. sets up: imports the program (``gjkepa_tpu_torch``; its kernels build
   into its own ``build/`` directory on a checkout's first run), draws the
   cell's pool of batches on the device from ``--seed``, and warms the
   cell's shapes with a few calls; ``setup_s`` runs from the first
   statement here to the first timed call;
2. measures for ``--seconds``: one caller, a closed loop with the
   configuration's batches in flight (``benchmark/window.py``);
3. with ``--trace 1``, runs a short traced sub-window and reads the cell's
   per-layer metrics from it (``benchmark/trace.py``,
   ``benchmark/metrics/``);
4. checks what the window produced against the plain float64 references
   (``benchmark/check.py``, the query's ``readings``), each number beside
   the limit its traffic file states;
5. prints each compared number and its limit as the last lines on standard
   error, and as the last line on standard output one JSON object:
   ``correct``, ``attempted`` (pair queries in the window), ``failed``,
   ``metrics`` (the end-to-end ones, or the per-layer ones with
   ``--trace 1``), ``device``, ``breakdown`` (``--trace 1``) and ``check``.

Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result; it exits 3 and prints no result if the process holds JAX
or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".benchmark_cache"
# top-level module names the process may not hold: JAX, the JAX package,
# and the repository's JAX-side scripts and tests
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gjkepa_tpu", "bench",
                       "chip_smoke", "tests"})
WARM_CALLS = 3


def forbidden(modules) -> list:
    """The names in ``modules`` whose top-level name (before the first dot)
    is forbidden, compared whole: ``gjkepa_tpu_torch`` passes."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def use_checkout_caches() -> None:
    """Point the caches of anything the process compiles (Triton, torch's
    runtime-compiled kernels) at fixed directories in the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
    os.makedirs(CACHE / "torch_kernels", exist_ok=True)


def card_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"power limit not read ({e})"
    return out.strip().splitlines()[0]


class Setup:
    """A cell made ready on ``device``: the query's call, its check
    arguments and the pool of batches drawn from ``seed``.  ``pairs`` and
    ``pool`` replace the configuration's sizes (small runs on the CPU)."""

    def __init__(self, cell, seed: int, device, pairs=None, pool=None):
        import gjkepa_tpu_torch as port

        from . import spec, traffic
        self.cell, self.device = cell, device
        self.query = spec.load_module("queries", cell.traffic["query"],
                                      cell.root)
        cfg = port.GJKEPAConfig(**cell.config["gjkepa_config"])
        self.args = {**cell.traffic.get("query_args", {}),
                     **cell.traffic["check"], "version": cfg.version}
        self.call = self.query.make_call(port, cfg, self.args)
        self.pool = traffic.make_pool(cell.config, cell.traffic, seed, device,
                                      pairs, pool)
        self.pairs = self.pool[0][0].shape[0]
        self.vertices = sum(self.pool[0][i].shape[1] for i in range(2))
        self.in_flight = cell.config["in_flight"]

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, keep: int = 0) -> None:
        """A few calls over the cell's own shapes, the first of which builds
        or loads the kernels, and ``keep`` more; their outputs, held to the
        end, leave the allocator the blocks the window's kept outputs
        take."""
        held = [self.call(*self.pool[i % len(self.pool)])
                for i in range(WARM_CALLS + keep)]
        self.sync()
        del held

    def readings(self, kept, seed: int, control: bool = False) -> dict:
        import numpy as np
        rng = np.random.default_rng(seed % 2 ** 63)
        return self.query.readings(kept, self.pool, self.args, rng, control)


def _p(values, q: float) -> float:
    """The q-quantile of ``values`` (inclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q * 100) - 1]


def end_to_end(s: Setup, run, setup_s: float) -> dict:
    return {"pair_queries_per_s": s.pairs * run.calls / run.seconds,
            "call_p95_ms": _p(run.latency, 0.95) * 1e3,
            "setup_s": setup_s}


def per_layer(s: Setup, run, log, calls: int) -> tuple:
    """The cell's per-layer metrics from a traced sub-window of ``calls``
    calls, the ``device`` entries it adds, and its breakdown."""
    from . import spec, trace
    seconds, dev_ops, host_ops, works = trace.traced(
        s.call, s.pool, s.device, s.in_flight, s.query.work, calls)
    view = trace.View(
        calls=len(works), device_ops=dev_ops, window_s=seconds,
        busy_s=trace.union_s([(a, b) for _, a, b in dev_ops]),
        host_s=run.host, least_s=s.query.least_s(works, s.vertices),
        program_kernels=trace.program_kernels())
    del works
    metrics = {}
    for m in s.cell.per_layer:
        value = spec.load_module("metrics", m["name"], s.cell.root).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"traced sub-window: {view.calls} calls in {seconds:.6f} s, device "
        f"busy {view.busy_s:.6f} s, {len(dev_ops)} device operations; host "
        f"call p50 {_p(run.host, 0.5) * 1e3:.4f} ms, p95 "
        f"{_p(run.host, 0.95) * 1e3:.4f} ms over {len(run.host)} calls")
    for kernel, least in view.least_s.items():
        log(f"least time {kernel}: {least / view.calls * 1e3:.6f} ms a call")
    return (metrics, {"busy_s": view.busy_s, "window_s": seconds},
            trace.breakdown(dev_ops, host_ops))


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log, pairs=None, pool=None, traced_calls=None):
    """Set up, measure, trace (``traced``) and check one cell.  Returns
    (result, check lines).  ``pairs``, ``pool`` and ``traced_calls``
    replace the cell's sizes and the traced calls (small runs on the
    CPU)."""
    import torch

    from . import check, trace, window
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    s = Setup(cell, seed, device, pairs, pool)
    t1 = time.perf_counter()
    s.warm(cell.traffic["check"]["kept_calls"])
    log(f"set-up: {t0 - t_start:.4f} s to the cell, {t1 - t0:.4f} s import "
        f"and pool, {time.perf_counter() - t1:.4f} s warm-up")
    if traced and on_card:      # the first profiler session can lose kernels
        trace.traced(s.call, s.pool, device, s.in_flight, s.query.work,
                     calls=WARM_CALLS)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    run = window.run(s.call, s.pool, device, s.in_flight, seconds=seconds,
                     keep=cell.traffic["check"]["kept_calls"], seed=seed)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    quarters = [sum(1 for t in run.done_at if q * run.seconds / 4 < t
                    <= (q + 1) * run.seconds / 4) for q in range(4)]
    log(f"calls completed in each quarter of the window: {quarters}")
    log(f"{cell.name} seed {seed}: {run.calls} calls of {s.pairs} pairs in "
        f"{run.seconds:.6f} s; latency p50 {_p(run.latency, 0.5) * 1e3:.4f} "
        f"ms, p95 {_p(run.latency, 0.95) * 1e3:.4f} ms; set-up "
        f"{setup_s:.4f} s; peak {peak} bytes")
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    result = {}
    if traced:
        metrics, extra, result["breakdown"] = per_layer(
            s, run, log, traced_calls or trace.TRACED_CALLS)
        info.update(extra)
    else:
        values = end_to_end(s, run, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if on_card:
        log(f"card: {card_power()}")
    readings = s.readings(run.kept, seed)
    correct, numbers = check.judge(readings, cell.traffic["check"]["limits"])
    for name, value in readings.items():
        if name not in numbers:
            log(f"reading {name} = {value} (not compared)")
    lines = [f"check {name} = {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
             for name, c in numbers.items()]
    for c in numbers.values():
        if isinstance(c["value"], float) and math.isnan(c["value"]):
            c["value"] = None
    return ({"correct": correct, "attempted": s.pairs * run.calls,
             "failed": 0, "metrics": metrics, "device": info, **result,
             "check": numbers}, lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    use_checkout_caches()

    import torch

    from . import spec

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{a.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 2
    result, lines = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                             torch.device("cuda", 0), T_START, log)
    held = forbidden(sys.modules)
    if held:
        log(f"the process holds forbidden modules: {held}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
