"""The readings the check's limits are set from, on one NVIDIA GPU.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2]

For each seed, in one process: the cell's pool from that seed, a short
window at the cell's own size and load, and the numbers the check reads
from what the window produced (the program's readings).  For each control
seed, the same numbers with the references put in the program's place on
inputs and outputs rounded to bfloat16, the nearest precision below the
configuration's float32 (the control's readings).  A limit lies above the
largest of the program's readings and below the smallest of the control's.
One JSON line a reading, then a summary line; the benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)

    from . import run
    run.use_checkout_caches()

    import torch

    from . import spec, window
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(a.workload)
    device = torch.device("cuda", 0)
    seeds = [int(x) for x in a.seeds.split(",") if x]
    controls = [int(x) for x in a.control_seeds.split(",") if x]
    found = {"program": {}, "control": {}}
    for seed in dict.fromkeys(seeds + controls):
        s = run.Setup(cell, seed, device)
        s.warm()
        w = window.run(s.call, s.pool, device, s.in_flight,
                       seconds=a.seconds,
                       keep=cell.traffic["check"]["kept_calls"], seed=seed)
        sides = ((["program"] if seed in seeds else [])
                 + (["control"] if seed in controls else []))
        for side in sides:
            t0 = time.perf_counter()
            r = s.readings(w.kept, seed, control=side == "control")
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "side": side, "calls": w.calls,
                              "check_s": time.perf_counter() - t0,
                              "readings": r}), flush=True)
            for name, value in r.items():
                found[side].setdefault(name, []).append(value)
        del s, w
        torch.cuda.empty_cache()
    summary = {}
    for name in set(found["program"]) | set(found["control"]):
        prog, ctl = found["program"].get(name, []), found["control"].get(
            name, [])
        summary[name] = {
            "program_max": max(prog, default=math.nan),
            "control_min": min(ctl, default=math.nan)}
    print(json.dumps({"workload": a.workload, "summary": summary,
                      "limits": cell.traffic["check"]["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
