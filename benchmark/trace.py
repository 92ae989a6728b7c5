"""The traced sub-window and what the per-layer metrics read from it.

A bounded number of calls, pipelined as in the measured window, runs under
``torch.profiler`` (CPU and CUDA activities), read in memory: nothing is
written to disk.  :class:`View` holds what the metric readers
(``benchmark/metrics/<name>.py``) take: the device operations with their
times, the program's kernel names, the host spans of the measured window,
and the least time of each kernel that the query's outputs call for.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from pathlib import Path

import torch

from . import spec, window

TRACED_CALLS = 500      # the traced sub-window: at most this many calls ...
TRACED_SECONDS = 1.0    # ... begun within this many seconds
TOP = 10
SPANS = ("bench.call", "bench.wait")    # the window's own host spans
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def program_kernels(root: Path = spec.ROOT) -> frozenset:
    """Names of the kernels the program builds from its CUDA sources."""
    names = set()
    for path in sorted((root / "gjkepa_tpu_torch" / "csrc").glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def kernel_pattern(name: str) -> re.Pattern:
    """Matches a trace name of kernel ``name`` (a template instance too)."""
    return re.compile(rf"(?<!\w){re.escape(name)}(?!\w)")


@dataclasses.dataclass
class View:
    """What a traced run gives the per-layer metric readers."""
    calls: int                  # calls in the traced sub-window
    device_ops: list            # (name, start_us, end_us), device operations
    window_s: float             # the traced sub-window's length
    busy_s: float               # union of the device operations' intervals
    host_s: list                # host span of each call of the window
    least_s: dict               # kernel name -> summed least seconds
    program_kernels: frozenset

    def __post_init__(self):
        self._program = re.compile("|".join(
            kernel_pattern(k).pattern for k in sorted(self.program_kernels))
            or "(?!)")

    def is_kernel(self, name: str) -> bool:
        return not name.startswith(("Memcpy", "Memset"))

    def device_s(self, pattern: re.Pattern) -> float:
        """Seconds of the device operations whose names match."""
        return sum(e - s for n, s, e in self.device_ops
                   if pattern.search(n)) / 1e6

    def is_program(self, name: str) -> bool:
        """Whether ``name`` is a kernel the program builds."""
        return self._program.search(name) is not None


def union_s(intervals) -> float:
    """Seconds covered by (start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(intervals):
    """The idle stretches between the merged intervals, (start, end) µs."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def short_name(name: str) -> str:
    """A kernel's trace name without its argument list (the last
    parenthesised group), cut to 120 characters."""
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def breakdown(device_ops, host_ops) -> dict:
    """The device operations with the most time, and the idle gaps summed by
    the innermost host operation running at each gap's middle."""
    by_op = {}
    for n, s, e in device_ops:
        key = short_name(n)
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e6
    host_ops = sorted(host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host_ops]
    idle = {}
    for s, e in gaps([(s, e) for _, s, e in device_ops]):
        mid = (s + e) / 2
        label = "no host operation"
        # the covering operation that began last is the innermost
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host_ops[i][2] >= mid:
                label = host_ops[i][0]
                break
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return {"device_ops": [list(kv) for kv in top(by_op)],
            "idle_gaps": [list(kv) for kv in top(idle)]}


def traced(call, pool, device, in_flight: int, work, calls=TRACED_CALLS,
           seconds=TRACED_SECONDS):
    """Run pipelined calls under the profiler (the CUDA activity on a card),
    ``calls`` of them or as many as begin within ``seconds``.  Returns
    (window seconds, device ops, host ops, ``work(out)`` of each call).
    The window drops each output as it goes, so that the trace holds no
    allocation of the benchmark's; a call's work is read from one more call
    on its batch after the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
        lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + [ProfilerActivity.CUDA] * on_card) as prof:
        t0 = time.perf_counter()
        n = window.run(call, pool, device, in_flight, seconds=seconds,
                       calls=calls, span=record_function).calls
        sync()
        seconds = time.perf_counter() - t0
    per_slot = [work(call(*batch)) for batch in pool]
    works = [per_slot[i % len(pool)] for i in range(n)]
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != cuda:
            host_ops.append(row)
        # a span's shadow on the device timeline is no device operation
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in SPANS):
            device_ops.append(row)
    return seconds, device_ops, host_ops, works
