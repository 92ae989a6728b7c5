"""The measured window: one caller, a closed loop with batches in flight.

The caller enqueues batch i+1, then waits on batch i's completion event;
a batch's latency runs from the moment the caller enters the query to the
moment it sees that event complete.  The batches cycle through a pool made
at set-up.  The outputs stay on the device: the window keeps references to
the outputs of a few calls, drawn from the seed by reservoir sampling over
every call it makes, for the check after it closes, and copies nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time
from contextlib import nullcontext

import torch


@dataclasses.dataclass
class Run:
    """What one window measured.  Times in seconds."""
    calls: int = 0
    seconds: float = 0.0
    latency: list = dataclasses.field(default_factory=list)
    done_at: list = dataclasses.field(default_factory=list)  # from the start
    host: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)   # (i, slot, out)


class _Now:
    """A completion mark on the CPU, where every call has finished by the
    time it returns."""

    def synchronize(self) -> None:
        pass


def _mark(device: torch.device):
    if device.type != "cuda":
        return _Now()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def run(call, pool, device, in_flight: int, seconds: float | None = None,
        calls: int | None = None, keep: int = 0, seed: int = 0,
        on_call=None, span=None) -> Run:
    """Drive ``call(*pool[i % len(pool)])`` for ``seconds`` (at least
    ``in_flight`` calls; the last batches in flight then drain), for
    ``calls`` calls, or until the first of the two.  ``keep`` outputs are kept, drawn from ``seed``;
    ``on_call(out)`` sees every output; ``span(name)`` gives a context
    around each call and each wait."""
    span = span or (lambda name: nullcontext())
    pick = random.Random(seed)
    r = Run()
    flight = collections.deque()
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds
    t_end = t0
    while True:
        while len(flight) < in_flight and (calls is None or r.calls < calls) \
                and (deadline is None or r.calls < in_flight
                     or time.perf_counter() < deadline):
            slot = r.calls % len(pool)
            t_sub = time.perf_counter()
            with span("bench.call"):
                out = call(*pool[slot])
            t_ret = time.perf_counter()
            flight.append((t_sub, _mark(device)))
            r.host.append(t_ret - t_sub)
            if on_call is not None:
                on_call(out)
            if len(r.kept) < keep:
                r.kept.append((r.calls, slot, out))
            elif keep:
                j = pick.randrange(r.calls + 1)
                if j < keep:
                    r.kept[j] = (r.calls, slot, out)
            r.calls += 1
        if not flight:
            break
        t_sub, done = flight.popleft()
        with span("bench.wait"):
            done.synchronize()
        t_end = time.perf_counter()
        r.latency.append(t_end - t_sub)
        r.done_at.append(t_end - t0)
    r.seconds = t_end - t0
    return r
