"""The program's own spans in the traced sub-window, for the readers of
``kernel_host_ms``, ``glue_host_ms`` and ``program_idle_share``.

While a profiler is open the program opens a ``gjkepa.<step>`` host range
(``gjkepa_tpu_torch/spans.py``) around each public entry, each kernel's
dispatcher and each glue step between kernels.  The traced sub-window's
profiler session records them among its host operations, on the clock of
its device operations.  A program without them (an older checkout) gives
none, and the readers then return None.
"""

from __future__ import annotations

import bisect
import re
import statistics
import sys

PREFIX = "gjkepa."
CALL = "bench.call"          # the window's span around one call
KERNEL = re.compile(r"gjkepa\.k\d+[a-z]?")
GLUE = frozenset({"gjkepa.order", "gjkepa.fill", "gjkepa.broadphase",
                  "gjkepa.contact_rows"})
ENTRIES = frozenset(PREFIX + n for n in (
    "fused_gjkepa_hulls", "fused_gjk_distance_hulls", "gjkepa_batch_fused",
    "fused_gjkepa_hull_shapes", "fused_gjkepa_shapes",
    "fused_hulls_streamed"))


def host_ops(view) -> list:
    """The traced sub-window's host operations, (name, start_us, end_us).

    ``trace.View`` has no field for them; ``run.per_layer`` holds them as
    its local ``host_ops`` beside the ``view`` it hands each reader, so
    they are taken from the nearest caller's frame that holds this view.
    A view that carries ``host_ops`` itself (the tests' made-up views)
    gives its own."""
    own = getattr(view, "host_ops", None)
    if own is not None:
        return own
    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if local.get("view") is view and isinstance(local.get("host_ops"),
                                                    list):
            return local["host_ops"]
        frame = frame.f_back
    return []


def program_spans(ops) -> list:
    """The program's spans among host ``ops`` in start order, each as
    [name, start_us, end_us, self_us]: its length less the part the
    program spans nested in it cover."""
    rows = sorted((s, -e, n) for n, s, e in ops if n.startswith(PREFIX))
    out, open_ = [], []
    for start, neg_end, name in rows:
        row = [name, start, -neg_end, -neg_end - start]
        while open_ and open_[-1][2] <= start:
            open_.pop()
        if open_:
            open_[-1][3] -= row[3]
        open_.append(row)
        out.append(row)
    return out


def self_ms_per_call(view, keep) -> float | None:
    """The median over the window's calls of the summed self time of the
    program spans whose names ``keep`` takes, each span given to the
    ``bench.call`` span that contains it; None without program spans."""
    ops = host_ops(view)
    spans = program_spans(ops)
    calls = sorted((s, e) for n, s, e in ops if n == CALL)
    if not spans or not calls:
        return None
    starts = [s for s, _ in calls]
    total = [0.0] * len(calls)
    for name, start, end, self_us in spans:
        i = bisect.bisect_right(starts, start) - 1
        if keep(name) and i >= 0 and end <= calls[i][1]:
            total[i] += self_us
    return statistics.median(total) / 1e3


def overlap_us(a, b) -> float:
    """Length shared by two lists of disjoint sorted (start, end)
    intervals."""
    i = j = 0
    shared = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            shared += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return shared


def merged(intervals) -> list:
    """(start, end) intervals merged into disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]
