"""Of the device's idle time in the traced sub-window (the gaps between
its operations), the share that lies inside the program's public entries
(the union of the ``gjkepa.<entry>`` spans), exact interval overlap, in
%.  None without entry spans, device operations or idle time."""

from benchmark.spans import ENTRIES, host_ops, merged, overlap_us
from benchmark.trace import gaps


def read(view):
    if not view.device_ops:
        return None
    entries = merged((s, e) for n, s, e in host_ops(view) if n in ENTRIES)
    idle = gaps([(s, e) for _, s, e in view.device_ops])
    total = sum(e - s for s, e in idle)
    if not entries or total <= 0:
        return None
    return 100.0 * overlap_us(idle, entries) / total
