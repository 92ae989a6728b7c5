"""Host time a call spends in the glue between the program's kernels: the
summed self time of its ``gjkepa.order``, ``gjkepa.fill``,
``gjkepa.broadphase`` and ``gjkepa.contact_rows`` spans, the median over
the traced sub-window's calls, in ms (the host twin of
``glue_device_ms``).  None without program spans, and without device
operations, as ``kernel_host_ms``."""

from benchmark.spans import GLUE, self_ms_per_call


def read(view):
    if not view.device_ops:
        return None
    return self_ms_per_call(view, GLUE.__contains__)
