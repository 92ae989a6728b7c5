"""Host time a call spends in the program's kernel dispatchers: the summed
self time of its ``gjkepa.k*`` spans (checks, output allocation and the
launch), the median over the traced sub-window's calls, in ms.  None
without program spans, and without device operations: on the CPU a
dispatcher's span holds its plain version's computation, not a launch."""

from benchmark.spans import KERNEL, self_ms_per_call


def read(view):
    if not view.device_ops:
        return None
    return self_ms_per_call(view, KERNEL.fullmatch)
