"""K1 (``csrc/gjk_hulls.cu``): its least time, from the work the traced calls'
outputs call for (``benchmark/roofline.py``), over its device time in
the trace, in %."""

from benchmark.trace import kernel_pattern

KERNEL = kernel_pattern("gjk_hulls_kernel")


def read(view):
    busy = view.device_s(KERNEL)
    least = view.least_s.get("gjk_hulls")
    if not busy or least is None:
        return None
    return 100.0 * least / busy
