"""K2 (``csrc/epa_hulls.cu``): its device time a call in the traced
sub-window, in ms."""

from benchmark.trace import kernel_pattern

KERNEL = kernel_pattern("epa_hulls_kernel")


def read(view):
    busy = view.device_s(KERNEL)
    if not busy:
        return None
    return busy * 1e3 / view.calls
