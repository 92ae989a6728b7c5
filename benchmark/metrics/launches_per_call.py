"""Device kernels a call launches, the program's and the framework's,
counted in the traced sub-window (copies and memsets left out)."""


def read(view):
    n = sum(view.is_kernel(name) for name, _, _ in view.device_ops)
    return n / view.calls if n else None
