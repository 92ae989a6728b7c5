"""Device time a call spends outside the program's own CUDA kernels: the
framework's kernels, copies and memsets that the dispatch, the hit-first
order and the contact rows launch (the traced sub-window, ms a call)."""


def read(view):
    if not view.device_ops:
        return None
    us = sum(e - s for name, s, e in view.device_ops
             if not view.is_program(name))
    return us / 1e3 / view.calls
