"""Share of the traced sub-window in which no operation ran on the device
(1 - the union of the device operations' intervals / the window), in %."""


def read(view):
    if not view.device_ops or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
