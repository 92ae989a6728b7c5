"""Host time of one call: the benchmark's span from entering the query to
its return (the enqueue), the median over the calls of the measured window
of a traced run, taken with the profiler off."""

import statistics


def read(view):
    if not view.host_s:
        return None
    return statistics.median(view.host_s) * 1e3
