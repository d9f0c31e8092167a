"""device_idle_pct: the share of the profiled clip's wall time in which
no kernel or copy ran on the card; none when the trace misses a launch
that the wrappers counted."""


def read(run):
    tr = run.trace
    if tr is None or not tr.whole or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
