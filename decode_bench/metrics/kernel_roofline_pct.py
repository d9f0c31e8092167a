"""kernel_roofline_pct: the hand-written kernels' summed least time
(work.py, counted from the profiled pictures' syntax) over their summed
device time in the profiled clip's trace; none when the trace misses a
launch that the wrappers counted, or holds no kernel time."""

from work import least_of


def read(run):
    tr = run.trace
    if tr is None or not tr.whole:
        return None
    device = sum(tr.kernel_s.values())
    least = sum(least_of(run.traced_work()).values())
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device
