"""frame_p95_ms: the 95th percentile, over every picture of the window,
of the time from its access unit's decode() call to its planes read."""

import numpy as np


def read(run):
    lat = [h.latency_s for h in run.window.handed]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
