"""The 95th percentile, over every frame of the window, of the time from
the frame's submit to its unpacked uint8 result on the host."""

import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    lat = run.record.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
