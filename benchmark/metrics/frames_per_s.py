"""Frames handed back as uint8 on the host, all of them over the whole
window (its drain included)."""

UNIT, BETTER, SOURCE = "frames/s", "higher", "host_clock"


def read(run):
    if "frames" not in run.counters:
        return None
    return run.counters["frames"] / run.record.window_s
