"""Images of every train step completed in the window over the whole
window, which ends in a synchronize."""

UNIT, BETTER, SOURCE = "images/s", "higher", "host_clock"


def read(run):
    if "images" not in run.counters:
        return None
    return run.counters["images"] / run.record.window_s
