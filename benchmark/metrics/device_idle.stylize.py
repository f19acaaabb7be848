"""Share of the traced window in which no operation ran on the device."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "frames_per_s"


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
