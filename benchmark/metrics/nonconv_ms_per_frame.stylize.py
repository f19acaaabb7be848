"""Device time of every operation outside the `conv` table (instance norm,
relu, pad, upsample, tanh, the uint8 clip, casts and copies) per traced
frame."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    trace = run.trace
    if trace is None:
        return None
    frames = trace.count_spans("bench.submit")
    if not frames:
        return None
    other = sum(s for fam, s in trace.seconds_by_family(run.family).items() if fam != "conv")
    return 1e3 * other / frames
