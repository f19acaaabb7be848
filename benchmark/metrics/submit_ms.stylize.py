"""Mean host time of FramePipeline.submit over every frame of the window:
the host pack into the pinned slot and the launches of the upload, the
forward and the download (and the wait for the slot's previous frame)."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "stream pipeline", "frame_latency_p95_ms"


def read(run):
    mean = run.spans.mean("bench.submit")
    return None if mean is None else mean * 1e3
