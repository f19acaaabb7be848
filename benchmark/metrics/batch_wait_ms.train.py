"""Mean host time waiting for the next batch from device_prefetch, per step
of the window."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "input pipeline", "train_images_per_s"


def read(run):
    mean = run.spans.mean("bench.batch_wait")
    return None if mean is None else mean * 1e3
