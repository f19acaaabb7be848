"""Device-idle time a step that the step's backward overlaps (the
program's `train.backward` span, which the main thread spends blocked in
autograd), per `train.step` span starting inside the traced window."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "train step", "train_images_per_s"


def read(run):
    return program_spans.idle_ms_per(run, "train.backward", "train.step")
