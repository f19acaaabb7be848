"""Device-idle time a step that the step's forward overlaps (the
program's `train.forward` span: targets, transform net, VGG16, losses),
per `train.step` span starting inside the traced window."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "train step", "train_images_per_s"


def read(run):
    return program_spans.idle_ms_per(run, "train.forward", "train.step")
