"""Mean decode-thread time a record takes to be parsed, decoded and
resized: the program's `data.decode` span, over the records whose decode
starts inside the traced window."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "input pipeline", "train_images_per_s"


def read(run):
    return program_spans.mean_ms(run, "data.decode")
