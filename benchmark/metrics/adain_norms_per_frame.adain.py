"""Content AdaINs a frame that ran as the port's instance-norm kernel
pair: the program's `adain.norm` spans over its `stream.submit` spans,
both starting inside the traced window. A program that records neither
reads None."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "norms/frame", "higher", "program_counter"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    norms = len(program_spans.in_window(run.trace, "adain.norm"))
    frames = len(program_spans.in_window(run.trace, "stream.submit"))
    return norms / frames if norms and frames else None
