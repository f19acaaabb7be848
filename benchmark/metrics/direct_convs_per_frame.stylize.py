"""Convolutions a frame that ran as the port's hand-written direct conv
kernel: the program's `conv.direct` spans over its `stream.submit` spans,
both starting inside the traced window. A program that records neither
reads None."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "convs/frame", "higher", "program_counter"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    direct = len(program_spans.in_window(run.trace, "conv.direct"))
    frames = len(program_spans.in_window(run.trace, "stream.submit"))
    return direct / frames if direct and frames else None
