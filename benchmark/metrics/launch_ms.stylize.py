"""Mean host time to enqueue a frame's upload, forward and download and
record its event: the program's `stream.launch` span, over the frames
submitted inside the traced window."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "stylizer and transform net", "frames_per_s"


def read(run):
    return program_spans.mean_ms(run, "stream.launch")
