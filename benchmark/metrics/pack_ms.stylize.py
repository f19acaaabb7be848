"""Mean host time to pack a frame into its pinned ring slot (the C++
space-to-depth pack, or the plain copy): the program's `stream.pack` span,
over the frames submitted inside the traced window."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "stream pipeline", "frame_latency_p95_ms"


def read(run):
    return program_spans.mean_ms(run, "stream.pack")
