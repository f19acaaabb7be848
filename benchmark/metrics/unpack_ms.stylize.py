"""Mean host time to unpack a fetched frame from its pinned output slot
into an HxWx3 uint8 frame: the program's `stream.unpack` span, over the
frames fetched inside the traced window."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "stream pipeline", "frame_latency_p95_ms"


def read(run):
    return program_spans.mean_ms(run, "stream.unpack")
