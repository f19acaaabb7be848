"""Mean host time a submitted frame waited for its ring slot (for the
slot's previous frame to leave both its pinned buffers): the program's
`stream.slot_wait` span, over the frames submitted inside the traced
window."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER, MOVES = "stream pipeline", "frame_latency_p95_ms"


def read(run):
    return program_spans.mean_ms(run, "stream.slot_wait")
