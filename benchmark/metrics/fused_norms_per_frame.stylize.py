"""Instance norms a frame that ran as the port's fused kernel pair: the
program's `norm.fused` spans over its `stream.submit` spans, both starting
inside the traced window. A program that records neither reads None."""

from benchmark import program_spans

UNIT, BETTER, SOURCE = "norms/frame", "higher", "program_counter"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    fused = len(program_spans.in_window(run.trace, "norm.fused"))
    frames = len(program_spans.in_window(run.trace, "stream.submit"))
    return fused / frames if fused and frames else None
