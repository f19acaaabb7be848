"""An AdaIN frame's convolution FLOPs (the encoder on the content and the
decoder, counted from shapes, benchmark/adain_flops.py) times the frames
submitted in the traced window, over that window and bf16's peak."""

from benchmark import adain_flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "stylizer and transform net", "frames_per_s"


def read(run):
    peaks, trace = run.peaks(), run.trace
    if peaks is None or trace is None or trace.window_s <= 0:
        return None
    frames = trace.count_spans("bench.submit")
    if not frames:
        return None
    per_frame = adain_flops.frame_flops(run.config["model"], run.traffic["height"], run.traffic["width"])
    return 100.0 * per_frame * frames / trace.window_s / peaks["bfloat16_flops"]
