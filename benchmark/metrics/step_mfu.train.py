"""A train step's FLOPs (convolutions and Grams, counted from shapes,
benchmark/flops.py) times the steps issued in the traced window, over that
window and the configuration's precision's peak (float32: 3xTF32's 165
TFLOP/s)."""

from benchmark import flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "train step", "train_images_per_s"


def read(run):
    peaks, trace = run.peaks(), run.trace
    if peaks is None or trace is None or trace.window_s <= 0:
        return None
    size = run.config["preprocess_size"]
    per_step = flops.train_step_flops(run.config, run.traffic["batch_size"], *size)
    peak = peaks[run.config["precision"] + "_flops"]
    return 100.0 * per_step * trace.count_spans("bench.step") / trace.window_s / peak
