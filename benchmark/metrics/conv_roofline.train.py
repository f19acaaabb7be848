"""The least time of a traced step's convolutions that cuDNN runs (forward,
data gradients as forward convs, the weight gradients that conv_wgrad does
not run; VGG16's forward and data gradients) over the device time of the
kernels that the `conv` table names."""

from benchmark import flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "train_images_per_s"


def read(run):
    peaks, trace = run.peaks(), run.trace
    if peaks is None or trace is None:
        return None
    steps = trace.count_spans("bench.step")
    conv_s = trace.seconds_by_family(run.family).get("conv", 0.0)
    if not steps or not conv_s:
        return None
    size = run.config["preprocess_size"]
    peak = peaks[run.config["precision"] + "_flops"]
    convs = flops.train_convs(run.config, run.traffic["batch_size"], *size)
    least = sum(c.least_s(peak, peaks["hbm_bytes_per_s"]) for c in convs if not c.by_kernel)
    return 100.0 * least * steps / conv_s
