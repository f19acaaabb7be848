"""The least time of the weight gradients that the port's conv_wgrad kernel
runs in a traced step (float32 as 3xTF32 on the tensor cores) over the
device time of the kernels that the `conv_wgrad` table names."""

from benchmark import flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "conv gradients", "train_images_per_s"


def read(run):
    peaks, trace = run.peaks(), run.trace
    if peaks is None or trace is None:
        return None
    steps = trace.count_spans("bench.step")
    kernel_s = trace.seconds_by_family(run.family).get("conv_wgrad", 0.0)
    if not steps or not kernel_s:
        return None
    size = run.config["preprocess_size"]
    peak = peaks[run.config["precision"] + "_flops"]
    convs = flops.train_convs(run.config, run.traffic["batch_size"], *size)
    least = sum(c.least_s(peak, peaks["hbm_bytes_per_s"]) for c in convs if c.by_kernel)
    return 100.0 * least * steps / kernel_s
