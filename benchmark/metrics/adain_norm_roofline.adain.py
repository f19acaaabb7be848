"""The content AdaIN's least time for the traced frames, bound by its
bytes (the bf16 relu4_1 features read twice and written once, 6 B an
element) over the device time of the kernels whose name holds
`instance_norm_` (the port's statistics, merge and apply kernels): the
extended kernel pair's share of its roofline. A program without those
kernels reads None."""

from benchmark import adain_flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    peaks, trace = run.peaks(), run.trace
    if peaks is None or trace is None:
        return None
    frames = trace.count_spans("bench.submit")
    kernel_s = sum(s for name, s in trace.seconds_by_name().items() if "instance_norm_" in name)
    if not frames or not kernel_s:
        return None
    least = adain_flops.norm_bytes(run.config["model"], run.traffic["height"], run.traffic["width"])
    return 100.0 * least / peaks["hbm_bytes_per_s"] * frames / kernel_s
