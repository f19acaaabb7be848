"""The 19 AdaIN convolutions' least time for the traced frames (per conv
the larger of FLOPs over bf16's peak and bytes over HBM's, its padded
input and weights read once and its output written once) over the device
time of the kernels that the `conv` table names. The port's edge convs
(`adain_flops`, kind "edge") are no work the model needs: their time is
in the denominator and not in the least time."""

from benchmark import adain_flops

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    peaks, trace = run.peaks(), run.trace
    if peaks is None or trace is None:
        return None
    frames = trace.count_spans("bench.submit")
    conv_s = trace.seconds_by_family(run.family).get("conv", 0.0)
    if not frames or not conv_s:
        return None
    convs = adain_flops.convs(run.config["model"], run.traffic["height"], run.traffic["width"])
    least = sum(c.least_s(peaks["bfloat16_flops"], peaks["hbm_bytes_per_s"]) for c in convs if c.kind == "fwd")
    return 100.0 * least * frames / conv_s
