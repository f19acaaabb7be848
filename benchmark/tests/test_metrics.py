"""Each metric's arithmetic on a synthetic run and trace, and each reader
against its entry in BENCHMARK.json."""

import json
import math

import pytest

from benchmark import flops
from benchmark.harness import Context, Record, Run
from benchmark.spec import Bench
from benchmark.trace import Spans, TraceData

MS = 1_000_000  # ns


def _run(bench, cell_name, trace=None, counters=None, spans=None, window_s=2.0, latencies=(), kind="NVIDIA H100 80GB HBM3"):
    cell = bench.cell(cell_name)
    ctx = Context(bench, cell, bench.config(cell["config"]), bench.traffic(cell["traffic"]), 0, window_s, True, None,
                  0.0)
    record = Record(7.5, window_s, 0, 0, counters or {}, {}, 0, spans or Spans(), trace, list(latencies))
    return Run(ctx, record, kind)


def _trace(kernels, submits, name="bench.submit"):
    """A 100 ms window; kernels as (name, start_ms, end_ms)."""
    return TraceData(0, 100 * MS, [(n, int(s * MS), int(e * MS)) for n, s, e in kernels],
                     [("bench.window", 0, 100 * MS)] + [(name, int(s * MS), int((s + 1) * MS)) for s in submits])


def test_readers_match_benchmark_json():
    bench = Bench()
    for m in bench.spec["end_to_end"] + bench.spec["per_layer"]:
        reader = bench.reader(m["name"])
        assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (m["unit"], m["better"], m["source"]), m["name"]
        if m in bench.spec["per_layer"]:
            assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"]), m["name"]


def test_end_to_end_readers():
    bench = Bench()
    spans = Spans()
    run = _run(bench, "stylize_4k_d4", counters={"frames": 50}, latencies=[i / 1000 for i in range(1, 101)])
    assert bench.reader("frames_per_s").read(run) == 25.0
    assert math.isclose(bench.reader("frame_latency_p95_ms").read(run), 95.05)
    assert bench.reader("setup_s").read(run) == 7.5
    assert bench.reader("train_images_per_s").read(run) is None
    run = _run(bench, "train_b16_256", counters={"steps": 20, "images": 320}, spans=spans)
    assert bench.reader("train_images_per_s").read(run) == 160.0
    assert bench.reader("frames_per_s").read(run) is None


def test_busy_union_idle_and_gaps():
    trace = _trace([("conv_a", 0, 10), ("elementwise_kernel", 5, 20), ("conv_b", 30, 40), ("conv_c", 95, 120)],
                   submits=[22, 50])
    assert trace.busy_s() == pytest.approx(0.035)  # [0, 20] + [30, 40] + [95, 100]
    # the gaps' midpoints (25, 67.5 ms) lie in no submit (22-23, 50-51 ms)
    assert trace.idle_by_host_span() == {"bench.window": pytest.approx(0.065)}
    trace = _trace([("conv_a", 0, 10)], submits=[50])
    trace.host_spans.append(("bench.fetch", 10 * MS, 100 * MS))
    assert trace.idle_by_host_span() == {"bench.fetch": pytest.approx(0.09)}
    bench = Bench()
    run = _run(bench, "stylize_4k_d4", trace=trace)
    assert bench.reader("device_idle.stylize").read(run) == pytest.approx(90.0)


def test_stylize_layer_readers():
    bench = Bench()
    kernels = [("void cudnn::conv_fprop", 0, 30), ("void at::native::reduce_kernel<var_mean>", 30, 50),
               ("Memcpy HtoD (Pinned -> Device)", 50, 52), ("unknown_kernel", 52, 60)]
    run = _run(bench, "stylize_4k_d4", trace=_trace(kernels, submits=[0, 40]))
    cfg, tr = run.config, run.traffic
    peaks = json.loads((bench.dir / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
    least = sum(c.least_s(peaks["bfloat16_flops"], peaks["hbm_bytes_per_s"])
                for c in flops.stylize_convs(cfg["model"], tr["height"], tr["width"], 2))
    assert bench.reader("conv_roofline.stylize").read(run) == pytest.approx(100 * least * 2 / 0.030)
    assert bench.reader("nonconv_ms_per_frame.stylize").read(run) == pytest.approx(30.0 / 2)
    per_frame = flops.stylize_frame_flops(cfg["model"], tr["height"], tr["width"])
    assert bench.reader("frame_mfu.stylize").read(run) == pytest.approx(100 * per_frame * 2 / 0.1 / 989e12)
    spans = Spans()
    spans.seconds["bench.submit"] = [0.001, 0.003]
    assert bench.reader("submit_ms.stylize").read(_run(bench, "stylize_4k_d4", spans=spans)) == pytest.approx(2.0)
    # no trace, or a device the peak table does not know: nothing to read
    assert bench.reader("conv_roofline.stylize").read(_run(bench, "stylize_4k_d4")) is None
    assert bench.reader("frame_mfu.stylize").read(_run(bench, "stylize_4k_d4", trace=run.trace, kind="cpu")) is None


def test_train_layer_readers():
    bench = Bench()
    kernels = [("sm80_xmma_fprop_implicit_gemm_f32f32", 0, 40), ("wgrad_strip_kernel", 40, 45),
               ("void cudnn::detail::wgrad_alg0_engine", 45, 50), ("multi_tensor_apply_kernel<adam>", 50, 51)]
    run = _run(bench, "train_b16_256", trace=_trace(kernels, submits=[10, 60], name="bench.step"))
    cfg, tr = run.config, run.traffic
    convs = flops.train_convs(cfg, tr["batch_size"], *cfg["preprocess_size"])
    assert sum(c.by_kernel for c in convs) == 6  # 9x9 x2, the two s2 3x3s, the two phase convs
    peak, bw = 165e12, 3.35e12
    cudnn = sum(c.least_s(peak, bw) for c in convs if not c.by_kernel)
    kernel = sum(c.least_s(peak, bw) for c in convs if c.by_kernel)
    assert bench.reader("conv_roofline.train").read(run) == pytest.approx(100 * cudnn * 2 / 0.045)
    assert bench.reader("conv_wgrad_roofline.train").read(run) == pytest.approx(100 * kernel * 2 / 0.005)
    step = flops.train_step_flops(cfg, tr["batch_size"], *cfg["preprocess_size"])
    assert bench.reader("step_mfu.train").read(run) == pytest.approx(100 * step * 2 / 0.1 / peak)
    spans = Spans()
    spans.seconds["bench.batch_wait"] = [0.0005, 0.0015]
    assert bench.reader("batch_wait_ms.train").read(_run(bench, "train_b16_256", spans=spans)) == pytest.approx(1.0)
    assert bench.reader("device_idle.train").read(run) == pytest.approx(49.0)
