"""The AdaIN cell, found by name from its files and BENCHMARK.json
entries; run whole at a small size on the CPU, correct, and not correct
with a fault planted where its frames are produced; its new readers on a
synthetic trace."""

import shutil
import time

import pytest
import torch

from benchmark.harness import Context, Record, Run, run_cell
from benchmark.spec import Bench
from benchmark.tests.conftest import ROOT
from benchmark.trace import Spans, TraceData

NEW = ["frame_mfu.adain", "conv_roofline.adain", "adain_norm_roofline.adain", "adain_norms_per_frame.adain"]
GENERIC = ["nonconv_ms_per_frame.stylize", "device_idle.stylize", "launch_ms.stylize", "pack_ms.stylize",
           "unpack_ms.stylize"]
SMALL = {"config": {"style_size": 48},
         "traffic": {"height": 64, "width": 96, "pool_frames": 4, "check_frames": 3, "trace_seconds": 0.5,
                     "styles": {"images": ["style_images/candy.jpg", "style_images/starry_night_crop.jpg"],
                                "fields": 2, "field_px": 40, "switch_every": 3,
                                "field_content": {"coarse_px": [8, 32], "mid_px": [2, 8], "texture": [0.0, 40.0],
                                                  "gain": [0.3, 1.0]}}}}


def test_the_new_cells_are_found_by_name():
    bench = Bench()
    cell = bench.cell("adain_4k_d4")
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    assert config["name"] == "adain_vgg19_relu4_1" and config["driver"] == "adain_stream"
    assert traffic["width"] == 3840 and traffic["styles"]["switch_every"] == 24
    assert bench.driver("adain_stream").run is not None
    assert [m["name"] for m in bench.end_to_end(cell)] == ["frames_per_s", "frame_latency_p95_ms", "setup_s"]
    per_layer = [m["name"] for m in bench.per_layer(cell)]
    assert set(per_layer) == set(NEW + GENERIC)
    for name in per_layer:
        assert bench.reader(name).read is not None


@pytest.fixture
def adain_copy(tmp_path):
    """The benchmark and the style images in a temporary checkout."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copytree(ROOT / "style_images", tmp_path / "style_images")
    return Bench(tmp_path)


def _run(bench, trace=False):
    return run_cell(bench, "adain_4k_d4", 2**31 + 77, 0.5, trace, "cpu", time.perf_counter(), SMALL)[1]


def test_a_small_run_is_correct(adain_copy, one_thread):
    line = _run(adain_copy, trace=True)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"frame_mae_max", "frame_bad_share_max"}


def test_a_frame_in_the_previous_style_is_not_correct(adain_copy, monkeypatch, one_thread):
    """Every submit carries the style the order held before the frame's."""
    from faststyle_tpu_torch.cli.stylize_webcam import FramePipeline

    submit, last = FramePipeline.submit, {}

    def previous(self, frame, style=None):
        if last.get("now") is not style:
            last["before"], last["now"] = last.get("now", style), style
        return submit(self, frame, last["before"])

    monkeypatch.setattr(FramePipeline, "submit", previous)
    line = _run(adain_copy)
    assert line["correct"] is False
    assert line["checks"]["frame_mae_max"]["value"] > line["checks"]["frame_mae_max"]["limit"]


def test_a_decoder_fed_without_adain_is_not_correct(adain_copy, monkeypatch, one_thread):
    from faststyle_tpu_torch.models import adain

    monkeypatch.setattr(adain, "adain", lambda feats, style: feats)
    line = _run(adain_copy)
    assert line["correct"] is False
    assert line["checks"]["frame_mae_max"]["value"] > line["checks"]["frame_mae_max"]["limit"]


MS = 1_000_000


class _Span:
    def __init__(self, name, start_ms, end_ms):
        self.name, self.start_ns, self.end_ns = name, int(start_ms * MS), int(end_ms * MS)


def _traced(ops):
    bench = Bench()
    cell = bench.cell("adain_4k_d4")
    trace = TraceData(100 * MS, 200 * MS, ops, [("bench.window", 100 * MS, 200 * MS),
                                                ("bench.submit", 110 * MS, 111 * MS),
                                                ("bench.submit", 150 * MS, 151 * MS)])
    ctx = Context(bench, cell, bench.config(cell["config"]), bench.traffic(cell["traffic"]), 0, 1.0, True, None, 0.0)
    return bench, Run(ctx, Record(1.0, 1.0, 0, 0, {}, {}, 0, Spans(), trace), "NVIDIA H100 80GB HBM3")


def test_the_new_readers_on_a_synthetic_trace(monkeypatch):
    """Two frames in the window: the norm's least time over the
    `instance_norm_` kernels' time, the convs' over the `conv` family's,
    the FLOPs over the window; `adain.norm` spans over `stream.submit`
    spans; None where there is nothing to read (a program without them)."""
    from benchmark import adain_flops, program_spans

    norm_s, conv_s = 0.5e-3, 40e-3
    ops = [("instance_norm_stats_kernel", 120 * MS, 120 * MS + norm_s * 1e9 * 0.6),
           ("instance_norm_apply_kernel", 130 * MS, 130 * MS + norm_s * 1e9 * 0.4),
           ("sm90_xmma_fprop_implicit_gemm_bf16", 140 * MS, 140 * MS + conv_s * 1e9)]
    bench, run = _traced(ops)
    model = run.config["model"]
    least_norm = adain_flops.norm_bytes(model, 2160, 3840) / 3.35e12
    assert bench.reader("adain_norm_roofline.adain").read(run) == pytest.approx(100 * least_norm * 2 / norm_s)
    convs = adain_flops.convs(model, 2160, 3840)
    least_conv = sum(c.least_s(989e12, 3.35e12) for c in convs if c.kind == "fwd")  # the model's 19 alone
    assert len([c for c in convs if c.kind == "fwd"]) == 19 and len(convs) > 19
    assert bench.reader("conv_roofline.adain").read(run) == pytest.approx(100 * least_conv * 2 / conv_s)
    flops = adain_flops.frame_flops(model, 2160, 3840)
    assert bench.reader("frame_mfu.adain").read(run) == pytest.approx(100 * flops * 2 / 0.1 / 989e12)
    monkeypatch.setattr(program_spans, "recorded", lambda: [_Span("stream.submit", 110, 111),
                                                           _Span("adain.norm", 110.5, 110.6),
                                                           _Span("stream.submit", 150, 151),
                                                           _Span("adain.norm", 150.5, 150.6),
                                                           _Span("adain.norm", 90, 91)])
    assert bench.reader("adain_norms_per_frame.adain").read(run) == 1.0
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    _, bare = _traced([("sm90_xmma_fprop_implicit_gemm_bf16", 140 * MS, 150 * MS)])
    assert bench.reader("adain_norms_per_frame.adain").read(bare) is None
    assert bench.reader("adain_norm_roofline.adain").read(bare) is None
