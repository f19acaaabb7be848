"""The readers of the program's spans (`program_spans.py` and the seven
metrics on it) on synthetic spans and a synthetic trace: the window's
edges, device idle overlapped by a span, and None with no spans."""

from typing import NamedTuple

import pytest

from benchmark import program_spans
from benchmark.harness import Context, Record, Run
from benchmark.spec import Bench
from benchmark.trace import Spans, TraceData

MS = 1_000_000  # ns

STREAM = ("slot_wait_ms.stylize", "pack_ms.stylize", "unpack_ms.stylize", "launch_ms.stylize")
TRAIN = ("forward_idle_ms.train", "backward_idle_ms.train", "decode_ms.train")


class Span(NamedTuple):  # the fields the readers use of the program's records
    name: str
    start_ns: int
    end_ns: int


def _span(name, start_ms, end_ms):
    return Span(name, int(start_ms * MS), int(end_ms * MS))


def _trace(kernels, start_ms=100, end_ms=200):
    return TraceData(int(start_ms * MS), int(end_ms * MS), [(n, int(s * MS), int(e * MS)) for n, s, e in kernels],
                     [("bench.window", int(start_ms * MS), int(end_ms * MS))])


def _run(bench, cell_name, trace):
    cell = bench.cell(cell_name)
    ctx = Context(bench, cell, bench.config(cell["config"]), bench.traffic(cell["traffic"]), 0, 1.0, True, None, 0.0)
    return Run(ctx, Record(1.0, 1.0, 0, 0, {}, {}, 0, Spans(), trace), "NVIDIA H100 80GB HBM3")


@pytest.fixture
def spans(monkeypatch):
    """The program's records as the readers will see them."""
    records: list = []
    monkeypatch.setattr(program_spans, "recorded", lambda: list(records))
    return records


@pytest.mark.parametrize("metric,span_name", [
    ("slot_wait_ms.stylize", "stream.slot_wait"), ("pack_ms.stylize", "stream.pack"),
    ("unpack_ms.stylize", "stream.unpack"), ("launch_ms.stylize", "stream.launch"),
    ("decode_ms.train", "data.decode")])
def test_mean_over_the_spans_that_start_in_the_window(spans, metric, span_name):
    """A span that starts before the window or at its end is left out; one
    that starts inside and ends after it counts whole (host time)."""
    bench = Bench()
    cell = "train_b16_256" if metric.endswith(".train") else "stylize_4k_d4"
    run = _run(bench, cell, _trace([]))
    spans += [_span(span_name, 95, 104), _span(span_name, 110, 112), _span(span_name, 120, 126),
              _span(span_name, 196, 210), _span(span_name, 200, 201), _span("other", 130, 190)]
    assert bench.reader(metric).read(run) == pytest.approx((2 + 6 + 14) / 3)


@pytest.mark.parametrize("metric", STREAM + TRAIN)
def test_none_without_spans_in_the_window(spans, metric):
    """No record of the name in the window, no trace, or a program that
    keeps no spans: nothing to read."""
    bench = Bench()
    cell = "train_b16_256" if metric.endswith(".train") else "stylize_4k_d4"
    assert bench.reader(metric).read(_run(bench, cell, _trace([]))) is None
    spans += [_span(n, 10, 20) for n in ("stream.slot_wait", "stream.pack", "stream.unpack", "stream.launch",
                                         "train.step", "train.forward", "train.backward", "data.decode")]
    assert bench.reader(metric).read(_run(bench, cell, _trace([]))) is None  # all before the window
    spans += [_span(n, 150, 160) for n in ("stream.slot_wait", "train.step", "train.forward", "data.decode")]
    assert bench.reader(metric).read(_run(bench, cell, None)) is None


def test_idle_overlap_cuts_to_the_window_and_merges():
    # busy [100, 120] + [130, 140] + [190, 200] of a [100, 200] window: idle (120, 130), (140, 190)
    trace = _trace([("k", 90, 120), ("k", 130, 135), ("k", 134, 140), ("k", 190, 250)])
    assert program_spans.idle_gaps(trace) == [(120 * MS, 130 * MS), (140 * MS, 190 * MS)]
    ov = lambda *iv: program_spans.idle_overlap_ns(trace, [(int(s * MS), int(e * MS)) for s, e in iv]) / MS  # noqa: E731
    assert ov((125, 145)) == pytest.approx(10)
    assert ov((125, 145), (128, 150)) == pytest.approx(15)  # overlapping spans count once
    assert ov((180, 260)) == pytest.approx(10)  # cut at the window's end
    assert ov((50, 125)) == pytest.approx(5)  # and at its start
    assert ov((100, 120), (130, 140)) == 0
    assert ov((110, 300)) == pytest.approx(60)
    assert program_spans.idle_overlap_ns(_trace([]), [(150 * MS, 250 * MS)]) == 50 * MS  # no device work


def test_forward_and_backward_idle_per_step(spans):
    """Idle that each phase's spans overlap, over the train.step spans that
    start in the window; a step before the window counts neither."""
    bench = Bench()
    # two steps in the window: forward 110-130, 150-170; backward 130-145, 170-190
    trace = _trace([("k", 112, 128), ("k", 131, 140), ("k", 152, 170), ("k", 172, 190)])
    spans += [_span("train.step", 80, 99), _span("train.forward", 80, 95), _span("train.backward", 95, 99),
              _span("train.step", 110, 146), _span("train.forward", 110, 130), _span("train.backward", 130, 145),
              _span("train.step", 150, 192), _span("train.forward", 150, 170), _span("train.backward", 170, 190)]
    run = _run(bench, "train_b16_256", trace)
    # forward idle: (110-112) + (128-130) + (150-152) = 6 ms; backward: (130-131) + (140-145) + (170-172) = 8 ms
    assert bench.reader("forward_idle_ms.train").read(run) == pytest.approx(6 / 2)
    assert bench.reader("backward_idle_ms.train").read(run) == pytest.approx(8 / 2)
    spans[:] = [s for s in spans if s.name != "train.step"]
    assert bench.reader("forward_idle_ms.train").read(run) is None


def test_the_ports_records_are_read():
    """`recorded()` reads the program's own buffer (the port records spans);
    a program without `profiling.recorded` reads as none."""
    import torch

    from faststyle_tpu_torch.utils import profiling

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("stream.pack", 3):
            pass
    mine = [s for s in program_spans.recorded() if s.name == "stream.pack" and s.id == 3]
    assert mine and mine[-1].start_ns <= mine[-1].end_ns
    saved = profiling.recorded
    try:
        del profiling.recorded
        assert program_spans.recorded() == []
    finally:
        profiling.recorded = saved
