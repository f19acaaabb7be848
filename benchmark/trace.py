"""Host spans and the device trace of a traced run.

`Spans` records the benchmark's own spans around each call into the
program (`bench.submit`, `bench.fetch`, `bench.batch_wait`, `bench.step`)
by the host's clock, in every run; in a traced run each span is also a
`torch.profiler.record_function`, so the trace places it beside the device's
operations. `Tracer` profiles a part of the window (CPU and CUDA
activities) and reduces the profiler's raw events to `TraceData`: the
device operations, the benchmark's spans, and the traced window.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "bench.window"


class Spans:
    """Durations by span name, by the host's clock (seconds)."""

    def __init__(self, annotate: bool = False):
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self._annotate = annotate

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self._annotate:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.seconds[name].append(time.perf_counter() - t0)

    def mean(self, name: str) -> float | None:
        values = self.seconds.get(name)
        return sum(values) / len(values) if values else None


@dataclass
class TraceData:
    """A traced window: device operations and the benchmark's host spans as
    (name, start_ns, end_ns), and the window's own bounds."""

    start_ns: int
    end_ns: int
    device_ops: list[tuple[str, int, int]] = field(default_factory=list)
    host_spans: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def _clipped(self):
        for name, s, e in self.device_ops:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e > s:
                yield name, s, e

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals inside the window."""
        merged: list[list[int]] = []
        for _name, s, e in sorted(self._clipped(), key=lambda op: op[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for name, s, e in self._clipped():
            out[name] += (e - s) / 1e9
        return dict(out)

    def seconds_by_family(self, family) -> dict[str | None, float]:
        """Device seconds by `family(name)` (None: no kernel table names it)."""
        out: dict[str | None, float] = defaultdict(float)
        for name, secs in self.seconds_by_name().items():
            out[family(name)] += secs
        return dict(out)

    def count_spans(self, name: str) -> int:
        """Spans of `name` that start inside the window."""
        return sum(1 for n, s, _e in self.host_spans if n == name and self.start_ns <= s < self.end_ns)

    def idle_by_host_span(self) -> dict[str, float]:
        """Idle device seconds inside the window, each gap given to the
        innermost benchmark span around its midpoint (`bench.window` when the
        host was in none of the others)."""
        spans = sorted((e - s, n, s, e) for n, s, e in self.host_spans if n != WINDOW)
        gaps, last = [], self.start_ns
        for s, e in self.busy_intervals() + [(self.end_ns, self.end_ns)]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        out: dict[str, float] = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) // 2
            owner = next((n for _d, n, hs, he in spans if hs <= mid < he), WINDOW)
            out[owner] += (e - s) / 1e9
        return dict(out)


class Tracer:
    """torch.profiler over a part of the window. `prepare()` creates the
    profiler before the window and lets it warm up (the device tracer's
    start takes seconds, which would otherwise fall inside the window);
    `start()` and `stop()` are called from the timed loop; `data`, read
    after the window, reduces the profiler's events once."""

    def __init__(self):
        self._prof = None
        self._window = None
        self._results = None
        self._data: TraceData | None = None
        self.started = 0.0
        self.active = False
        self.done = False

    @property
    def data(self) -> TraceData | None:
        if self._data is None and self._results is not None:
            self._data = reduce_events(self._results.events())
        return self._data

    def prepare(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # one warm-up step (from here to start()), one recorded step (to stop())
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        self._prof = torch.profiler.profile(activities=acts, schedule=schedule)
        self._prof.__enter__()

    def start(self) -> None:
        import torch

        self._prof.step()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.started = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        import torch

        self._window.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.step()
        self._results = self._prof.profiler.kineto_results
        self._prof.__exit__(None, None, None)
        self._prof = None
        self.active = False
        self.done = True


def reduce_events(events) -> TraceData:
    """The profiler's raw events -> TraceData. Device events are kernels,
    copies and sets; the profiler's annotations on the device's timeline are
    left out (they span kernels already counted)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_spans = [], []
    window = None
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        annotation = ev.is_user_annotation()
        if ev.device_type() == cuda:
            if not annotation:
                device_ops.append((name, start, end))
        elif name.startswith("bench."):
            if name == WINDOW:
                window = (start, end)
            host_spans.append((name, start, end))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return TraceData(window[0], window[1], device_ops, host_spans)
