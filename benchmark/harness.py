"""One run of one cell: set up, measure a window, check the outputs, read
the metrics.

A driver (`drivers/<name>.py`, named by the configuration) does the work
between the program and the benchmark: `run(ctx) -> Record`. It sets the
program up, warms every shape the traffic uses, measures `ctx.seconds` of
traffic (profiling a part of it when `ctx.trace`), reads the device's
memory peak, frees the program's state and only then compares what the
timed path produced with the plain reference. The metrics are read from
the record by their readers (`metrics/<name>.py`).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.spec import Bench, family_of
from benchmark.trace import Spans, TraceData, Tracer

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "faststyle_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (Linux); 0 elsewhere."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])  # field 22 of stat, counted after the command name
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def derive_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one purpose (`label`) of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".", 1)[0] in FORBIDDEN_MODULES})


@dataclass
class Context:
    bench: Bench
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    started: float  # the process's start on the perf_counter clock
    spans: Spans = field(default_factory=Spans)
    tracer: Tracer = field(default_factory=Tracer)
    phases: dict = field(default_factory=dict)

    def phase(self, name: str) -> None:
        """Note the end of a set-up phase, in seconds since the process
        started, once the device has finished the phase's work."""
        if getattr(self.device, "type", None) == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.phases[name] = time.perf_counter() - self.started

    def prepare_trace(self) -> None:
        """In a traced run, set the profiler up before the window."""
        if self.trace:
            self.tracer.prepare()

    def tick(self, elapsed: float) -> None:
        """In a traced run, start the profiler once `elapsed` seconds of the
        window reach the start of its middle `trace_seconds`, and stop it
        `trace_seconds` after it started."""
        if not self.trace:
            return
        length = min(float(self.traffic["trace_seconds"]), self.seconds)
        if not self.tracer.active and not self.tracer.done and elapsed >= (self.seconds - length) / 2:
            self.tracer.start()
        elif self.tracer.active and time.perf_counter() - self.tracer.started >= length:
            self.tracer.stop()


@dataclass
class Record:
    """What a driver hands back."""

    setup_s: float
    window_s: float
    attempted: int
    failed: int
    counters: dict
    checks: dict  # name -> (value, limit): correct when every value <= its limit
    memory_peak_bytes: int
    spans: Spans
    trace: TraceData | None = None
    latencies_s: list = field(default_factory=list)
    setup_phases: dict = field(default_factory=dict)  # seconds since the process started, by phase end


class Run:
    """A finished run as the metric readers see it."""

    def __init__(self, ctx: Context, record: Record, device_kind: str):
        self.ctx = ctx
        self.record = record
        self.config = ctx.config
        self.traffic = ctx.traffic
        self.counters = record.counters
        self.spans = record.spans
        self.trace = record.trace
        self.device_kind = device_kind
        self._tables = ctx.bench.kernel_tables()

    def family(self, kernel_name: str) -> str | None:
        return family_of(kernel_name, self._tables)

    def peaks(self) -> dict | None:
        """The device's data-sheet peaks (peaks.json), None for a device the
        table does not know."""
        table = json.loads((self.ctx.bench.dir / "peaks.json").read_text())
        return next((v for k, v in table.items() if k in self.device_kind), None)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool, device, started: float,
             overrides: dict | None = None) -> tuple[Run, dict]:
    """Drive one cell once; returns the run and its result line (a dict).
    `overrides` ({"config": {...}, "traffic": {...}}) replaces top-level keys,
    for the tests' small sizes."""
    import torch

    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    config.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    ctx = Context(bench, cell, config, traffic, int(seed), float(seconds), bool(trace), torch.device(device),
                  started, spans=Spans(annotate=bool(trace)))
    record = bench.driver(config["driver"]).run(ctx)
    kind = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    run = Run(ctx, record, kind)
    metrics = {}
    for m in (bench.per_layer(cell) if trace else bench.end_to_end(cell)):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {
        "correct": all(v <= limit for v, limit in record.checks.values()),
        "attempted": record.attempted,
        "failed": record.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if ctx.device.type == "cuda" else "cpu",
            "kind": kind,
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(record.memory_peak_bytes),
        },
    }
    if trace and record.trace is not None:
        data = record.trace
        line["device"]["busy_s"] = data.busy_s()
        line["device"]["window_s"] = data.window_s
        top = sorted(data.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(data.idle_by_host_span().items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n[:120], s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}
    line["checks"] = {name: {"value": float(v), "limit": float(limit)} for name, (v, limit) in record.checks.items()}
    return run, line


def unnamed_kernels(run: Run) -> dict[str, float]:
    """Device seconds of the traced kernels that no kernel table names."""
    if run.trace is None:
        return {}
    return {n: s for n, s in run.trace.seconds_by_name().items() if run.family(n) is None}
