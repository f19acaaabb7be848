"""Profiling helpers, the program's spans, and where the device time goes
(counterpart of faststyle_tpu/utils/profiling.py).

    python -m faststyle_tpu_torch.utils.profiling [--batch_size 4] [--size 256]
        [--precision float32|bfloat16] [--steps 5]
    python -m faststyle_tpu_torch.utils.profiling --stylize 1080 1920
        [--precision float32|bfloat16] [--steps 20]

Train-step mode runs the recipe train step on random VGG16 weights and a
random batch; stylize mode serves uint8 frames of the given height and
width through the Stylizer (upload, forward, uint8 download, as the
streaming CLI's depth-1 loop does) with random transform-net weights. Each
traces `--steps` steps or frames with torch.profiler after two warm-up
ones, and prints the kernels that take the most device time and a last
JSON line with the untraced and traced times per step (or frame), the
device operations (kernels and copies) per step and the device's busy
share (traced device time over the untraced time). TF32 is off. Needs a
CUDA card.

Spans: `with span("stream.pack", id):` around a piece of the program's
host work records its name, its id (the enclosing span's when None), the
enclosing span on the same thread, the thread and its start and end in
`time.time_ns()` nanoseconds, the clock of torch.profiler's events, so a
span lies on the device trace's time line. Recording follows the torch
profiler: it is on in every thread of the process exactly while a
torch.profiler records, and off otherwise, when a span is one flag test
and a shared no-op. `recorded()` returns the records, newest last, from a
bounded buffer.

Helpers: `hard_sync(x)` waits for x's device, `trace(log_dir)` writes a
Chrome trace with the program's spans in it, `recipe_step` builds the
recipe train step on seeded random weights (here and in the bench),
`stylize_ops` counts a served frame's FLOPs.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import torch

# torch.profiler sets this process-wide flag when it starts recording and
# clears it when it stops, whichever thread runs it;
# torch.autograd._profiler_enabled() answers for its own thread only, so a
# decode thread would never see a profiler started on the main thread.
_TORCH_PROFILER = torch.autograd.profiler
MAX_RECORDS = 1 << 18


class Span(NamedTuple):
    """A recorded span. `parent` is the name of the enclosing span on the
    same thread, `thread` the thread's native id (a Chrome trace's tid);
    times are `time.time_ns()` nanoseconds."""

    name: str
    id: Optional[int]
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_records_lock = threading.Lock()


class _ThreadState(threading.local):
    """Each thread's open spans, innermost last, and its native id (read
    once: it is a system call)."""

    def __init__(self):
        self.stack: list = []
        self.native_id = threading.get_native_id()


_thread = _ThreadState()
_NO_SPAN = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "id", "parent", "start_ns")

    def __init__(self, name: str, id: Optional[int]):
        self.name = name
        self.id = id

    def __enter__(self):
        stack = _thread.stack
        parent = stack[-1] if stack else None
        self.parent = parent and parent.name
        if self.id is None and parent is not None:
            self.id = parent.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        _thread.stack.pop()
        record = Span(self.name, self.id, self.parent, _thread.native_id, self.start_ns, end_ns)
        with _records_lock:
            _records.append(record)


def span(name: str, id: Optional[int] = None):
    """A context manager that records the block as a span while a torch
    profiler records, and does nothing otherwise. `id` ties the spans of one
    frame or step together; None takes the enclosing span's."""
    if not _TORCH_PROFILER._is_profiler_enabled:
        return _NO_SPAN
    return _Recording(name, id)


def recorded() -> list[Span]:
    """The recorded spans in the order they ended (at most MAX_RECORDS, the
    newest kept)."""
    with _records_lock:
        return list(_records)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def hard_sync(x) -> None:
    """Wait until everything enqueued before now on the device of `x` (a
    tensor, or the first tensor in a dict / list / tuple) has finished. A
    CPU tensor computes eagerly, so there is nothing to wait for."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the block with torch.profiler (the CPU, and CUDA when there
    is a card) and write `<log_dir>/trace.json`, a Chrome trace that
    Perfetto and chrome://tracing open, with the program's spans of the
    block (category `program_span`) on the threads that ran them."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    started_ns = time.time_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    _add_spans(path, [s for s in recorded() if s.start_ns >= started_ns])


def _add_spans(path: Path, spans: list[Span]) -> None:
    """Append spans to a Chrome trace torch.profiler wrote: its `ts` are
    microseconds after `baseTimeNanoseconds` on the spans' own clock."""
    data = json.loads(path.read_text())
    base = data.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    data["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent}}
        for s in spans
    )
    path.write_text(json.dumps(data))


def _device_breakdown(step_fn, steps: int) -> dict:
    """Untraced ms per step (after two warm-up steps), then a traced window
    of `steps`: device ms by kernel, operations per step."""
    for _ in range(2):
        step_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # untraced

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3

    per_kernel: dict[str, float] = defaultdict(float)
    launches = 0
    for evt in prof.events():
        # device-side events, minus the user annotations (e.g. the optimizer's
        # step range) that span kernels already counted
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            per_kernel[evt.name] += evt.time_range.elapsed_us() / 1e3
            launches += 1
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {
        "steps": steps,
        "ms_per_step": wall_ms / steps,
        "traced_ms_per_step": traced_ms / steps,
        "device_ops_per_step": launches / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        # device time of the traced steps over the untraced step time
        "device_busy_share": busy_ms / wall_ms,
        "top_kernels_ms_per_step": [(name[:100], ms / steps) for name, ms in top],
    }


def recipe_step(size: int, compute_dtype=None, *, device: str | torch.device = "cuda", make_step=None, **step_kwargs):
    """The recipe train step (`TrainConfig.make()`) on seeded random
    weights, for measuring its cost: VGG16 from a seeded torch.Generator,
    the style Grams of a seeded random size x size style image, the
    transform net's state from seed 1. `make_step(vgg, grams, config,
    **step_kwargs)` builds the step (default `train_step.make_train_step`;
    the DP bench passes `parallel.data_parallel.make_dp_train_step`).
    Returns (step_fn, state)."""
    import numpy as np

    from faststyle_tpu_torch.models import vgg16
    from faststyle_tpu_torch.training import slow_style, train_step

    config = train_step.TrainConfig.make(compute_dtype=compute_dtype)
    vgg = vgg16.init_params(torch.Generator().manual_seed(0), device=device)
    style = np.random.default_rng(0).uniform(0, 255, (1, size, size, 3)).astype(np.float32)
    grams = slow_style.style_target_grams(vgg, style, tuple(dict(config.style_weights)))
    state = train_step.init_state(config, seed=1, device=device)
    return (make_step or train_step.make_train_step)(vgg, grams, config, **step_kwargs), state


def profile_train_step(batch_size: int, size: int, compute_dtype, steps: int) -> dict:
    from faststyle_tpu_torch import full_float32, resolve_device

    device = resolve_device("cuda")
    full_float32()
    step, state = recipe_step(size, compute_dtype, device=device)
    batch = (torch.rand(batch_size, size, size, 3, generator=torch.Generator().manual_seed(0)) * 255).to(device)
    out = _device_breakdown(lambda: step(state, batch), steps)
    return {
        "mode": "train_step",
        "batch_size": batch_size,
        "size": size,
        "precision": "bfloat16" if compute_dtype is not None else "float32",
        **out,
    }


def stylize_ops(height: int, width: int) -> float:
    """Multiply-adds x 2 of one frame's convolutions (the transform net's
    16 convs at their output sizes, the resize-convs as the fused phase
    convs run them: `transform_net.conv_shapes`), from the shapes alone."""
    from faststyle_tpu_torch.models import transform_net

    return float(sum(2 * oh * ow * k * k * ci * co
                     for _ih, _iw, oh, ow, k, _s, ci, co in transform_net.conv_shapes(height, width)))


def profile_stylize(height: int, width: int, compute_dtype, steps: int) -> dict:
    import numpy as np

    from faststyle_tpu_torch import full_float32, resolve_device
    from faststyle_tpu_torch.inference import Stylizer
    from faststyle_tpu_torch.models import transform_net

    device = resolve_device("cuda")
    full_float32()
    params = transform_net.init_params(torch.Generator().manual_seed(0), device=device)
    stylizer = Stylizer(params=params, compute_dtype=compute_dtype, output_uint8=True, device=device)
    frame = np.random.default_rng(0).integers(0, 256, (1, height, width, 3), dtype=np.uint8)
    out = _device_breakdown(lambda: stylizer.stylize_batch(frame).cpu(), steps)
    ops = stylize_ops(height, width)
    return {
        "mode": "stylize",
        "height": height,
        "width": width,
        "precision": "bfloat16" if compute_dtype is not None else "float32",
        "conv_gflop_per_frame": ops / 1e9,
        **out,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--stylize", type=int, nargs=2, metavar=("HEIGHT", "WIDTH"), default=None,
                    help="profile serving frames of this size instead of the train step")
    ap.add_argument("--precision", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--steps", type=int, default=None, help="traced steps (default 5) or frames (default 20)")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.precision == "bfloat16" else None
    if args.stylize:
        out = profile_stylize(*args.stylize, dtype, args.steps or 20)
        what, unit = f"stylize {args.stylize[0]}x{args.stylize[1]}", "ms/frame"
    else:
        out = profile_train_step(args.batch_size, args.size, dtype, args.steps or 5)
        what, unit = f"b{args.batch_size}@{args.size}", "ms/step"
    print(f"{torch.cuda.get_device_name(0)}: {out['precision']} {what}")
    for name, ms in out["top_kernels_ms_per_step"]:
        print(f"  {ms:9.4f} {unit}  {name}")
    print(json.dumps({k: v for k, v in out.items() if k != "top_kernels_ms_per_step"}))
    return out


if __name__ == "__main__":
    main()
