"""Profiling helpers and where the device time goes (counterpart of
faststyle_tpu/utils/profiling.py).

    python -m faststyle_tpu_torch.utils.profiling [--batch_size 4] [--size 256]
        [--precision float32|bfloat16] [--steps 5]
    python -m faststyle_tpu_torch.utils.profiling --stylize 1080 1920
        [--precision float32|bfloat16] [--steps 20]

Train-step mode runs the recipe train step on random VGG16 weights and a
random batch; stylize mode serves uint8 frames of the given height and
width through the Stylizer (upload, forward, uint8 download, as the
streaming CLI's depth-1 loop does) with random transform-net weights. Each
traces `--steps` steps or frames with torch.profiler after two warm-up
ones, and prints the kernels that take the most device time, the device
time by kernel family, and a last JSON line with the untraced and traced
times per step (or frame), the device operations (kernels and copies) per
step, the device's busy share (traced device time over the untraced time)
and the per-family milliseconds. TF32 is off. Needs a CUDA card.

Helpers: `hard_sync(x)` waits for x's device, `StepTimer` gives steps/s
with a sync only at its boundaries, `trace(log_dir)` writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator, Optional

import torch

# kernel-name fragments -> family, first match wins
_FAMILIES = (
    ("gram", ("gram_tile_kernel", "gram_reduce_kernel")),
    # the port's weight-gradient kernel, apart from cuDNN's "wgrad" kernels
    ("conv_wgrad", ("wgrad_tile_kernel", "wgrad_reduce_kernel")),
    ("optimizer", ("adam", "multi_tensor_apply")),
    ("conv", ("conv", "cudnn", "xmma", "implicit_gemm", "winograd", "fft", "wgrad", "dgrad")),
    ("matmul", ("gemm", "cutlass", "ampere", "sm90")),
    ("pool", ("max_pool", "maxpool")),
    ("reduce", ("reduce", "norm", "welford", "var_mean")),
    ("copy", ("copy", "memcpy", "memset", "cat", "index", "gather", "scatter")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in _FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise"


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


class StepTimer:
    """Steady-state steps/sec with a sync only at measurement boundaries."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._steps = 0

    def start(self, sync_on=None) -> None:
        if sync_on is not None:
            hard_sync(sync_on)
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self) -> None:
        self._steps += 1

    def rate(self, sync_on=None) -> float:
        if sync_on is not None:
            hard_sync(sync_on)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        return self._steps / dt if dt > 0 else float("nan")


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the block with torch.profiler (the CPU, and CUDA when there
    is a card) and write `<log_dir>/trace.json`, a Chrome trace that
    Perfetto and chrome://tracing open."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _device_breakdown(step_fn, steps: int) -> dict:
    """Untraced ms per step (after two warm-up steps), then a traced window
    of `steps`: device ms by kernel and by family, operations per step."""
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
    fams: dict[str, float] = defaultdict(float)
    for name, ms in per_kernel.items():
        fams[family(name)] += ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    return {
        "steps": steps,
        "ms_per_step": wall_ms / steps,
        "traced_ms_per_step": traced_ms / steps,
        "device_ops_per_step": launches / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        # device time of the traced steps over the untraced step time
        "device_busy_share": busy_ms / wall_ms,
        "family_ms_per_step": {k: v / steps for k, v in sorted(fams.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [(name[:100], ms / steps) for name, ms in top],
    }


def profile_train_step(batch_size: int, size: int, compute_dtype, steps: int) -> dict:
    from faststyle_tpu_torch import full_float32, resolve_device
    from faststyle_tpu_torch.models import vgg16
    from faststyle_tpu_torch.training import slow_style, train_step

    device = resolve_device("cuda")
    full_float32()
    gen = torch.Generator().manual_seed(0)
    vgg = vgg16.init_params(gen, device=device)
    config = train_step.TrainConfig.make(compute_dtype=compute_dtype)
    style_layers = tuple(dict(config.style_weights))
    grams = slow_style.style_target_grams(vgg, torch.rand(1, size, size, 3, generator=gen) * 255, style_layers)
    state = train_step.init_state(config, seed=0, device=device)
    step = train_step.make_train_step(vgg, grams, config)
    batch = (torch.rand(batch_size, size, size, 3, generator=gen) * 255).to(device)
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
    convs run them), from the shapes alone."""
    from faststyle_tpu_torch.models import transform_net as T

    hp, wp = height + 80, width + 80
    flops = 0
    size = (hp, wp)
    for k, cin, cout, s in T._INIT_SPECS:
        size = (-(-size[0] // s), -(-size[1] // s))
        flops += 2 * size[0] * size[1] * k * k * cin * cout
    for _ in range(T._NUM_RESBLOCKS):
        for _ in range(2):
            size = (size[0] - 2, size[1] - 2)
            flops += 2 * size[0] * size[1] * 9 * 64 * 64
    for _k, cin, cout in T._UP_SPECS:
        # one 2x2 conv (4 taps) with 4*cout outputs per input position
        flops += 2 * size[0] * size[1] * 4 * cin * 4 * cout
        size = (2 * size[0], 2 * size[1])
    k, cin, cout = T._FINAL_SPEC
    flops += 2 * size[0] * size[1] * k * k * cin * cout
    return float(flops)


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
    for fam, ms in out["family_ms_per_step"].items():
        print(f"  {fam:12s} {ms:9.4f} {unit}")
    print(json.dumps({k: v for k, v in out.items() if k != "top_kernels_ms_per_step"}))
    return out


if __name__ == "__main__":
    main()
