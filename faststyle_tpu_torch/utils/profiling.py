"""Where a train step's device time goes (the port's counterpart of the
trace half of faststyle_tpu/utils/profiling.py).

    python -m faststyle_tpu_torch.utils.profiling [--batch_size 4] [--size 256]
        [--precision float32|bfloat16] [--steps 5]

Runs the recipe train step on random VGG16 weights and a random batch, then
traces `--steps` steps with torch.profiler after two warm-up steps. Prints
the kernels that take the most device time, the device time by kernel
family, and a last JSON line with the untraced and traced step times, the
device operations (kernels and copies) per step, the device's busy share
(traced device time over the untraced step time) and the per-family
milliseconds per step. TF32 is off, as
in chip_smoke.py. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

# kernel-name fragments -> family, first match wins
_FAMILIES = (
    ("gram", ("gram_tile_kernel", "gram_reduce_kernel")),
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


def profile_train_step(batch_size: int, size: int, compute_dtype, steps: int) -> dict:
    from faststyle_tpu_torch import resolve_device
    from faststyle_tpu_torch.models import vgg16
    from faststyle_tpu_torch.training import slow_style, train_step

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    vgg = vgg16.init_params(gen, device=device)
    config = train_step.TrainConfig.make(compute_dtype=compute_dtype)
    style_layers = tuple(dict(config.style_weights))
    grams = slow_style.style_target_grams(vgg, torch.rand(1, size, size, 3, generator=gen) * 255, style_layers)
    state = train_step.init_state(config, seed=0, device=device)
    step = train_step.make_train_step(vgg, grams, config)
    batch = (torch.rand(batch_size, size, size, 3, generator=gen) * 255).to(device)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # untraced

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
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
        "batch_size": batch_size,
        "size": size,
        "precision": "bfloat16" if compute_dtype is not None else "float32",
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--precision", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.precision == "bfloat16" else None
    out = profile_train_step(args.batch_size, args.size, dtype, args.steps)
    print(f"{torch.cuda.get_device_name(0)}: {out['precision']} b{args.batch_size}@{args.size}")
    for name, ms in out["top_kernels_ms_per_step"]:
        print(f"  {ms:9.4f} ms/step  {name}")
    for fam, ms in out["family_ms_per_step"].items():
        print(f"  {fam:12s} {ms:9.4f} ms/step")
    print(json.dumps({k: v for k, v in out.items() if k != "top_kernels_ms_per_step"}))
    return out


if __name__ == "__main__":
    main()
