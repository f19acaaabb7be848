#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faststyle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. device  — requires CUDA; prints the card's name and power limit, turns
               TF32 off for matmuls and cuDNN (full float32 everywhere)
  2. build   — compiles the Gram kernel from faststyle_tpu_torch/csrc and
               checks with cuobjdump that its tile kernels run on the tensor
               cores (HMMA instructions in their SASS)
  3. kernel  — the kernel against its plain PyTorch version, forward and
               gradient, at the b4@256 training shapes in float32 and bf16
               and at ragged and unaligned shapes; float32 against a
               float64 Gram, well inside 1xTF32's error; two calls bitwise
               equal (determinism); times
               the kernel, the plain version and torch.matmul on the same
               features, eagerly and on the device alone (CUDA graph
               replays), beside the card's bound and the launch plan
  4. slice   — `faststyle_tpu_torch.cli.train` for 6 steps at b4@256, full
               width (random VGG16 weights and synthetic images from a seed),
               with the Gram launch count; one GPU train step against the
               same step on the CPU; steps/s of the train step
Then the `kernels` JSON line, and last the `ok` line.
"""

from __future__ import annotations

import csv
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from faststyle_tpu_torch.cli import train as cli_train
from faststyle_tpu_torch.inference import load_params
from faststyle_tpu_torch.models import transform_net, vgg16
from faststyle_tpu_torch.ops.cuda import build, gram
from faststyle_tpu_torch.training import slow_style, train_step
from faststyle_tpu_torch.utils import image_io

REPO = Path(__file__).resolve().parent
SEED = 0
# H100 SXM data sheet (dense): the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the peak for its type.
# The Gram's operations: the c(c+1)/2 distinct entries of the symmetric G,
# 2*b*hw FLOP each, in 3 TF32 passes (float32 as 3xTF32) or 1 bf16 pass
HBM_BYTES_PER_S = 3.35e12
TENSOR_PEAK = {torch.float32: 495e12, torch.bfloat16: 989e12}  # TF32, bf16
PASSES = {torch.float32: 3, torch.bfloat16: 1}
FFMA_PEAK = 67e12  # FP32 outside the tensor cores: the bound the first kernel was held to
TRAIN_SHAPES = [(4, 256, 256, 64), (4, 128, 128, 128), (4, 64, 64, 256), (4, 32, 32, 512)]
# (shape, dtype, storage offset in elements: 1 breaks the 16-byte alignment);
# the training shapes in both dtypes, since the train step runs either
CHECK_SHAPES = [(s, dt, 0) for dt in (torch.float32, torch.bfloat16) for s in TRAIN_SHAPES] + [
    ((3, 17, 9, 64), torch.float32, 0),
    ((2, 33, 31, 48), torch.float32, 0),
    ((2, 17, 9, 64), torch.float32, 1),
    ((2, 9, 11, 20), torch.bfloat16, 0),
    ((3, 7, 5, 37), torch.bfloat16, 1),
]
# in both dtypes: split (two launches); one launch, mostly off-diagonal tiles
DETERMINISM_SHAPES = [TRAIN_SHAPES[0], TRAIN_SHAPES[3]]
# forward: float32 sums over hw in another order than cuBLAS -> 1e-4 of the
# largest entry; gradient: the same matmul formula in f32 (1e-4), and for
# bf16 one bf16 rounding of each entry after it (2^-8 ~ 4e-3 -> 1e-2)
FWD_TOL = 1e-4
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# float32 against a float64 Gram: the kernel's error must stay under
# 1/TF32_MARGIN of the error that rounding the input to TF32 alone gives
# (what a 1xTF32 kernel would show at least), so 3xTF32 is what ran. On an
# H100 the kernel reads 2-3e-6 of max |G| at the training shapes, 1xTF32
# 8e-6 at conv1_2 (the closest) to 8e-5 at conv4_3
TF32_MARGIN = 2


def phase(name):
    print(f"== {name}", flush=True)


def device_phase() -> str:
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def build_phase() -> None:
    phase("build")
    path, seconds = build.build("gram")
    gram._lib()  # load and bind
    print(f"built {path.relative_to(REPO)} in {seconds:.2f} s")
    tensor_core_check(path)


def tensor_core_check(lib_path: Path) -> None:
    """Raises unless every Gram tile kernel in the built library has HMMA
    (tensor-core) instructions in its SASS; prints each kernel's registers
    and local-memory bytes (spills) from cuobjdump."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    run = lambda flag: subprocess.run([str(tool), flag, str(lib_path)], capture_output=True,
                                      text=True, check=True, timeout=300).stdout
    hmma = {}
    for block in run("-sass").split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        hmma[name.strip()] = len(re.findall(r"\bHMMA\.", body))
    tiles = {n: k for n, k in hmma.items() if "gram_tile_kernel" in n}
    name = None  # cuobjdump prints a function's name, then (maybe on the next line) its usage
    for line in run("-res-usage").splitlines():
        if m := re.search(r"Function (\S+):", line):
            name = m.group(1)
        if (u := re.search(r"REG:(\d+).*?SHARED:(\d+).*?LOCAL:(\d+)", line)) and name and "gram_" in name:
            print(f"  {name[name.index('gram_'):]}: registers {u[1]}, static shared {u[2]} B, "
                  f"local (spills) {u[3]} B, HMMA {hmma.get(name, 0)}")
            name = None
    if not tiles or min(tiles.values()) == 0:
        raise AssertionError(f"gram tile kernels without HMMA in their SASS: {tiles}")
    print(f"tensor cores: {len(tiles)} gram tile kernels, each with HMMA "
          f"({min(tiles.values())}-{max(tiles.values())} instructions)")


@functools.cache
def capture_stream() -> torch.cuda.Stream:
    return torch.cuda.Stream()


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False, replays: int = 5) -> float:
    """Mean ms per call of `fn` by CUDA events, after `warmup` calls.
    Eager (graph=False): `iters` calls launched back to back, so a host
    launch cost above the device time shows. Device alone (graph=True):
    `iters` calls captured in one CUDA graph, timed over `replays` replays."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not graph:
        for _ in range(warmup):
            fn()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    # warm up off the default stream, as capture requires, on one stream
    # for every call: cuBLAS keeps a workspace per stream it has run on
    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(iters):
            fn()
    g.replay()
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound(shape, dtype) -> tuple[float, float]:
    """(ms to move the bytes, ms to do the operations) of one Gram call:
    the input read once and the output written once; passes * b*hw*c(c+1)
    FLOP on the tensor cores."""
    b, h, w, c = shape
    nbytes = b * h * w * c * torch.finfo(dtype).bits // 8 + b * c * c * 4
    flops = PASSES[dtype] * b * h * w * c * (c + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / TENSOR_PEAK[dtype] * 1e3


def ffma_bound_ms(shape) -> float:
    """The first kernel's bound: 2*b*hw*c^2 FLOP at the FP32 (FFMA) peak."""
    b, h, w, c = shape
    return 2 * b * h * w * c * c / FFMA_PEAK * 1e3


def tf32_errors(x: torch.Tensor) -> tuple[float, float]:
    """(the kernel's, 1xTF32's) largest error against a float64 Gram of the
    float32 input x, over its largest entry. 1xTF32's is that of rounding x
    to TF32 (to nearest, ties away) alone, the products summed in float64."""
    b, h, w, c = x.shape
    f = x.reshape(b, h * w, c)
    hi = ((f.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    gram64 = lambda v: torch.matmul(v.double().transpose(1, 2), v.double()) / (h * w * c)
    ref = gram64(f)
    scale = ref.abs().max()
    return (float((gram.gram_cuda(x).double() - ref).abs().max() / scale),
            float((gram64(hi) - ref).abs().max() / scale))


def storage(shape, dtype, offset: int, gen) -> torch.Tensor:
    """A flat random buffer whose [offset:] holds a contiguous `shape`."""
    return torch.randn(math.prod(shape) + offset, generator=gen, device="cuda").to(dtype)


def kernel_phase() -> dict:
    phase("kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    totals = dict.fromkeys(
        ("kernel_ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms", "ffma_bound_ms"), 0.0)
    bytes_ms = ops_ms = 0.0
    sms = gram.num_sms(torch.cuda.current_device())
    for shape, dtype, offset in CHECK_SHAPES:
        buf = storage(shape, dtype, offset, gen)
        x = buf[offset:].view(shape)
        got = gram.gram_cuda(x)
        ref = gram.gram_matrix_plain(x)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (err <= FWD_TOL * scale):
            raise AssertionError(f"gram {shape} {dtype}: max |kernel - plain| {err} > {FWD_TOL} * {scale}")
        worst = max(worst, err)
        tf32 = ""
        if dtype == torch.float32 and shape in TRAIN_SHAPES:
            e64, e1x = tf32_errors(x)
            if not (e64 * TF32_MARGIN <= e1x):
                raise AssertionError(f"gram {shape}: error against float64 {e64} of max |G| is not under "
                                     f"1/{TF32_MARGIN} of 1xTF32's {e1x}")
            tf32 = f" vs_float64: kernel={e64:.3e} 1xTF32={e1x:.3e} (of max |G|)"

        ct = torch.randn(shape[0], shape[3], shape[3], generator=gen, device="cuda")
        grads = []
        for fn in (gram.gram_matrix, gram.gram_matrix_plain):
            leaf = buf.clone().requires_grad_()  # the gradient flows through the same unaligned view
            (fn(leaf[offset:].view(shape)) * ct).sum().backward()
            grads.append(leaf.grad[offset:].float())
        g_err = float((grads[0] - grads[1]).abs().max())
        g_scale = float(grads[1].abs().max())
        if not (g_err <= GRAD_TOL[dtype] * g_scale):
            raise AssertionError(f"gram grad {shape} {dtype}: {g_err} > {GRAD_TOL[dtype]} * {g_scale}")

        b, h, w, c = shape
        if shape in DETERMINISM_SHAPES and not torch.equal(gram.gram_cuda(x), gram.gram_cuda(x)):
            raise AssertionError(f"gram {shape} {dtype}: two calls on the same input differ")
        p = gram.plan(b, h * w, c, dtype, sms)
        f = x.reshape(b, h * w, c)
        k_ms = cuda_time_ms(lambda: gram.gram_cuda(x))
        k_dev = cuda_time_ms(lambda: gram.gram_cuda(x), graph=True)
        p_ms = cuda_time_ms(lambda: gram.gram_matrix_plain(x))
        l_ms = cuda_time_ms(lambda: torch.matmul(f.transpose(1, 2), f))
        l_dev = cuda_time_ms(lambda: torch.matmul(f.transpose(1, 2), f), graph=True)
        t_bytes, t_ops = bound(shape, dtype)
        b_ms, b_by = max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"
        dt = str(dtype).removeprefix("torch.") + (f" offset {offset}" if offset else "")
        print(f"gram {list(shape)} {dt}: max_abs_err={err:.3e} (max |G| {scale:.3e}){tf32} "
              f"grad_err={g_err:.3e} (max {g_scale:.3e}) kernel_ms={k_ms:.5f} kernel_dev_ms={k_dev:.5f} "
              f"plain_ms={p_ms:.5f} matmul_ms={l_ms:.5f} matmul_dev_ms={l_dev:.5f} "
              f"bound_ms={b_ms:.5f} ({b_by}) bound_share={b_ms / k_dev:.3f} "
              f"plan: splits={p.splits} chunk={p.chunk} tile={p.tile} blocks={p.blocks} "
              f"launches_per_call={p.launches}", flush=True)
        if dtype == torch.float32 and shape in TRAIN_SHAPES:
            vals = (k_ms, k_dev, p_ms, l_ms, l_dev, b_ms, ffma_bound_ms(shape))
            for key, val in zip(totals, vals):
                totals[key] += val
            bytes_ms += t_bytes
            ops_ms += t_ops
    print(f"gram, the four b4@256 float32 style layers together (one train step's forward): "
          + " ".join(f"{k}={v:.5f}" for k, v in totals.items())
          + f" bound_share={totals['bound_ms'] / totals['device_ms']:.3f}", flush=True)
    return {"max_abs_err": worst, "bound_by": "bytes" if bytes_ms > ops_ms else "operations", **totals}


def write_inputs(root: Path) -> tuple[Path, Path]:
    """A random VGG16 in Frossard keys (He-scaled, so activations stay in
    range) and 8 synthetic 256x256 images, all from one numpy seed."""
    rng = np.random.default_rng(SEED)
    flat, cin = {}, 3
    for name in [n for n in vgg16.LAYER_ORDER if n.startswith("conv")]:
        cout = {1: 64, 2: 128, 3: 256}.get(int(name[4]), 512)
        flat[f"{name}_W"] = (rng.standard_normal((3, 3, cin, cout)) * math.sqrt(2 / (9 * cin))).astype(np.float32)
        flat[f"{name}_b"] = np.zeros(cout, np.float32)
        cin = cout
    vgg_path = root / "vgg16_random.npz"
    np.savez(vgg_path, **flat)
    img_dir = root / "images"
    img_dir.mkdir()
    for i in range(8):
        # smooth colour fields plus noise: photo-like statistics, not white noise
        yy, xx = np.mgrid[0:256, 0:256] / 256.0
        offset = rng.uniform(0, 2 * np.pi, 3)
        img = 127 + 100 * np.sin(2 * np.pi * (xx[..., None] * (i + 1) + yy[..., None]) + offset)
        img = img + rng.normal(0, 20, img.shape)
        image_io.imwrite(img_dir / f"img_{i}.png", np.clip(img, 0, 255).astype(np.uint8))
    return vgg_path, img_dir


def slice_phase() -> dict:
    phase("slice")
    steps = 6
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        vgg_path, img_dir = write_inputs(root)
        cwd = os.getcwd()
        os.chdir(root)  # the CLI writes training/, models/, summaries/ here
        try:
            torch.cuda.reset_peak_memory_stats()
            gram.GramFunction.launches = 0
            t0 = time.perf_counter()
            state = cli_train.main([
                "--image_dir", str(img_dir), "--vgg_path", str(vgg_path),
                "--style_img_path", str(REPO / "style_images" / "starry_night_crop.jpg"),
                "--batch_size", "4", "--preprocess_size", "256", "256", "--n_epochs", "4",
                "--num_steps_break", str(steps), "--num_steps_ckpt", "3",
            ])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = gram.GramFunction.launches
        finally:
            os.chdir(cwd)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"cli.train: {state.step} steps at b4@256 float32 in {wall:.2f} s wall "
              f"(pipeline, targets, checkpoints, final save); peak device memory {peak_gib:.3f} GiB")
        if state.step != steps:
            raise AssertionError(f"trained {state.step} steps, expected {steps}")
        want = 4 * steps + 4  # four style layers per step, plus the target Grams once
        print(f"gram launches on the main path: {launches} (need >= {want})")
        if launches < want:
            raise AssertionError(f"gram kernel launched {launches} times, expected >= {want}")
        ckpt = root / "training" / "model"
        for s in (3, 6):
            if not (ckpt / f"step_{s}" / "state.npz").exists():
                raise AssertionError(f"missing checkpoint {ckpt}/step_{s}")
        with open(next((root / "summaries" / "train").glob("*/metrics.csv")), newline="") as f:
            rows = list(csv.DictReader(f))
        for row in rows:
            parts = {k: float(row[k]) for k in ("loss", "content_loss", "style_loss", "tv_loss")}
            print(f"step {row['step']}: {parts}")
            if not all(math.isfinite(v) for v in parts.values()):
                raise AssertionError(f"non-finite loss part at step {row['step']}: {parts}")
        params = load_params(root / "models" / "model_final.npz", device="cuda")
        expected = transform_net.init_params(torch.Generator().manual_seed(0), device="cpu")
        got_keys = {f"{b}/{v}" for b in params for v in params[b]}
        if got_keys != {f"{b}/{v}" for b in expected for v in expected[b]} or "initconv_0/W" not in got_keys:
            raise AssertionError(f"final npz keys differ from the JAX package's set: {sorted(got_keys)}")
        x = torch.from_numpy(image_io.imread(img_dir / "img_0.png")).cuda()[None]
        y = transform_net.apply(params, x)
        if y.shape != x.shape or y.dtype != torch.uint8:
            raise AssertionError(f"stylized output {tuple(y.shape)} {y.dtype}")
        print(f"final weights stylize a 256x256 uint8 image -> {tuple(y.shape)} {y.dtype}")

        vgg_gpu = vgg16.load_npz(vgg_path, device="cuda")
        reference_check(vgg_path, vgg_gpu)
        rates = {dt: steps_per_sec(vgg_gpu, dt) for dt in (None, torch.bfloat16)}
    return {"launches": launches, "steps_per_sec": rates}


def reference_check(vgg_path: Path, vgg_gpu) -> None:
    """One recipe train step at b2@64 on the card against the same step on
    the CPU (the plain Gram): loss parts within 1e-3 relative (float32 in
    both, summed in other orders), params within 2 * lr (Adam's first step
    is ~lr * sign(g))."""
    config = train_step.TrainConfig.make()
    style = image_io.imresize(image_io.imread(REPO / "style_images" / "starry_night_crop.jpg"), 0.25)
    batch = np.random.default_rng(SEED + 1).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    out = {}
    for dev, vgg in (("cuda", vgg_gpu), ("cpu", vgg16.load_npz(vgg_path, device="cpu"))):
        grams = slow_style.style_target_grams(vgg, np.asarray(style, np.float32)[None], ("conv1_2", "conv2_2", "conv3_3", "conv4_3"))
        state = train_step.init_state(config, seed=SEED, device=dev)
        state, metrics = train_step.make_train_step(vgg, grams, config)(state, batch)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {n: p.detach().cpu() for n, p in state.net.named_parameters()})
    for k, v in out["cuda"][0].items():
        ref = out["cpu"][0][k]
        if not (math.isfinite(v) and abs(v - ref) <= 1e-3 * abs(ref) + 1e-6):
            raise AssertionError(f"{k}: cuda {v} vs cpu {ref}")
    diffs = torch.cat([(out["cuda"][1][n] - p).abs().flatten() for n, p in out["cpu"][1].items()])
    diff, moved = float(diffs.max()), float((diffs > 1e-5).float().mean())
    # an update is below lr in size, so two differ by < 2 lr (plus rounding);
    # only entries whose gradient is near zero may flip sign
    if diff > 2.001 * config.learn_rate or moved > 0.01:
        raise AssertionError(f"params after one step, cuda vs cpu: max diff {diff}, {moved:.2%} beyond 1e-5")
    print(f"one b2@64 recipe step, cuda vs cpu: loss {out['cuda'][0]['loss']:.6g} vs "
          f"{out['cpu'][0]['loss']:.6g}; params max diff {diff:.3e}, {moved:.3%} of entries beyond 1e-5")


def steps_per_sec(vgg_gpu, compute_dtype, iters: int = 10) -> float:
    """Train steps per second at b4@256 (synchronized), after a warm-up step."""
    config = train_step.TrainConfig.make(compute_dtype=compute_dtype)
    grams = slow_style.style_target_grams(
        vgg_gpu, torch.rand(1, 256, 256, 3, device="cuda") * 255, ("conv1_2", "conv2_2", "conv3_3", "conv4_3")
    )
    state = train_step.init_state(config, seed=SEED, device="cuda")
    step = train_step.make_train_step(vgg_gpu, grams, config)
    batch = torch.rand(4, 256, 256, 3, device="cuda") * 255
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        _, metrics = step(state, batch)
    torch.cuda.synchronize()
    rate = iters / (time.perf_counter() - t0)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError("non-finite loss in the timed steps")
    name = "bfloat16" if compute_dtype is not None else "float32"
    print(f"train step b4@256 {name}: {rate:.3f} steps/s ({1e3 / rate:.3f} ms/step)")
    return rate


def main() -> None:
    device_phase()
    build_phase()
    k = kernel_phase()
    s = slice_phase()
    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "faststyle_tpu_torch/csrc/gram.cu",
        "replaces": "faststyle_tpu/ops/pallas/gram.py:22",
        "launches": s["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"],
        "kernel_ms": k["kernel_ms"],
        "device_ms": k["device_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "library_device_ms": k["library_device_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.exit(0)
