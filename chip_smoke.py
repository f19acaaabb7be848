#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faststyle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. device  — requires CUDA; prints the card's name and power limit, turns
               TF32 off for matmuls and cuDNN (full float32 everywhere)
  2. build   — compiles the Gram kernel (nvcc) and the host pack library
               (c++) from faststyle_tpu_torch/csrc, together, and checks
               with cuobjdump that the tile kernels run on the tensor cores
               (HMMA instructions in their SASS)
  3. kernel  — the kernel against its plain PyTorch version, forward and
               gradient, at the b4@256 training shapes and the 474x712
               slow-style shapes in float32 and bf16 and at ragged and
               unaligned shapes; float32 against a float64 Gram, well
               inside 1xTF32's error; two calls bitwise equal
               (determinism); times the kernel, the plain version and
               torch.matmul on the same features, eagerly and on the
               device alone (CUDA graph replays), beside the card's bound
               and the launch plan
  4. slice   — `faststyle_tpu_torch.cli.train` for 6 steps at b4@256, full
               width (random VGG16 weights and synthetic images from a seed),
               with the Gram launch count; one GPU train step against the
               same step on the CPU; steps/s of the train step
  5. serve   — `faststyle_tpu_torch.cli.stylize_image` in float32 against
               the seven TF oracle PNGs (SSIM >= 0.99); uint8 output within
               one count of the CPU Stylizer; bfloat16 against float32
               (SSIM >= 0.98); a TF1 checkpoint written by the port serves
               bit-exact with the .npz; packed-u8 input, output and both
               bit-exact with the plain uint8 path at 1080x1920 and 250x243,
               resize and deconv; --input_dir over three images, two sizes
  6. stream  — `faststyle_tpu_torch.cli.stylize_webcam` on 120 synthetic
               1920x1080 frames in bfloat16 and float32 at pipeline depths 1
               and 2, with --packed_fetch, at 512x512, and through a short
               MJPG video: fps and p50/p99 latency; the forward's device-alone
               ms per frame (CUDA-graph replays)
  7. slow    — `faststyle_tpu_torch.cli.slow_style` for 20 steps on
               chicago.jpg at its native 474x712 (random VGG16), with the Gram
               launch count; 5 steps in bfloat16; 3 steps at 256x256 on the
               card against the CPU from the same start
Every check of a phase prints its reading; a phase raises at its end if
any of its checks failed. Then the `kernels` JSON line, and last the `ok`
line.
"""

from __future__ import annotations

import concurrent.futures
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

from faststyle_tpu_torch import inference
from faststyle_tpu_torch.cli import slow_style as cli_slow
from faststyle_tpu_torch.cli import stylize_image as cli_image
from faststyle_tpu_torch.cli import stylize_webcam as cli_webcam
from faststyle_tpu_torch.cli import train as cli_train
from faststyle_tpu_torch.compat import tf1_checkpoint
from faststyle_tpu_torch.inference import load_params
from faststyle_tpu_torch.models import transform_net, vgg16
from faststyle_tpu_torch.ops.cuda import build, gram
from faststyle_tpu_torch.training import slow_style, train_step
from faststyle_tpu_torch.utils import image_io
from faststyle_tpu_torch.utils.metrics import ssim

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
# slow-style's style layers on chicago.jpg at its native 474x712 (SAME
# pools round up); no row count h*w is a multiple of 32
SLOW_SHAPES = [(1, 474, 712, 64), (1, 237, 356, 128), (1, 119, 178, 256), (1, 60, 89, 512)]
# (shape, dtype, storage offset in elements: 1 breaks the 16-byte alignment);
# the training and slow-style shapes in both dtypes, since both paths run either
CHECK_SHAPES = [(s, dt, 0) for dt in (torch.float32, torch.bfloat16) for s in TRAIN_SHAPES + SLOW_SHAPES] + [
    ((3, 17, 9, 64), torch.float32, 0),
    ((2, 33, 31, 48), torch.float32, 0),
    ((2, 17, 9, 64), torch.float32, 1),
    ((2, 9, 11, 20), torch.bfloat16, 0),
    ((3, 7, 5, 37), torch.bfloat16, 1),
]
# in both dtypes: split (two launches); one launch, mostly off-diagonal tiles
DETERMINISM_SHAPES = [TRAIN_SHAPES[0], TRAIN_SHAPES[3]]
BUILDS = ("gram", "depth_to_space")  # csrc/gram.cu (the kernel), csrc/depth_to_space.cc (host)
# forward: float32 sums over hw in another order than cuBLAS -> 1e-4 of the
# largest entry; gradient: the same matmul formula in f32 (1e-4), and for
# bf16 one bf16 rounding of each entry after it (2^-8 ~ 4e-3 -> 1e-2)
FWD_TOL = 1e-4
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# float32 against a float64 Gram: the kernel's error must stay under
# 1/TF32_MARGIN of the error that rounding the input to TF32 alone gives
# (what a 1xTF32 kernel would show at least), so 3xTF32 is what ran. On an
# H100 the kernel reads 2-3e-6 of max |G| at the training shapes, 1xTF32
# 8e-6 at conv1_2 (the closest) to 8e-5 at conv4_3. At slow-style's conv1_2
# (337488 rows) 1xTF32's random rounding averages down to 2.8e-6 while the
# kernel reads 3.8e-6, so those shapes are held on `tf32_offset` input
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
    """Builds the Gram kernel (nvcc) and the host pack library (c++), both
    compilers started together."""
    phase("build")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        built = dict(zip(BUILDS, pool.map(build.build, BUILDS)))
    gram._lib()  # load and bind
    inference._host_lib()
    for name, (path, seconds) in built.items():
        print(f"built {path.relative_to(REPO)} in {seconds:.2f} s")
    tensor_core_check(built["gram"][0])


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


def tf32_offset(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, then 0.4 of a TF32 ulp larger in magnitude: rounding
    it to TF32 again shrinks every value by that same 0.4 ulp, an error that
    does not average out over rows (1xTF32 is then off by ~5e-4 of max |G|
    at any row count; 3xTF32 carries the offset in its low part)."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return (bits + 0xCCC).view(torch.float32)


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
    slow = {dt: [0.0, 0.0, 0.0] for dt in (torch.float32, torch.bfloat16)}  # device, matmul device, bound
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
        if dtype == torch.float32 and shape in SLOW_SHAPES:
            # over 5e3-3e5 rows random TF32 rounding averages out below the
            # kernel's own float32 summation error: hold it on an input whose
            # rounding to TF32 does not average out
            e64, e1x = tf32_errors(x)
            s64, s1x = tf32_errors(tf32_offset(x))
            if not (s64 * TF32_MARGIN <= s1x):
                raise AssertionError(f"gram {shape}: error against float64 {s64} of max |G| on 0.4-ulp offsets "
                                     f"is not under 1/{TF32_MARGIN} of 1xTF32's {s1x}")
            tf32 = (f" vs_float64: kernel={e64:.3e} 1xTF32={e1x:.3e}, on 0.4-ulp offsets kernel={s64:.3e} "
                    f"1xTF32={s1x:.3e} (of max |G|)")

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
        if shape in SLOW_SHAPES:
            slow[dtype] = [a + b for a, b in zip(slow[dtype], (k_dev, l_dev, b_ms))]
    print(f"gram, the four b4@256 float32 style layers together (one train step's forward): "
          + " ".join(f"{k}={v:.5f}" for k, v in totals.items())
          + f" bound_share={totals['bound_ms'] / totals['device_ms']:.3f}", flush=True)
    for dtype, (k_dev, l_dev, b_ms) in slow.items():
        print(f"gram, the four slow-style {str(dtype).removeprefix('torch.')} style layers together (one "
              f"slow-style step's forward): device_ms={k_dev:.5f} library_device_ms={l_dev:.5f} "
              f"bound_ms={b_ms:.5f} bound_share={b_ms / k_dev:.3f}", flush=True)
    return {"max_abs_err": worst, "bound_by": "bytes" if bytes_ms > ops_ms else "operations", **totals,
            "slow_style_device_ms": slow[torch.float32][0]}


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

ASSETS = REPO / "tests" / "assets"
STARRY = REPO / "weights" / "starry_final.npz"
CANDY = REPO / "weights" / "candy_final.npz"
DECONV = ASSETS / "deconv_oracle_net.npz"
# (name, model, upsample method, content image, crop or None, TF oracle PNG)
ORACLES = [
    ("starry crop256", STARRY, "resize", "chicago_crop256.png", None, "starry_crop256_tf_oracle.png"),
    ("candy crop256", CANDY, "resize", "chicago_crop256.png", None, "candy_crop256_tf_oracle.png"),
    ("starry 512", STARRY, "resize", "chicago_512.png", None, "starry_512_tf_oracle.png"),
    ("starry 474x712", STARRY, "resize", "chicago.jpg", None, "starry_chicago_tf_oracle.png"),
    ("candy 474x712", CANDY, "resize", "chicago.jpg", None, "candy_chicago_tf_oracle.png"),
    ("deconv crop256", DECONV, "deconv", "chicago_crop256.png", None, "deconv_crop256_tf_oracle.png"),
    ("deconv 250x243", DECONV, "deconv", "chicago_crop256.png", (250, 243), "deconv_ragged_tf_oracle.png"),
]
SSIM_MIN = 0.99  # float32 against the TF oracles
SSIM_BF16_MIN = 0.98  # bfloat16 against float32
# (width, height, precision, pipeline depth, packed fetch) of the synthetic streams
STREAMS = [
    (1920, 1080, "bfloat16", 1, False),
    (1920, 1080, "bfloat16", 2, False),
    (1920, 1080, "float32", 1, False),
    (1920, 1080, "float32", 2, False),
    (1920, 1080, "bfloat16", 1, True),
    (1920, 1080, "bfloat16", 2, True),
    (1920, 1080, "float32", 1, True),
    (512, 512, "bfloat16", 1, False),
    (512, 512, "bfloat16", 1, True),
]
STREAM_FRAMES = 120
SLOW_STEPS = 20


class Checks:
    """A phase's checks: each prints its reading; `done` raises if any failed."""

    def __init__(self, name: str):
        self.name, self.failed = name, []

    def __call__(self, ok: bool, msg: str) -> bool:
        print(("  ok   " if ok else "  FAIL ") + msg, flush=True)
        if not ok:
            self.failed.append(msg)
        return ok

    def done(self) -> None:
        if self.failed:
            raise AssertionError(f"{self.name}: {len(self.failed)} check(s) failed: " + " | ".join(self.failed))


def stylize_cli(root: Path, model: Path, method: str, img_path: Path, precision: str = "float32") -> np.ndarray:
    """One run of cli.stylize_image on the card; returns the PNG it wrote."""
    out = root / f"out_{len(list(root.glob('out_*')))}.png"
    cli_image.main(["--input_img_path", str(img_path), "--output_img_path", str(out), "--model_path", str(model),
                    "--upsample_method", method, "--precision", precision])
    return image_io.imread(out)


def count_diff(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """(largest |a - b| in counts, number of values that differ)."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), int((d > 0).sum())


def serve_phase() -> None:
    phase("serve")
    check = Checks("serve")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        root = Path(tmp)
        inputs, outs = {}, {}
        for name, model, method, content, crop, oracle in ORACLES:
            src = ASSETS / content
            if crop is not None:
                src = root / f"content_{crop[0]}x{crop[1]}.png"
                image_io.imwrite(src, image_io.imread(ASSETS / content)[: crop[0], : crop[1]])
            inputs[name] = src
            t0 = time.perf_counter()
            out = outs[name] = stylize_cli(root, model, method, src)
            wall = time.perf_counter() - t0
            golden = image_io.imread(ASSETS / oracle)
            score = ssim(out, golden) if out.shape == golden.shape else float("nan")
            check(score >= SSIM_MIN, f"cli.stylize_image float32 {name}: output {out.shape}, oracle {golden.shape}, "
                                     f"SSIM {score:.5f} (need >= {SSIM_MIN}); {wall:.3f} s wall")

        for name, model, method in (("starry crop256", STARRY, "resize"), ("deconv 250x243", DECONV, "deconv")):
            cpu = inference.Stylizer(model, upsample_method=method, device="cpu")(image_io.imread(inputs[name]))
            worst, n = count_diff(outs[name], cpu)
            check(worst <= 1, f"{name} card vs the CPU float32 Stylizer: max {worst} count(s), "
                              f"{n} of {cpu.size} values differ")

        for name, model in (("starry crop256", STARRY), ("starry 474x712", STARRY)):
            bf = stylize_cli(root, model, "resize", inputs[name], "bfloat16")
            score = ssim(bf, outs[name])
            check(score >= SSIM_BF16_MIN, f"{name} bfloat16 vs float32: SSIM {score:.5f} (need >= {SSIM_BF16_MIN})")

        prefix = root / "tf1" / "starry_final.ckpt"
        tf1_checkpoint.save_transform_net_params(inference.load_params_numpy(STARRY), prefix)
        out = stylize_cli(root, prefix, "resize", inputs["starry crop256"])
        _, n = count_diff(out, outs["starry crop256"])
        check(n == 0, f"starry crop256 from the port's TF1 checkpoint vs the .npz: {n} values differ (need 0)")

        packed_check(check)

        in_dir = root / "dir"
        in_dir.mkdir()
        crop256 = image_io.imread(ASSETS / "chicago_crop256.png")
        image_io.imwrite(in_dir / "a.png", crop256)
        image_io.imwrite(in_dir / "b.png", crop256[::-1])
        image_io.imwrite(in_dir / "c.png", crop256[:250, :243])
        done = cli_image.main(["--input_dir", str(in_dir), "--output_dir", str(root / "dir_out"),
                               "--model_path", str(STARRY)])
        got = {n: image_io.imread(root / "dir_out" / f"styled_{n}.png") for n in "abc"}
        shapes = {n: g.shape for n, g in got.items()}
        worst_a, _ = count_diff(got["a"], outs["starry crop256"])
        single_c = inference.Stylizer(STARRY, output_uint8=True)(crop256[:250, :243])
        worst_c, _ = count_diff(got["c"], single_c)
        check(done == 3 and shapes == {"a": (256, 256, 3), "b": (256, 256, 3), "c": (252, 244, 3)}
              and worst_a <= 1 and worst_c <= 1,
              f"--input_dir: {done} images of two sizes {shapes}; within {max(worst_a, worst_c)} count(s) of "
              "single-image runs")
    check.done()


def packed_check(check: Checks) -> None:
    """Packed-u8 input, output and both against the plain uint8 path on the
    card: bit-exact at 1080x1920 and 250x243, resize and deconv (and resize
    in bfloat16 at 1080x1920)."""
    frames = {
        "1080x1920": image_io.resize_to(image_io.imread(ASSETS / "chicago.jpg"), 1080, 1920),
        "250x243": np.ascontiguousarray(image_io.imread(ASSETS / "chicago_crop256.png")[:250, :243]),
    }
    for model, method in ((STARRY, "resize"), (DECONV, "deconv")):
        params = inference.load_params(model)
        for size, frame in frames.items():
            dtypes = (None, torch.bfloat16) if method == "resize" and size == "1080x1920" else (None,)
            oh, ow = transform_net.output_shape(*frame.shape[:2])
            for dtype in dtypes:
                kw = dict(params=params, upsample_method=method, compute_dtype=dtype)
                plain = inference.Stylizer(output_uint8=True, **kw).stylize_batch(frame[None]).cpu().numpy()
                for pin, pout in ((True, False), (False, True), (True, True)):
                    raw = inference.Stylizer(packed_input=pin, packed_output=pout, **kw).stylize_batch(frame[None])
                    got = inference.unpack_u8_host(raw.cpu().numpy(), oh, ow) if pout else raw.cpu().numpy()
                    _, n = count_diff(got, plain) if got.shape == plain.shape else (None, -1)
                    check(n == 0, f"packed {'in' if pin else '--'}/{'out' if pout else '---'} {method} {size} "
                                  f"{'bfloat16' if dtype else 'float32'}: {tuple(raw.shape)} raw, "
                                  f"{n} values differ from the plain uint8 path (need 0)")


def stream_reading(r: dict) -> str:
    ms = lambda v: "none" if v is None else f"{v:.3f} ms"
    return f"{r['frames']} frames, {r['fps']:.3f} fps, p50 {ms(r['p50_ms'])}, p99 {ms(r['p99_ms'])}"


def stream_phase() -> None:
    phase("stream")
    check = Checks("stream")
    base = ["--model_path", str(STARRY), "--no_display", "--report_latency"]
    for w, h, precision, depth, packed in STREAMS:
        args = base + ["--num_synthetic_frames", str(STREAM_FRAMES), "--resolution", str(w), str(h),
                       "--precision", precision, "--pipeline_depth", str(depth)] + (["--packed_fetch"] if packed else [])
        r = cli_webcam.main(args)
        check(r["frames"] == STREAM_FRAMES and r["fps"] > 0 and r["p99_ms"] is not None,
              f"stream {w}x{h} {precision} depth {depth}{' packed' if packed else ''}: {stream_reading(r)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as tmp:
        import cv2

        root = Path(tmp)
        frames = list(cli_webcam.synthetic_frames(40, 1080, 1920))
        fh, fw = frames[0].shape[:2]
        writer = cv2.VideoWriter(str(root / "in.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (fw, fh))
        for f in frames:
            writer.write(f)
        writer.release()
        r = cli_webcam.main(base + ["--video_path", str(root / "in.avi"), "--max_frames", "30",
                                    "--output_path", str(root / "out.avi")])
        size = (root / "out.avi").stat().st_size if (root / "out.avi").exists() else 0
        check(r["frames"] == 30 and size > 0, f"video {fw}x{fh} MJPG through --video_path --max_frames 30: "
                                              f"{stream_reading(r)}, output {size} bytes")
    # the forward alone on the device: uint8 frame in, uint8 (or packed) out
    for w, h, precision, packed in ((1920, 1080, "bfloat16", False), (1920, 1080, "float32", False),
                                    (1920, 1080, "bfloat16", True), (1920, 1080, "float32", True),
                                    (512, 512, "bfloat16", False), (512, 512, "float32", False)):
        s = inference.Stylizer(STARRY, compute_dtype=torch.bfloat16 if precision == "bfloat16" else None,
                               output_uint8=True, packed_input=packed, packed_output=packed)
        frame = next(cli_webcam.synthetic_frames(1, h, w))[None]
        x = torch.from_numpy(inference.pack_u8_host(frame) if packed else frame).cuda()
        fn = (lambda: s.stylize_device(x, (h, w))) if packed else (lambda: s.stylize_device(x))
        dev = cuda_time_ms(fn, iters=10, graph=True, replays=3)
        eager = cuda_time_ms(fn, iters=10)
        print(f"forward {w}x{h} {precision}{' packed' if packed else ''}: device-alone {dev:.5f} ms/frame, "
              f"eager {eager:.5f} ms/frame", flush=True)
    check.done()


def slow_style_phase() -> dict:
    phase("slow")
    check = Checks("slow")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slow_") as tmp:
        root = Path(tmp)
        vgg_path, _ = write_inputs(root)
        style = REPO / "style_images" / "starry_night_crop.jpg"
        base = ["--style_img_path", str(style), "--vgg_path", str(vgg_path), "--output_img_path", str(root / "o.jpg")]
        gram.GramFunction.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, history = cli_slow.main(base + ["--cont_img_path", str(ASSETS / "chicago.jpg"),
                                             "--num_steps_break", str(SLOW_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gram.GramFunction.launches
        losses = [v for _, v in history]
        print(f"cli.slow_style: {SLOW_STEPS} steps at 474x712 float32 in {wall:.3f} s wall (targets included), "
              f"losses {history}, output {out.shape}")
        want = 4 * SLOW_STEPS + 4  # four style layers per step, plus the target Grams once
        check(launches >= want, f"gram launches on the slow-style path: {launches} (need >= {want})")
        check(all(math.isfinite(v) for v in losses) and len(losses) >= 2 and losses[-1] < losses[0],
              f"slow-style losses finite and falling: {losses}")

        out, history = cli_slow.main(base + ["--cont_img_path", str(ASSETS / "chicago.jpg"),
                                             "--num_steps_break", "5", "--precision", "bfloat16"])
        check(all(math.isfinite(v) for _, v in history), f"slow-style bfloat16, 5 steps: losses {history}")

        content = image_io.imread(ASSETS / "chicago_crop256.png").astype(np.float32)
        style_img = image_io.imresize(image_io.imread(style), 0.25).astype(np.float32)
        init = np.random.default_rng(SEED).uniform(0, 255, (1, 256, 256, 3)).astype(np.float32)
        logs = {}
        for dev in ("cuda", "cpu"):
            logs[dev] = []
            slow_style.optimize(
                vgg16.load_npz(vgg_path, device=dev), content, style_img,
                content_weights={"conv3_3": 1.0}, style_weights=dict.fromkeys(("conv1_2", "conv2_2", "conv3_3",
                                                                               "conv4_3"), 5.0),
                num_steps=3, log_every=1, init=init, log_fn=lambda s, v, d=dev: logs[d].append(v),
            )
        rel = [abs(a - b) / abs(b) for a, b in zip(logs["cuda"], logs["cpu"])]
        check(len(rel) == 3 and max(rel) <= 1e-3, f"slow-style 3 steps at 256x256, card vs CPU from one start: "
                                                  f"cuda {logs['cuda']} cpu {logs['cpu']}, relative {rel} (need <= 1e-3)")
    check.done()
    return {"launches": launches}


def main() -> None:
    device_phase()
    build_phase()
    k = kernel_phase()
    s = slice_phase()
    serve_phase()
    stream_phase()
    ss = slow_style_phase()
    print(f"gram launches: {s['launches']} on the train slice, {ss['launches']} on slow-style")
    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "faststyle_tpu_torch/csrc/gram.cu",
        "replaces": "faststyle_tpu/ops/pallas/gram.py:22",
        "launches": s["launches"] + ss["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"],
        "kernel_ms": k["kernel_ms"],
        "device_ms": k["device_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "library_device_ms": k["library_device_ms"],
        "slow_style_device_ms": k["slow_style_device_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
    sys.exit(0)
