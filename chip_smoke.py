#!/usr/bin/env python3
"""Smoke run of the PyTorch port (faststyle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py              # every phase, then the kernels and ok lines
    python3 chip_smoke.py wgrad repro  # device, build, then only the named phases; no ok line

Phases, each raising on failure (the script then exits non-zero):
  1. device  — requires CUDA; prints the card's name and power limit, turns
               TF32 off for matmuls and cuDNN (full float32 everywhere)
  2. build   — compiles the Gram, weight-gradient, instance-norm and direct-conv kernels
               (nvcc), the host pack library and the TFRecord codec (c++) from
               faststyle_tpu_torch/csrc, all together, and checks with
               cuobjdump that the tile kernels run on the tensor cores (HMMA
               instructions in their SASS)
  3. kernel  — the Gram kernel against its plain PyTorch version, forward and
               gradient, at the b4@256 training shapes and the 474x712
               slow-style shapes in float32 and bf16 and at ragged and
               unaligned shapes; float32 against a float64 Gram, well
               inside 1xTF32's error; two calls bitwise equal
               (determinism); times the kernel, the plain version and
               torch.matmul on the same features, eagerly and on the
               device alone (CUDA graph replays), beside the card's bound
               and the launch plan
  4. wgrad   — the weight-gradient kernel (conv_wgrad) against float64 at the
               transform net's 16 b4@256 shapes in float32 (under 2e-5 of
               max |dW| and half of 1xTF32's error) and bf16 (1e-2) and at
               ragged shapes, each in the design the rule gives it (strip
               or tile); two calls bitwise equal; device-alone times
               beside cuDNN's default and deterministic weight gradients,
               the plain version and the bound, and at the strip shapes
               the tile design's time too
  4b. norm   — the instance-norm kernel pair (ops/cuda/instance_norm) at
               the 16 norms of a 3840x2160 frame, bfloat16 and float32,
               each with the epilogue the serving walk fuses there, and
               every epilogue at a ragged and an unaligned shape: moments
               within 1e-5 of float64's, the output equal to the plain
               chain's given the kernels' moments, two calls bitwise
               equal; device-alone ms beside the byte bound (6 B an
               element in bf16, 12 in float32) and the plain version's;
               a 4K packed-u8 bf16 frame's pair launches (16), its
               device-alone ms with the norms fused and plain, and how far
               the two frames differ. AdaIN's content norm: C = 512 at a
               4K frame's relu4_1 (270x480) and ragged shapes, bf16 and
               float32, eps 1e-5, the unbiased variance, a style's sigma
               and mean as the affine, held the same way (and an
               unaligned tensor against the plain version); a 4K
               packed-u8 bf16 AdaIN frame (seeded weights, the candy
               style) against the float32 plain reference
               (faststyle_tpu_torch/reference/adain.py): one pair launch,
               its device-alone ms, the mean and worst difference in
               counts and the share of clipped pixels
  4c. conv   — the direct 9x9 conv kernel (ops/cuda/direct_conv) at the
               4K walk's two 9x9s (initconv_0 3->16 over 2240x3920,
               upsample_2 16->3 over 2160x3840), ragged shapes (1x1, 7x5,
               several images, odd extents, unaligned) and a 4-way
               `parallel.spatial` row window: within one bf16 rounding of
               the float32 conv of the same values, two calls bitwise
               equal; at 4K, device-alone ms (L2 flushed) beside the byte
               bound, the plain version's and cuDNN's bf16 conv of the
               same call; then each of the serving walk's 16 convs at 4K
               through `layers.conv2d` as the walk calls it, device alone
               and cold, beside its least time, with the kernels one call
               runs (the phase 4b frame counts 2 direct-conv launches and
               times the frame with cuDNN's 9x9s too)
  5. repro   — with no determinism flag set: two default `cli.train` 3-step
               runs in fresh processes, float32 and bfloat16, bit-equal;
               every convolution of the f32 and bf16 steps run twice
               through the port's conv2d (0 may differ); per convolution of the f32 and bf16
               step, device-alone ms of the forward, cuDNN's default and
               deterministic data and weight gradients, the data gradient
               as forward convs and the kernel; ms/step of the default
  6. slice   — `faststyle_tpu_torch.cli.train` for 6 steps at b4@256, full
               width (random VGG16 weights and synthetic images from a seed),
               with the Gram launch count; one GPU train step against the
               same step on the CPU; steps/s of the train step
  7. records — `faststyle_tpu_torch.cli.tfrecords_writer` turns 64
               synthetic 640x480 JPEGs, a PNG and a grayscale JPEG into 4
               shards (C++ scan with CRCs against the plain Python reader, a
               flipped byte raises); `cli.train --train_dir` for 6 steps at
               b4@256 with the Gram launch count; `--data_parallel` for 3
               steps through `torch.distributed.run` (one NCCL rank)
               bit-equal to two plain 3-step runs, no flag set;
               `--debug_nans` clean, and a NaN batch
               raising FloatingPointError; the fused content tower against
               the plain step, then both timed in float32 and bfloat16; the
               Batchers' images/s
  8. distill — `tools.make_training_images` (64 images), then
               `tools.distill_validation` 100 --layerwise and 100 --gram_w 1
               --ema_decay 0.999 steps at b4@256 bf16 from starry: the
               layerwise loss falls, Gram and conv_wgrad launch counts, the
               saved student served by the Stylizer; one card distill step
               against the CPU (1e-3); two 20-step runs bit-equal
  9. serve   — `faststyle_tpu_torch.cli.stylize_image` in float32 against
               the seven TF oracle PNGs (SSIM >= 0.99); uint8 output within
               one count of the CPU Stylizer; bfloat16 against float32
               (SSIM >= 0.98); a TF1 checkpoint written by the port serves
               bit-exact with the .npz; packed-u8 input, output and both
               bit-exact with the plain uint8 path at 1080x1920 and 250x243,
               resize and deconv; --input_dir over three images, two sizes
               (ShardedStylizer over every visible card)
 10. parallel — ShardedStylizer over ["cuda:0"] * 2 against the single-card
               Stylizer (float32 1e-2, uint8 one count, packed I/O
               bit-exact with its uint8 path); SpatialStylizer over
               ["cuda:0"] * 4 on a 4K frame (4-way) and a 1080p deconv
               frame (3-way) within 5e-2 of the single-card forward, 4K in
               bfloat16 (SSIM >= 0.99), with 4K ms/frame single and 4-way
               as readings; `cli.stylize_image --spatial` (1-way) against
               the plain CLI; `parallel.dryrun.run(1)` with its Gram
               launch count
 11. stream  — `faststyle_tpu_torch.cli.stylize_webcam` on 120 synthetic
               1920x1080 frames in bfloat16 and float32 at pipeline depths 1
               and 2, with --packed_fetch, at 512x512, and through a short
               MJPG video: fps and p50/p99 latency; the forward's device-alone
               ms per frame (CUDA-graph replays); every run's instance-norm
               pair launches, 16 a forward
 12. slow    — `faststyle_tpu_torch.cli.slow_style` for 20 steps on
               chicago.jpg at its native 474x712 (random VGG16), with the Gram
               launch count, twice (bit-equal); 5 steps in bfloat16; 3 steps at 256x256 on the
               card against the CPU from the same start
 13. bench   — `python3 -m faststyle_tpu_torch.bench --quick --skip_gate`
               in bfloat16 and in float32, then `--dp --quick`, each in its
               own process (the bench's gate runs this script, hence
               --skip_gate): each JSON line printed, its value positive, the
               card's name and power limit in it, the Gram launches 4 a timed
               train and DP step and 4 a slow-style step (plus the 4 target
               Grams), the conv_wgrad launches the rule's count a timed f32
               step (6) and none in bf16 or slow-style
Every check of a phase prints its reading; a phase raises at its end if
any of its checks failed. Then the `kernels` JSON line, and last the `ok`
line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import functools
import io
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
from faststyle_tpu_torch.data import pipeline, tfrecord
from faststyle_tpu_torch.inference import load_params
from faststyle_tpu_torch.models import transform_net, vgg16
from faststyle_tpu_torch.ops import layers
from faststyle_tpu_torch.ops import conv_grad
from faststyle_tpu_torch.ops.cuda import build, conv_wgrad, direct_conv, gram
from faststyle_tpu_torch.ops.cuda import instance_norm
from faststyle_tpu_torch.parallel import data_parallel, dryrun, spatial
from faststyle_tpu_torch.tools import distill_validation as distill
from faststyle_tpu_torch.tools import make_training_images
from faststyle_tpu_torch.training import loop, slow_style, train_step
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
FFMA_PEAK = 67e12  # FP32 outside the tensor cores: a second, labelled reading beside the bounds
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
# csrc/gram.cu, csrc/conv_wgrad.cu, csrc/instance_norm.cu and csrc/direct_conv.cu (the kernels);
# csrc/depth_to_space.cc and csrc/tfrecord_io.cc (host)
BUILDS = ("gram", "conv_wgrad", "instance_norm", "direct_conv", "depth_to_space", "tfrecord_io")
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
    """Builds the Gram and weight-gradient kernels (nvcc), the host pack
    library and the TFRecord codec (c++), every compiler started together."""
    phase("build")
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as pool:
        built = dict(zip(BUILDS, pool.map(build.build, BUILDS)))
    gram._lib()  # load and bind
    conv_wgrad._lib()
    instance_norm._lib()
    direct_conv._lib()
    inference._host_lib()
    tfrecord._lib()
    for name, (path, seconds) in built.items():
        print(f"built {path.relative_to(REPO)} in {seconds:.2f} s")
    tensor_core_check(built["gram"][0], "gram_")
    tensor_core_check(built["conv_wgrad"][0], "wgrad_", ("tile", "strip", "strip_kn"))
    print_usage(built["instance_norm"][0], "instance_norm_")
    tensor_core_check(built["direct_conv"][0], "direct_conv", ("", "_kn"))


def cuobjdump(lib_path: Path, flag: str) -> str:
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), flag, str(lib_path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout


def print_usage(lib_path: Path, prefix: str, hmma: dict | None = None) -> None:
    """Each kernel `<prefix>...` in the built library: its registers,
    static shared and local-memory bytes (spills) from cuobjdump, and its
    HMMA count when `hmma` has it."""
    name = None  # cuobjdump prints a function's name, then (maybe on the next line) its usage
    for line in cuobjdump(lib_path, "-res-usage").splitlines():
        if m := re.search(r"Function (\S+):", line):
            name = m.group(1)
        if (u := re.search(r"REG:(\d+).*?SHARED:(\d+).*?LOCAL:(\d+)", line)) and name and prefix in name:
            print(f"  {name[name.index(prefix):]}: registers {u[1]}, static shared {u[2]} B, "
                  f"local (spills) {u[3]} B" + ("" if hmma is None else f", HMMA {hmma.get(name, 0)}"))
            name = None


def tensor_core_check(lib_path: Path, prefix: str, designs=("tile",)) -> None:
    """Raises unless every kernel `<prefix><design>_kernel` in the built
    library has HMMA (tensor-core) instructions in its SASS, and each design
    has one; prints each kernel's registers and local-memory bytes (spills)
    from cuobjdump."""
    hmma = {}
    for block in cuobjdump(lib_path, "-sass").split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        hmma[name.strip()] = len(re.findall(r"\bHMMA\.", body))
    tiles = {n: k for n, k in hmma.items() if any(f"{prefix}{d}_kernel" in n for d in designs)}
    missing = [d for d in designs if not any(f"{prefix}{d}_kernel" in n for n in tiles)]
    if missing:
        raise AssertionError(f"no {prefix}kernel of design {missing} in {lib_path.name}")
    print_usage(lib_path, prefix, hmma)
    if not tiles or min(tiles.values()) == 0:
        raise AssertionError(f"{prefix}{'/'.join(designs)} kernels without HMMA in their SASS: {tiles}")
    print(f"tensor cores: {len(tiles)} {prefix}{'/'.join(designs)} kernels, each with HMMA "
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


def transform_wgrads(n: int = 4, size: int = 256) -> list:
    """(x NHWC shape, (kh, kw), stride, (ph, pw), co) of the transform net's
    16 weight gradients in a b{n}@{size} train step, as Conv2dFunction gets
    them: a stride-2 SAME conv on an even extent arrives padded (0, 1)."""
    h = size + 80
    out = [((n, h, h, 3), (9, 9), 1, (4, 4), 16)]
    for ci, co in ((16, 32), (32, 64)):
        lo, hi = layers._same_pads(h, 3, 2)
        out.append(((n, h, h, ci), (3, 3), 2, (lo, lo), co) if lo == hi
                   else ((n, h + lo + hi, h + lo + hi, ci), (3, 3), 2, (0, 0), co))
        h = -(-h // 2)
    for _ in range(10):  # five resblocks, two VALID convs each
        out.append(((n, h, h, 64), (3, 3), 1, (0, 0), 64))
        h -= 2
    for ci, co in ((64, 32), (32, 16)):  # the upsample phase convs over x padded by one
        out.append(((n, h + 1, h + 1, ci), (2, 2), 1, (0, 0), 4 * co))
        h *= 2
    out.append(((n, h, h, 16), (9, 9), 1, (4, 4), 3))
    return out


def wgrad_name(i: int) -> str:
    return ["init_0", "init_1", "init_2"][i] if i < 3 else (
        f"res{(i - 3) // 2}_{(i - 3) % 2 + 1}" if i < 13 else ["up_0", "up_1", "final"][i - 13])


def wgrads_per_step(dtype=torch.float32) -> int:
    """How many of a train step's 16 weight gradients launch the kernel
    (conv_grad.wgrad_by_kernel's rule; the rest take cuDNN's deterministic
    algorithm)."""
    return sum(conv_grad.wgrad_by_kernel((co, shape[3], *kernel), stride, dtype)
               for shape, kernel, stride, _, co in transform_wgrads())


# ragged: im2col width and co past one tile, odd extents, stride 2 with a symmetric pad;
# the 9x9 pad-4 ones (the strip design) with strips cut by both odd extents
WGRAD_RAGGED = [((3, 37, 29, 5), (3, 3), 2, (1, 1), 70), ((2, 19, 23, 3), (9, 9), 1, (4, 4), 3),
                ((3, 41, 35, 3), (9, 9), 1, (4, 4), 16)]
WGRAD_F32_TOL = 2e-5  # of max |dW| against float64: float32 sums over 1e5-5e5 rows in fixed blocks
WGRAD_BF16_TOL = 1e-2  # of max |dW|: bf16 inputs, f32 sums, against float64 of the same bf16 values


def wgrad_bound(shape, kernel, stride, pad, co, dtype) -> tuple[float, float, float]:
    """(ms to move the bytes, ms to do the operations, ms for the operations
    at FFMA's peak) of one weight gradient: X and dY read once, dW written
    once in float32; 2*rows*p*co FLOP in the kernel's tensor-core passes
    (float32 as 3xTF32, as the Gram's `bound`) at the peak for their type.
    The third time is a second reading for float32 only: the rate of the
    FP32 units that the kernel does not use."""
    n, h, w, ci = shape
    oh, ow = conv_wgrad.out_size(h, kernel[0], stride, pad[0]), conv_wgrad.out_size(w, kernel[1], stride, pad[1])
    p = kernel[0] * kernel[1] * ci
    elem = torch.finfo(dtype).bits // 8
    nbytes = (n * h * w * ci + n * oh * ow * co) * elem + p * co * 4
    flops = 2 * n * oh * ow * p * co
    return (nbytes / HBM_BYTES_PER_S * 1e3, PASSES[dtype] * flops / TENSOR_PEAK[dtype] * 1e3,
            flops / FFMA_PEAK * 1e3)


def cudnn_wgrad(x, dy, w_shape, stride, pad):
    """cuDNN's weight gradient alone (NCHW views of NHWC tensors)."""
    w = torch.empty(w_shape, device=x.device, dtype=x.dtype)
    return torch.ops.aten.convolution_backward(dy, x, w, None, [stride] * 2, list(pad), [1, 1], False, [0, 0], 1,
                                               [False, True, False])[1]


def strip_note(sp) -> str:
    """A strip plan in one phrase: its form and geometry."""
    return (f"[{'kw on N' if sp.form == 'kn' else 'pixels on K'}] {sp.r}x{sp.wt} patch {sp.pr}x{sp.pc} "
            f"smem {sp.smem} B blocks={sp.blocks} strips/block={sp.per} mt={sp.mt} swz={sp.swz} "
            f"launches={sp.launches}")


def wgrad_phase() -> dict:
    """The weight-gradient kernel against its plain version and float64 at
    the transform net's 16 b4@256 shapes in float32 and bf16 and at ragged
    ones; two calls bitwise equal; device-alone times beside cuDNN's default
    and deterministic weight gradients and the bound."""
    phase("wgrad")
    check = Checks("wgrad")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    sms = conv_wgrad.num_sms(torch.cuda.current_device())
    totals = {dt: dict.fromkeys(("kernel", "cudnn", "cudnn_det", "routed", "plain", "bytes", "ops", "ffma_ops"), 0.0)
              for dt in (torch.float32, torch.bfloat16)}
    worst = 0.0
    strip_ms, tile_ms = {}, {}  # the two 9x9 shapes in float32: the strip design and the tile design
    shapes = [(wgrad_name(i), s) for i, s in enumerate(transform_wgrads())] + [
        (f"ragged{i}", s) for i, s in enumerate(WGRAD_RAGGED)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, (shape, kernel, stride, pad, co) in shapes:
            n, h, w, ci = shape
            oh, ow = conv_wgrad.out_size(h, kernel[0], stride, pad[0]), conv_wgrad.out_size(w, kernel[1], stride, pad[1])
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            dy = torch.randn((n, oh, ow, co), generator=gen, device="cuda").to(dtype)
            got = conv_wgrad.conv_weight_grad_cuda(x, dy, kernel, stride, pad)
            ref64 = conv_wgrad.conv_weight_grad_plain(x.double(), dy.double(), kernel, stride, pad)
            scale = float(ref64.abs().max())
            err = float((got.double() - ref64).abs().max()) / scale
            again = conv_wgrad.conv_weight_grad_cuda(x, dy, kernel, stride, pad)
            same = torch.equal(got, again)
            dt = str(dtype).removeprefix("torch.")
            if dtype == torch.float32:
                plain_err = float((conv_wgrad.conv_weight_grad_plain(x, dy, kernel, stride, pad).double() - ref64)
                                  .abs().max()) / scale
                tf32 = lambda t: ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32).double()
                e1x = float((conv_wgrad.conv_weight_grad_plain(tf32(x), tf32(dy), kernel, stride, pad) - ref64)
                            .abs().max()) / scale
                ok = err <= WGRAD_F32_TOL and 2 * err <= e1x
                note = f"vs float64 {err:.3e} (need <= {WGRAD_F32_TOL} and under half of 1xTF32's {e1x:.3e}; " \
                       f"the plain float32 product {plain_err:.3e})"
            else:
                ok = err <= WGRAD_BF16_TOL
                note = f"vs float64 of the same bf16 values {err:.3e} (need <= {WGRAD_BF16_TOL})"
            worst = max(worst, err) if dtype == torch.float32 else worst
            in_bytes = (x.numel() + dy.numel()) * x.element_size()
            design = conv_wgrad.design(*kernel, ci, co, dtype)
            if design == "strip":
                sp = conv_wgrad.strip_plan(n, oh, ow, ci, co, *kernel, stride, in_bytes, sms)
                plan_note = f"strip {strip_note(sp)}"
            else:
                pl = conv_wgrad.plan(n * oh * ow, kernel[0] * kernel[1] * ci, co, in_bytes, sms)
                plan_note = (f"splits={pl.splits} chunk={pl.chunk} tile_c={pl.tile_c} blocks={pl.blocks} "
                             f"launches={pl.launches}")
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            w_shape = (co, ci, *kernel)
            k_ms = cuda_time_ms(lambda: conv_wgrad.conv_weight_grad_cuda(x, dy, kernel, stride, pad), graph=True)
            tile_note = ""
            if design == "strip":  # the tile design and every strip form at the same shape, in the same call
                tiled = conv_wgrad.conv_weight_grad_cuda(x, dy, kernel, stride, pad, design="tile")
                tile_err = float((tiled.double() - ref64).abs().max()) / scale
                t_ms = cuda_time_ms(lambda: conv_wgrad.conv_weight_grad_cuda(x, dy, kernel, stride, pad,
                                                                             design="tile"), graph=True)
                tile_note = f", tile design {t_ms:.5f} (vs float64 {tile_err:.3e})"
                for form in conv_wgrad.strip_forms(*kernel, ci, co, stride):
                    run = functools.partial(conv_wgrad.conv_weight_grad_cuda, x, dy, kernel, stride, pad,
                                            design="strip", form=form)
                    f_got = run()
                    f_err = float((f_got.double() - ref64).abs().max()) / scale
                    f_same = torch.equal(f_got, run())
                    ok = ok and f_err <= WGRAD_F32_TOL and 2 * f_err <= e1x and f_same
                    f_ms = cuda_time_ms(run, graph=True)
                    fp = conv_wgrad.strip_plan(n, oh, ow, ci, co, *kernel, stride, in_bytes, sms, form)
                    tile_note += (f"; strip form {strip_note(fp)}{' (the rule)' if fp == sp else ''}: "
                                  f"{f_ms:.5f} ms, vs float64 {f_err:.3e}, bit-equal {f_same}")
                if name in ("init_0", "final"):
                    strip_ms[name], tile_ms[name] = k_ms, t_ms
            c_ms = cuda_time_ms(lambda: cudnn_wgrad(xn, dyn, w_shape, stride, pad), graph=True)
            with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
                d_ms = cuda_time_ms(lambda: cudnn_wgrad(xn, dyn, w_shape, stride, pad), graph=True)
            p_ms = cuda_time_ms(lambda: conv_wgrad.conv_weight_grad_plain(x, dy, kernel, stride, pad), iters=3)
            t_bytes, t_ops, t_ffma = wgrad_bound(shape, kernel, stride, pad, co, dtype)
            b_ms = max(t_bytes, t_ops)
            by_kernel = conv_grad.wgrad_by_kernel(w_shape, stride, dtype)
            check(ok and same, f"conv_wgrad {name} x {list(shape)} k{kernel[0]}x{kernel[1]} s{stride} p{pad[0]} "
                               f"co {co} {dt} design {design} (the step takes "
                               f"{'the kernel' if by_kernel else 'cuDNN deterministic'}): {note}; two calls "
                               f"bit-equal {same}; device-alone kernel {k_ms:.5f} ms{tile_note}, cuDNN default "
                               f"{c_ms:.5f}, cuDNN deterministic {d_ms:.5f}, plain (eager) {p_ms:.5f}, bound "
                               f"{b_ms:.5f} ({'bytes' if t_bytes > t_ops else 'operations'}) share "
                               f"{b_ms / k_ms:.3f}; plan {plan_note}")
            if not name.startswith("ragged"):
                tot = totals[dtype]
                for key, val in (("kernel", k_ms), ("cudnn", c_ms), ("cudnn_det", d_ms),
                                 ("routed", k_ms if by_kernel else d_ms), ("plain", p_ms),
                                 ("bytes", t_bytes), ("ops", t_ops), ("ffma_ops", t_ffma)):
                    tot[key] += val
            del x, dy, got, again, ref64
    for dtype, tot in totals.items():
        tot["bound"] = max(tot["bytes"], tot["ops"])
        print(f"conv_wgrad, the transform net's 16 weight gradients of one b4@256 step, "
              f"{str(dtype).removeprefix('torch.')}: " + " ".join(f"{k}_ms={v:.5f}" for k, v in tot.items()), flush=True)
    check.done()
    f32 = totals[torch.float32]
    return {"max_abs_err": worst, "ms": f32["kernel"], "plain_ms": f32["plain"], "bound_ms": f32["bound"],
            "bound_by": "bytes" if f32["bytes"] > f32["ops"] else "operations", "library_ms": f32["cudnn"],
            "library_deterministic_ms": f32["cudnn_det"], "bfloat16_ms": totals[torch.bfloat16]["kernel"],
            "ffma_bound_ms": f32["ffma_ops"], "strip_ms": strip_ms, "tile_ms": tile_ms}


# the 16 norms of a 3840x2160 frame as the serving walk meets them: (h, w,
# c, the epilogue fused there)
NORM_SHAPES_4K = ([(2240, 3920, 16, "relu"), (1120, 1960, 32, "relu"), (560, 980, 64, "relu")]
                  + [(560 - 2 * k, 980 - 2 * k, 64, "relu" if k % 2 else "residual") for k in range(1, 11)]
                  + [(1080, 1920, 32, "relu"), (2160, 3840, 16, "relu"), (2160, 3840, 3, "tanh_u8")])
# every epilogue at these: (shape, storage offset in elements: 1 breaks the
# 16-byte alignment, so the kernels take one element a load)
NORM_RAGGED = [((2, 37, 53, 16), 0), ((3, 21, 11, 3), 0), ((2, 19, 23, 64), 1), ((1, 9, 7, 32), 1)]
NORM_STATS_RTOL = 1e-5  # moments against float64's
# AdaIN's content norm at a 3840x2160 frame's relu4_1, and ragged shapes
# (shape, storage offset); an offset of 1 goes through the entry point's
# aligned copy (C = 512 needs whole 16-byte vectors)
ADAIN_NORM_4K = (1, 270, 480, 512)
ADAIN_NORM_RAGGED = [((2, 7, 9, 512), 0), ((1, 3, 5, 512), 0), ((1, 17, 23, 512), 1)]
NORMS_A_FORWARD = len(NORM_SHAPES_4K)  # the pair's launches in one serving forward
CONVS_A_FORWARD = 2  # the direct conv's launches in one bf16 serving forward: initconv_0, upsample_2


def norm_inputs(shape, dtype, gen, offset: int = 0):
    """x like a conv's output (per-channel offsets up to 8 and spreads
    0.5-4.5), scale, shift, and a skip of x's dtype with 2 more pixels on
    each side, each from a flat buffer whose [offset:] holds it."""
    n, h, w, c = shape
    base = torch.randn(c, generator=gen, device="cuda") * 8
    spread = 0.5 + 4 * torch.rand(c, generator=gen, device="cuda")
    x = storage(shape, torch.float32, offset, gen)
    x = (x[offset:].view(shape) * spread + base).to(dtype)
    buf = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
    buf[offset:].view(shape).copy_(x)
    skip = storage((n, h + 4, w + 4, c), dtype, offset, gen)[offset:].view(n, h + 4, w + 4, c)
    scale = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    shift = torch.randn(c, generator=gen, device="cuda")
    return buf[offset:].view(shape), scale, shift, skip


def norm_check(x, scale, shift, skip, epilogue: str, label: str, eps: float = 1e-3,
               correction: int = 0) -> tuple[float, float, float]:
    """Raises unless the kernels' moments are within NORM_STATS_RTOL of
    float64's, their output equals the plain chain's on those moments, and
    two calls give the same bits; returns (mean error, variance error,
    share of outputs that differ from the plain version on var_mean's
    moments)."""
    skip = skip if epilogue == "residual" else None
    mean, rstd = instance_norm.stats_cuda(x, None, eps, correction)
    x64 = x.double()
    var64, mean64 = torch.var_mean(x64, dim=(1, 2), correction=correction)
    del x64
    var = 1.0 / rstd.double() ** 2 - eps
    m_err = float(((mean - mean64).abs() / (mean64.abs() + var64.sqrt())).max())
    v_err = float(((var - var64).abs() / var64).max())
    r_err = float(((rstd - (var64 + eps).rsqrt()).abs() * (var64 + eps).sqrt()).max())
    if not max(m_err, v_err, r_err) <= NORM_STATS_RTOL:
        raise AssertionError(f"instance norm {label}: moments off float64's: mean {m_err:.3e}, variance "
                             f"{v_err:.3e}, rstd {r_err:.3e} (limit {NORM_STATS_RTOL})")
    args = (x, scale, shift, epilogue, skip)
    out = instance_norm.instance_norm_epilogue(*args, eps=eps, correction=correction)
    twin = instance_norm.instance_norm_epilogue_plain(*args, stats=(mean, rstd), eps=eps, correction=correction)
    if not torch.equal(out, twin):
        bad = int((out != twin).sum())
        raise AssertionError(f"instance norm {label}: {bad} outputs differ from the plain chain on the kernels' "
                             f"moments")
    if not torch.equal(out, instance_norm.instance_norm_epilogue(*args, eps=eps, correction=correction)):
        raise AssertionError(f"instance norm {label}: two calls on the same input differ")
    plain = instance_norm.instance_norm_epilogue_plain(*args, eps=eps, correction=correction)
    differ = float((out != plain).double().mean())
    torch.cuda.synchronize()
    return m_err, v_err, differ


def norm_phase() -> dict:
    phase("norm")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = {dt: dict.fromkeys(("device_ms", "plain_ms", "bound_ms"), 0.0) for dt in (torch.bfloat16, torch.float32)}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for shape, offset in NORM_RAGGED:
            x, scale, shift, skip = norm_inputs(shape, dtype, gen, offset)
            for epilogue in instance_norm.EPILOGUES:
                label = f"{list(shape)} {name} offset {offset} {epilogue}"
                m_err, v_err, differ = norm_check(x, scale, shift, skip, epilogue, label)
                print(f"instance norm {label}: vec={instance_norm.vector_width(x, skip)} mean_err={m_err:.2e} "
                      f"var_err={v_err:.2e} equal on its moments; differs from var_mean's on {differ:.2e}",
                      flush=True)
        for h, w, c, epilogue in NORM_SHAPES_4K:
            shape = (1, h, w, c)
            x, scale, shift, skip = norm_inputs(shape, dtype, gen)
            skip = skip if epilogue == "residual" else None
            label = f"{list(shape)} {name} {epilogue}"
            m_err, v_err, differ = norm_check(x, scale, shift, skip, epilogue, label)
            fused = lambda: instance_norm.instance_norm_epilogue(x, scale, shift, epilogue, skip)
            plain = lambda: instance_norm.instance_norm_epilogue_plain(x, scale, shift, epilogue, skip)
            k_dev = cuda_time_ms(fused, iters=5, warmup=2, graph=True, replays=4)
            p_dev = cuda_time_ms(plain, iters=3, warmup=1, graph=True, replays=3)
            elem = x.element_size()
            nbytes = x.numel() * (2 * elem + (1 if epilogue == "tanh_u8" else elem) + (elem if skip is not None
                                                                                     else 0))
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            p = instance_norm._plan_for(x, epilogue, skip)
            print(f"instance norm {label}: mean_err={m_err:.2e} var_err={v_err:.2e} equal on its moments; differs "
                  f"from var_mean's on {differ:.2e}; kernel_dev_ms={k_dev:.5f} plain_dev_ms={p_dev:.5f} "
                  f"bound_ms={b_ms:.5f} (bytes) bound_share={b_ms / k_dev:.3f} plan: vec={p.vec} "
                  f"splits={p.splits} slab={p.slab} blocks={p.blocks}", flush=True)
            for key, val in zip(("device_ms", "plain_ms", "bound_ms"), (k_dev, p_dev, b_ms)):
                totals[dtype][key] += val
            del x, skip
        t = totals[dtype]
        print(f"instance norm, the 16 norms of a 3840x2160 frame in {name}: "
              + " ".join(f"{k}={v:.5f}" for k, v in t.items()) + f" bound_share={t['bound_ms'] / t['device_ms']:.3f}"
              + " launches=48 (3 a norm)", flush=True)
    torch.cuda.empty_cache()
    frame = frame_fused_against_plain()
    torch.cuda.empty_cache()
    adain_norms = adain_norm_checks(gen)
    adain_out = adain_frame_against_reference()
    return {**{k: v for k, v in totals[torch.bfloat16].items()},
            "float32_device_ms": totals[torch.float32]["device_ms"], **frame, **adain_norms, **adain_out}


def style_affine(c: int, gen):
    """A style's sigma (positive, 0.2 to 4) and mean, [c] float32 each."""
    return 0.2 + 3.8 * torch.rand(c, generator=gen, device="cuda"), 2 * torch.randn(c, generator=gen, device="cuda")


def adain_norm_checks(gen) -> dict:
    """AdaIN's content norm (C = 512, eps 1e-5, the unbiased variance, the
    style's sigma and mean as scale and shift, no epilogue): the 4K relu4_1
    shape, timed beside its byte bound and the plain version, and ragged
    shapes, in both dtypes; an unaligned tensor (the entry point's aligned
    copy) against the plain version, whose moments it shares in float64 to
    1e-5."""
    eps, corr = 1e-5, 1
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for shape, offset in ADAIN_NORM_RAGGED + [(ADAIN_NORM_4K, 0)]:
            x, _, _, _ = norm_inputs(shape, dtype, gen, offset)
            sigma, mu = style_affine(shape[-1], gen)
            label = f"AdaIN {list(shape)} {name} offset {offset}"
            if offset:
                fused = instance_norm.instance_norm_epilogue(x, sigma, mu, "none", eps=eps, correction=corr)
                plain = instance_norm.instance_norm_epilogue_plain(x, sigma, mu, "none", eps=eps, correction=corr)
                err = float(((fused.float() - plain.float()).abs() / (plain.float().abs() + sigma)).max())
                print(f"instance norm {label}: vec={instance_norm.vector_width(x, None)} (an aligned copy) against "
                      f"the plain version: worst |diff| / (|y| + sigma) {err:.2e}", flush=True)
                if not err <= (1e-2 if dtype == torch.bfloat16 else 1e-5):
                    raise AssertionError(f"instance norm {label}: off the plain version by {err:.3e}")
                continue
            m_err, v_err, differ = norm_check(x, sigma, mu, None, "none", label, eps, corr)
            line = (f"instance norm {label}: vec={instance_norm.vector_width(x, None)} mean_err={m_err:.2e} "
                    f"var_err={v_err:.2e} equal on its moments; differs from var_mean's on {differ:.2e}")
            if shape == ADAIN_NORM_4K:
                fused = lambda: instance_norm.instance_norm_epilogue(x, sigma, mu, "none", eps=eps, correction=corr)
                plain = lambda: instance_norm.instance_norm_epilogue_plain(x, sigma, mu, "none", eps=eps,
                                                                           correction=corr)
                k_dev = cuda_time_ms(fused, iters=10, warmup=2, graph=True, replays=4)
                p_dev = cuda_time_ms(plain, iters=3, warmup=1, graph=True, replays=3)
                b_ms = x.numel() * 3 * x.element_size() / HBM_BYTES_PER_S * 1e3
                p = instance_norm._plan_for(x, "none", None)
                line += (f"; kernel_dev_ms={k_dev:.5f} plain_dev_ms={p_dev:.5f} bound_ms={b_ms:.5f} (bytes) "
                         f"bound_share={b_ms / k_dev:.3f} plan: vec={p.vec} splits={p.splits} slab={p.slab} "
                         f"blocks={p.blocks}")
                out[f"adain_norm_{name}_ms"] = k_dev
                out[f"adain_norm_{name}_bound_ms"] = b_ms
            print(line, flush=True)
            del x
    return out


def smooth_frame(h: int, w: int, seed: int) -> np.ndarray:
    """An [h, w, 3] uint8 video-like frame: random cells of 240 and 24 px,
    bicubically upsampled, plus texture of 10 counts."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.zeros((1, 3, h, w), device="cuda")
    for px, weight in ((240, 0.7), (24, 0.3)):
        cells = torch.rand((1, 3, h // px + 2, w // px + 2), generator=gen, device="cuda")
        img += weight * torch.nn.functional.interpolate(cells, size=(h, w), mode="bicubic", align_corners=False)
    img = img * 255 + 10 * torch.randn((1, 3, h, w), generator=gen, device="cuda")
    return img.clamp(0, 255).round().to(torch.uint8)[0].permute(1, 2, 0).cpu().numpy()


def adain_frame_against_reference() -> dict:
    """A 3840x2160 frame through the packed-u8 bf16 AdaIN Stylizer with the
    candy style (shorter side 512), seeded weights (adain.WEIGHTS_SEED):
    raises unless the content norm launched the pair once and the
    Stylizer's CUDA graph of the forward replays it bit for bit; device-alone
    ms of the forward, and back to back through the Stylizer (its graph);
    against the plain float32 reference, the mean and worst
    difference in counts, the share of pixels off by more than 8, and the
    share of the reference's pixels with a channel at 0 or 255."""
    from faststyle_tpu_torch.models import adain
    from faststyle_tpu_torch.reference import adain as adain_reference

    params = adain.init_params(torch.Generator().manual_seed(adain.WEIGHTS_SEED), device="cuda")
    stylizer = inference.Stylizer(params=params, compute_dtype=torch.bfloat16, packed_input=True,
                                  packed_output=True, device="cuda")
    style_img = cli_image.load_style_image(REPO / "style_images" / "candy.jpg")
    style = stylizer.encode_style(style_img)
    frame = smooth_frame(2160, 3840, SEED)
    packed = torch.from_numpy(inference.pack_u8_host(frame[None], stylizer.pad)).cuda()
    fwd = lambda: stylizer.stylize_device(packed, (2160, 3840), style)
    instance_norm.launches = 0
    first = fwd()
    launches = instance_norm.launches
    if launches != 1:
        raise AssertionError(f"the 4K AdaIN forward launched the instance-norm pair {launches} times, expected 1")
    replayed = fwd()  # the Stylizer's CUDA graph of the forward
    if not torch.equal(first, replayed):
        raise AssertionError("the 4K AdaIN forward replayed as a CUDA graph differs from its eager run")
    got = inference.unpack_u8_host(first.cpu().numpy(), 2160, 3840)[0]
    ms = cuda_time_ms(fwd, iters=3, warmup=1, graph=True, replays=3)
    eager_ms = cuda_time_ms(fwd, iters=10, warmup=2)
    del stylizer, packed
    torch.cuda.empty_cache()
    ref = adain_reference.stylize_u8({k: dict(v) for k, v in params.items()}, frame, style_img, "cuda")
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    out = {"adain_frame_ms": ms, "adain_frame_eager_ms": eager_ms, "adain_frame_mae": float(diff.mean()),
           "adain_frame_max_diff": int(diff.max()),
           "adain_frame_bad_share": float((diff.max(axis=-1) > 8).mean()),
           "adain_frame_clip_share": float(((ref == 0) | (ref == 255)).any(axis=-1).mean())}
    print(f"4K packed-u8 bf16 AdaIN frame (seeded weights, candy style), device alone: {ms:.3f} ms, back to back "
          f"through the Stylizer's graph {eager_ms:.3f} ms, the graph's replay equal to the eager run, 1 pair launch; "
          f"against the float32 reference: mean |diff| {out['adain_frame_mae']:.4f} counts, worst "
          f"{out['adain_frame_max_diff']}, share off by more than 8 {out['adain_frame_bad_share']:.2e}; the "
          f"reference's clipped pixels {out['adain_frame_clip_share']:.4f}", flush=True)
    if not out["adain_frame_mae"] <= 4.0:
        raise AssertionError(f"the AdaIN frame is off the reference by {out['adain_frame_mae']:.3f} counts on average")
    return out


def frame_fused_against_plain() -> dict:
    """A 3840x2160 uint8 frame through the packed-u8 bf16 Stylizer, as the
    4K stream serves it: the pair's launches in its first forward (raises
    unless NORMS_A_FORWARD), device-alone ms with the norms fused and with
    the plain walk (`engages` refusing every norm), and the two frames'
    largest difference and share of differing bytes."""
    params = transform_net.init_params(torch.Generator().manual_seed(SEED), device="cuda")
    stylizer = inference.Stylizer(params=params, compute_dtype=torch.bfloat16, packed_input=True,
                                  packed_output=True, device="cuda")
    img = np.random.default_rng(SEED).integers(0, 256, (1, 2160, 3840, 3), dtype=np.uint8)
    packed = torch.from_numpy(inference.pack_u8_host(img)).cuda()
    fwd = lambda: stylizer.stylize_device(packed, (2160, 3840))
    instance_norm.launches = direct_conv.launches = 0
    fused_out = fwd()
    launches, convs = instance_norm.launches, direct_conv.launches
    print(f"4K packed-u8 bf16 Stylizer.stylize_device: instance_norm launches {launches} in one forward (need "
          f"{NORMS_A_FORWARD}), direct_conv launches {convs} (need {CONVS_A_FORWARD})", flush=True)
    if launches != NORMS_A_FORWARD or convs != CONVS_A_FORWARD:
        raise AssertionError(f"the 4K serving forward launched the instance-norm pair {launches} times and the "
                             f"direct conv {convs}, expected {NORMS_A_FORWARD} and {CONVS_A_FORWARD}")
    fused_ms = cuda_time_ms(fwd, iters=3, warmup=1, graph=True, replays=3)
    engages = instance_norm.engages
    instance_norm.engages = lambda *_: False
    try:
        plain_out, plain_ms = fwd(), cuda_time_ms(fwd, iters=3, warmup=1, graph=True, replays=3)
    finally:
        instance_norm.engages = engages
    conv_engages = direct_conv.engages
    direct_conv.engages = lambda *_: False
    try:
        cudnn_out, cudnn_ms = fwd(), cuda_time_ms(fwd, iters=3, warmup=1, graph=True, replays=3)
    finally:
        direct_conv.engages = conv_engages
    diff = (fused_out.int() - plain_out.int()).abs()
    conv_diff = (fused_out.int() - cudnn_out.int()).abs()
    out = {"frame_launches": launches, "frame_conv_launches": convs, "frame_fused_ms": fused_ms,
           "frame_plain_ms": plain_ms, "frame_cudnn_9x9_ms": cudnn_ms, "frame_max_diff": int(diff.max()),
           "frame_differ_share": float((diff > 0).double().mean())}
    print(f"4K packed-u8 bf16 frame (random weights), device alone: fused norms {fused_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; the two frames differ by at most {out['frame_max_diff']} counts in "
          f"{out['frame_differ_share']:.2e} of their bytes; with cuDNN's 9x9s in place of the direct conv "
          f"{cudnn_ms:.3f} ms, differing by at most {int(conv_diff.max())} counts in "
          f"{float((conv_diff > 0).double().mean()):.2e} of the bytes", flush=True)
    return out


CONV_4K = (2160, 3840)  # the 4K stream's frame
L2_FLUSH_BYTES = 256 << 20  # written between cold launches: five times the H100's 50 MB L2


def walk_convs(h: int, w: int) -> list:
    """(name, input NHWC shape, weight OIHW shape, stride, padding) of the
    resize walk's 16 convolutions over an h x w frame, as
    `transform_net._walk_steps` calls `layers.conv2d` (the resize-convs as
    their phase form: a 2x2 VALID conv over x padded by one)."""
    names = (["initconv_0", "initconv_1", "initconv_2"]
             + [f"resblock_{i}.{j}" for i in range(5) for j in (1, 2)] + ["upsample_0", "upsample_1", "upsample_2"])
    out = []
    for name, (ih, iw, _oh, _ow, k, s, ci, co) in zip(names, transform_net.conv_shapes(h, w)):
        same = k == 9 or s == 2
        out.append((name, (1, ih, iw, ci), (co, ci, k, k), s, "SAME" if same else "VALID"))
    return out


def conv_least_ms(x_shape, w_shape, stride: int, padding: str) -> tuple[float, str]:
    """The least ms of one bf16 conv (benchmark/flops.py's rule): the larger
    of its FLOPs over 989 TFLOP/s and its bytes (input and weights read
    once, output written once) over 3.35 TB/s, and which of the two."""
    _, ih, iw, ci = x_shape
    co, _, k, _ = w_shape
    oh, ow = (-(-ih // stride), -(-iw // stride)) if padding == "SAME" else (ih - k + 1, iw - k + 1)
    flops = 2 * oh * ow * k * k * ci * co
    nbytes = 2 * (ih * iw * ci + k * k * ci * co + oh * ow * co)
    f_ms, b_ms = flops / TENSOR_PEAK[torch.bfloat16] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(f_ms, b_ms), ("FLOPs" if f_ms > b_ms else "bytes")


def cold_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean device ms of `fn` by CUDA events around each call alone, with
    the L2 flushed (L2_FLUSH_BYTES written) before each."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def device_kernels(fn) -> list:
    """(kernel name, device ms) of one call of `fn`, by the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def conv_table() -> dict:
    """Each of the serving walk's 16 convs at 4K bf16 through
    `layers.conv2d` as the walk calls it (inference mode), device alone and
    cold (the L2 flushed before each launch): ms beside its least, the
    share of it, the share of the 16 convs' time, and the device kernels
    one call runs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    rows, total = [], 0.0
    print(f"the serving walk's 16 convs at {CONV_4K[1]}x{CONV_4K[0]} bf16, device alone, L2 flushed before each:")
    with torch.inference_mode():
        for name, x_shape, w_shape, stride, padding in walk_convs(*CONV_4K):
            x = torch.randn(x_shape, generator=gen, device="cuda").to(torch.bfloat16)
            w = (torch.randn(w_shape, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
            fn = lambda: layers.conv2d(x, w, stride=stride, padding=padding)
            ms = cold_ms(fn)
            least, by = conv_least_ms(x_shape, w_shape, stride, padding)
            kernels = device_kernels(fn)
            rows.append((name, x_shape, w_shape, stride, padding, ms, least, by, kernels))
            total += ms
            del x, w
    for name, x_shape, w_shape, stride, padding, ms, least, by, kernels in rows:
        names = "; ".join(f"{k[:60]} {t:.4f}" for k, t in kernels)
        print(f"  {name}: x {list(x_shape)} w {list(w_shape)} s{stride} {padding}: {ms:.5f} ms, least {least:.5f} "
              f"({by}), {100 * least / ms:.2f}% of it, {100 * ms / total:.1f}% of the convs' ms; kernels: {names}",
              flush=True)
    least_total = sum(r[6] for r in rows)
    print(f"  the 16 convs: {total:.5f} ms, least {least_total:.5f}, {100 * least_total / total:.2f}% of it",
          flush=True)
    return {name: ms for name, *_rest, ms, _l, _b, _k in rows}


# the kernel's shapes: the 4K walk's two 9x9s, then ragged ones (odd H and
# W, a 1x1 image, two images, tiles cut at both edges) and a 4K frame's
# 4-way `parallel.spatial` row window (668 padded rows: 540 owned, 2 x 40
# pad, 2 x 24 halo; 588 at upsample_2) as (label, x shape, co, storage
# offset in elements: 1 breaks the 16-byte alignment)
DIRECT_4K = [("initconv_0", (1, 2240, 3920, 3), 16, 0), ("upsample_2", (1, 2160, 3840, 16), 3, 0)]
DIRECT_RAGGED = [
    ("1x1", (1, 1, 1, 3), 16, 0), ("7x5 x2", (2, 7, 5, 3), 16, 0), ("333x257", (1, 333, 257, 3), 16, 1),
    ("1x1", (1, 1, 1, 16), 3, 0), ("37x131", (1, 37, 131, 16), 3, 0), ("9x250 x3", (3, 9, 250, 16), 3, 1),
    ("spatial window", (1, 668, 3920, 3), 16, 0), ("spatial window", (1, 588, 3840, 16), 3, 0),
    ("non-finite", (1, 37, 261, 3), 16, 0), ("non-finite", (1, 37, 261, 16), 3, 0),
]
# the "non-finite" shapes' poisoned input pixels (row, column, channel; None
# for every channel) and their values: a NaN and two Infs, one at a tile's
# last column. Unmasked, the pixels form's padding slots (the 5 elements past
# an output's 27) would carry each to outputs 5 and 6 columns left of it.
DIRECT_POISON = [((10, 50, None), float("nan")), ((20, 137, 0), float("inf")), ((30, 127, -1), -float("inf"))]
DIRECT_ABS_TOL = 1e-5  # float32 sums in another order: of the sum of |products|


def direct_inputs(shape, co: int, offset: int, gen):
    """x like the walk's (uint8 image values at ci = 3, a relu's output at
    ci = 16) in bf16 from a flat buffer whose [offset:] holds it, and w
    [co, ci, 9, 9] bf16 of the trained weights' spread."""
    n, h, w, ci = shape
    x = torch.rand(shape, generator=gen, device="cuda") * 255 if ci == 3 else \
        torch.randn(shape, generator=gen, device="cuda").clamp_min(0) * 2
    buf = torch.empty(x.numel() + offset, dtype=torch.bfloat16, device="cuda")
    buf[offset:].view(shape).copy_(x)
    wt = (torch.randn((co, ci, 9, 9), generator=gen, device="cuda") * (0.03 if ci == 3 else 0.1)).to(torch.bfloat16)
    return buf[offset:].view(shape), wt


def direct_check(x, w, label: str) -> dict:
    """Raises unless the kernel's output is within one bf16 rounding of the
    float32 conv of the same values (|y - f| <= ulp(f) + DIRECT_ABS_TOL *
    sum |products|) where f is finite, a NaN or the same Inf where f is not,
    and two calls give the same bits; returns the worst ratio to that limit,
    the largest |y - f| in ulps of f and the share of outputs that differ
    from f rounded to bf16. The float32 conv of an input with Infs or NaNs
    runs on the CPU (cuDNN may pick an FFT algorithm, which spreads them)."""
    y = direct_conv.direct_conv(x, w)
    again = direct_conv.direct_conv(x, w)
    finite_in = bool(torch.isfinite(x).all())
    xn, wf = x.float().permute(0, 3, 1, 2), w.float()
    if not finite_in:
        xn, wf = xn.cpu(), wf.cpu()
    f = torch.nn.functional.conv2d(xn, wf, padding=4).permute(0, 2, 3, 1).to(x.device)
    mag = torch.nn.functional.conv2d(xn.abs().nan_to_num(0.0, 0.0), wf.abs(), padding=4).permute(0, 2, 3, 1)
    mag = mag.to(x.device)
    ok = torch.isfinite(f)
    ulp = torch.ldexp(torch.ones_like(f), torch.frexp(f)[1] - 8)
    err = (y.float() - f).abs()[ok]
    ratio = float((err / (ulp[ok] + DIRECT_ABS_TOL * mag[ok])).max())
    yf = y.float()
    same_nonfinite = bool(torch.equal(yf.isnan(), f.isnan()) and torch.equal(yf.isinf(), f.isinf())
                          and torch.equal(yf[f.isinf()], f[f.isinf()]))
    out = {"ratio": ratio, "ulps": float((err / ulp[ok]).max()),
           "differ": float((y != f.to(y.dtype)).double().mean()), "equal": bool(torch.equal(y.view(torch.int16), again.view(torch.int16))),
           "nonfinite": int((~ok).sum()), "same_nonfinite": same_nonfinite}
    torch.cuda.synchronize()
    del f, mag, ulp, err, yf
    if not (ratio <= 1.0 and out["equal"] and same_nonfinite and (finite_in or out["nonfinite"] > 0)):
        raise AssertionError(f"direct conv {label}: {out} (need ratio <= 1, two calls equal and the float32 "
                             f"conv's non-finite outputs)")
    return out


def direct_phase_checks() -> dict:
    """The kernel at the 4K walk's two shapes: held to the float32 conv
    (`direct_check`), device alone and cold beside its least, the plain
    version's and cuDNN's bf16 conv of the same call (`library_ms`), and
    warm (CUDA-graph replays); then at the ragged shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for label, shape, co, offset in DIRECT_4K + DIRECT_RAGGED:
        x, w = direct_inputs(shape, co, offset, gen)
        if label == "non-finite":
            for (row, col, ch), val in DIRECT_POISON:
                x[0, row, col, slice(None) if ch is None else ch] = val
        c = direct_check(x, w, f"{label} {list(shape)} -> {co}")
        line = (f"direct conv {label} x {list(shape)} -> {co} (offset {offset}, "
                f"{direct_conv.SHAPES[(shape[3], co)]} form): worst {c['ratio']:.3f} of the limit, "
                f"{c['ulps']:.3f} ulps from the float32 conv, {c['differ']:.2e} differ from it rounded, "
                f"{c['nonfinite']} non-finite outputs where and as the float32 conv's, two calls equal")
        if (label, shape, co, offset) in DIRECT_4K:
            xn = x.permute(0, 3, 1, 2)
            k_ms = cold_ms(lambda: direct_conv.direct_conv(x, w))
            warm_ms = cuda_time_ms(lambda: direct_conv.direct_conv(x, w), iters=10, warmup=2, graph=True, replays=3)
            p_ms = cold_ms(lambda: direct_conv.direct_conv_plain(x, w), iters=3, warmup=1)
            lib_ms = cold_ms(lambda: torch.nn.functional.conv2d(xn, w, padding=4), iters=3, warmup=1)
            b_ms, by = conv_least_ms(shape, w.shape, 1, "SAME")
            line += (f"; kernel_dev_ms={k_ms:.5f} (cold) warm_ms={warm_ms:.5f} bound_ms={b_ms:.5f} ({by}) "
                     f"bound_share={b_ms / k_ms:.3f} plain_dev_ms={p_ms:.5f} library_ms={lib_ms:.5f} (cuDNN bf16) "
                     f"blocks={direct_conv.card_slots(0, shape[3], co)}")
            out.update({f"{label}_ms": k_ms, f"{label}_bound_ms": b_ms, f"{label}_library_ms": lib_ms})
            for key, val in zip(("ms", "bound_ms", "plain_ms", "library_ms"), (k_ms, b_ms, p_ms, lib_ms)):
                out[key] += val
        out["max_ratio"] = max(out.get("max_ratio", 0.0), c["ratio"])
        print(line, flush=True)
        del x, w
        torch.cuda.empty_cache()
    print(f"direct conv, the 4K walk's two 9x9s: " + " ".join(f"{k}={out[k]:.5f}" for k in
          ("ms", "bound_ms", "plain_ms", "library_ms")) + f" bound_share={out['bound_ms'] / out['ms']:.3f}",
          flush=True)
    return out


def conv_phase() -> dict:
    phase("conv")
    direct_conv.launches = 0
    checks = direct_phase_checks()
    table = conv_table()
    return {"walk_ms": table, **checks, "launches": direct_conv.launches}


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
            gram.GramFunction.launches = conv_wgrad.launches = 0
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
            wgrad_launches = conv_wgrad.launches
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
        want_w = wgrads_per_step() * steps
        print(f"conv_wgrad launches on the main path: {wgrad_launches} (need >= {want_w})")
        if wgrad_launches < want_w:
            raise AssertionError(f"conv_wgrad kernel launched {wgrad_launches} times, expected >= {want_w}")
        ckpt = root / "training" / "model"
        for s in (3, 6):
            if not (ckpt / f"step_{s}" / "state.npz").exists():
                raise AssertionError(f"missing checkpoint {ckpt}/step_{s}")
        with open(next((root / "summaries" / "train").glob("*/metrics.csv")), newline="") as f:
            rows = list(csv.DictReader(f))
        for row in rows:
            parts = {k: float(row[k]) for k in ("loss", "content_loss", "style_loss", "tv_loss")}
            print(f"step {row['step']}: {parts}, steps/s since the last row {row.get('steps_per_sec') or 'none'}")
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
    return {"launches": launches, "wgrad_launches": wgrad_launches, "steps_per_sec": rates}


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


def steps_per_sec(vgg_gpu, compute_dtype, iters: int = 10, fused: bool = False) -> float:
    """Train steps per second at b4@256 (synchronized), after a warm-up step."""
    config = train_step.TrainConfig.make(compute_dtype=compute_dtype)
    grams = slow_style.style_target_grams(
        vgg_gpu, torch.rand(1, 256, 256, 3, device="cuda") * 255, ("conv1_2", "conv2_2", "conv3_3", "conv4_3")
    )
    state = train_step.init_state(config, seed=SEED, device="cuda")
    step = train_step.make_train_step(vgg_gpu, grams, config, fused_content_tower=fused)
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
    name = ("bfloat16" if compute_dtype is not None else "float32") + (" fused content tower" if fused else "")
    print(f"train step b4@256 {name}: {rate:.3f} steps/s ({1e3 / rate:.3f} ms/step)")
    return rate

REPRO_STEPS = 3
REPRO_TIMED = 2  # steps_per_sec calls per dtype
STYLE_LAYERS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3")


class ConvRecorder(torch.overrides.TorchFunctionMode):
    """Records every distinct conv2d call under it: (input shape, input
    strides, weight shape, stride, padding, dtype) -> (stride, padding,
    whether the input's gradient is needed, whether the weight's is)."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") == "conv2d":
            x, w = args[0], args[1]
            stride = kwargs.get("stride", args[3] if len(args) > 3 else 1)
            padding = kwargs.get("padding", args[4] if len(args) > 4 else 0)
            stride = stride if isinstance(stride, int) else stride[0]
            padding = tuple(padding) if isinstance(padding, (tuple, list)) else (padding, padding)
            key = (tuple(x.shape), tuple(x.stride()), tuple(w.shape), stride, padding, x.dtype)
            _, _, nx, nw = self.calls.get(key, (0, 0, False, False))
            self.calls[key] = (stride, padding, nx or x.requires_grad, nw or w.requires_grad)
        return func(*args, **kwargs)


def step_convs(vgg, compute_dtype) -> dict:
    """Every distinct convolution of one b4@256 train step (ConvRecorder's calls)."""
    config = train_step.TrainConfig.make(compute_dtype=compute_dtype)
    grams = slow_style.style_target_grams(vgg, torch.rand(1, 256, 256, 3, device="cuda") * 255, STYLE_LAYERS)
    state = train_step.init_state(config, seed=SEED, device="cuda")
    rec = ConvRecorder()
    with rec:
        train_step.make_train_step(vgg, grams, config)(state, torch.rand(4, 256, 256, 3, device="cuda") * 255)
    return rec.calls


def conv_operands(key, gen):
    """Random x (with the recorded strides), w and a channels_last dY for a recorded conv."""
    shape, strides, wshape, stride, padding, dtype = key
    x = torch.empty_strided(shape, strides, device="cuda", dtype=dtype).normal_(generator=gen)
    w = torch.randn(wshape, generator=gen, device="cuda", dtype=dtype)
    y = torch.nn.functional.conv2d(x, w, stride=stride, padding=padding)
    dy = torch.randn(y.shape, generator=gen, device="cuda", dtype=dtype).to(memory_format=torch.channels_last)
    return x, w, dy


def conv_repro(calls) -> list:
    """Every recorded convolution run forward and backward twice through the
    port's conv2d (Conv2dFunction) on the same random input, weight and
    output gradient, both gradients asked for: the ones whose gradients
    differ between the two runs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    found = []
    for key, (stride, padding, _, _) in calls.items():
        x0, w0, gy = conv_operands(key, gen)
        grads = []
        for _ in range(2):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            conv_grad.conv2d(x, w, None, stride, padding).backward(gy)
            grads.append((x.grad, w.grad))
        dx = float((grads[0][0] - grads[1][0]).abs().max())
        dw = float((grads[0][1] - grads[1][1]).abs().max())
        line = f"input {list(key[0])} weight {list(key[2])} stride {stride}: input grad {dx:.3e}, weight grad {dw:.3e}"
        print(("  differs " if dx or dw else "  equal   ") + line, flush=True)
        if dx or dw:
            found.append(line)
    return found


def grad_table(calls, name: str) -> dict:
    """Device-alone ms of each recorded convolution: the forward; cuDNN's
    default data and weight gradients (aten.convolution_backward, one at a
    time); the same under cudnn deterministic; the data gradient as forward
    convs (conv_grad.input_grad) and the weight-gradient kernel. Totals over
    the gradients the step needs (`need`: x, w); the port's total takes each
    weight gradient by conv_grad.wgrad_by_kernel's rule, and bf16 data
    gradients from cuDNN's deterministic algorithm, as Conv2dFunction does."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    cols = ("fwd", "dgrad", "wgrad", "dgrad_det", "wgrad_det", "dgrad_fwdconv", "wgrad_kernel")
    tot = dict.fromkeys(("fwd", "cudnn_default", "cudnn_deterministic", "port"), 0.0)
    print(f"  {name}: device-alone ms per convolution ({', '.join(cols)}); need: input grad, weight grad")
    for key, (stride, padding, need_x, need_w) in calls.items():
        x, w, dy = conv_operands(key, gen)

        def bwd(mask):
            return lambda: torch.ops.aten.convolution_backward(
                dy, x, w, None, [stride] * 2, list(padding), [1, 1], False, [0, 0], 1, mask)

        t = {"fwd": cuda_time_ms(lambda: torch.nn.functional.conv2d(x, w, None, stride, padding), graph=True),
             "dgrad": cuda_time_ms(bwd([True, False, False]), graph=True),
             "wgrad": cuda_time_ms(bwd([False, True, False]), graph=True)}
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            t["dgrad_det"] = cuda_time_ms(bwd([True, False, False]), graph=True)
            t["wgrad_det"] = cuda_time_ms(bwd([False, True, False]), graph=True)
        t["dgrad_fwdconv"] = cuda_time_ms(lambda: conv_grad.input_grad(dy, w, stride, padding, tuple(x.shape[2:])),
                                          graph=True)
        xh, dyh = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
        t["wgrad_kernel"] = cuda_time_ms(
            lambda: conv_wgrad.conv_weight_grad_cuda(xh, dyh, tuple(w.shape[2:]), stride, padding), graph=True)
        tot["fwd"] += t["fwd"]
        tot["cudnn_default"] += need_x * t["dgrad"] + need_w * t["wgrad"]
        tot["cudnn_deterministic"] += need_x * t["dgrad_det"] + need_w * t["wgrad_det"]
        by_kernel = conv_grad.wgrad_by_kernel(key[2], stride, key[5])
        dgrad_port = t["dgrad_det"] if key[5] == torch.bfloat16 else t["dgrad_fwdconv"]
        tot["port"] += need_x * dgrad_port + need_w * (t["wgrad_kernel"] if by_kernel else t["wgrad_det"])
        print(f"    x {list(key[0])} w {list(key[2])} s{stride} p{padding[0]},{padding[1]} need {int(need_x)}{int(need_w)}: "
              + " ".join(f"{t[c]:.5f}" for c in cols), flush=True)
        del x, w, dy
    print(f"  {name} totals over the needed gradients: " + " ".join(f"{k}_ms={v:.5f}" for k, v in tot.items()),
          flush=True)
    return tot


def cli_train_subprocess(root: Path, tag: str, img_dir: Path, vgg_path: Path, steps: int, *extra) -> Path:
    """`python -m faststyle_tpu_torch.cli.train` at b4@256 in a fresh process,
    from root/tag; returns its final npz."""
    run = root / tag
    run.mkdir()
    port_subprocess(["-m", "faststyle_tpu_torch.cli.train", "--image_dir", str(img_dir), "--vgg_path", str(vgg_path),
                     "--style_img_path", str(REPO / "style_images" / "starry_night_crop.jpg"),
                     "--batch_size", "4", "--preprocess_size", "256", "256", "--num_steps_break", str(steps),
                     "--num_pipe_buffer", "8", *extra], run, timeout=300)
    return run / "models" / "model_final.npz"


def repro_phase() -> dict:
    """The train step is bit-reproducible with no flag set: two default
    cli.train runs in fresh processes, float32 and bfloat16; every
    convolution of the step run twice through the port's conv2d; the
    per-convolution gradient table; ms/step of the default."""
    phase("repro")
    check = Checks("repro")
    check(not torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark,
          f"no determinism flag set: cudnn.deterministic={torch.backends.cudnn.deterministic}, "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repro_") as tmp:
        root = Path(tmp)
        vgg_path, img_dir = write_inputs(root)
        for precision in ("float32", "bfloat16"):
            runs = [cli_train_subprocess(root, f"{precision}_{i}", img_dir, vgg_path, REPRO_STEPS,
                                         "--precision", precision) for i in range(2)]
            diff, share = params_diff(*runs)
            check(diff == 0.0, f"two default cli.train runs, {REPRO_STEPS} steps at b4@256 {precision}, fresh "
                               f"processes, no flag set: params max diff {diff:.3e} ({share:.3%} beyond 1e-5; "
                               f"need 0: bit-equal)")
        vgg = vgg16.load_npz(vgg_path, device="cuda")
    calls = {name: step_convs(vgg, dt) for name, dt in (("float32", None), ("bfloat16", torch.bfloat16))}
    differs = conv_repro(calls["float32"]) + conv_repro(calls["bfloat16"])
    check(not differs, f"convolutions of the f32 and bf16 steps whose gradients differ between two runs through "
                       f"the port's conv2d: {len(differs)} of {sum(map(len, calls.values()))} (need 0)")
    table = {name: grad_table(c, name) for name, c in calls.items()}
    conv_wgrad.relayouts = 0
    timing = {}
    for dtype in (None, torch.bfloat16):
        name = "bfloat16" if dtype else "float32"
        timing[name] = [1e3 / steps_per_sec(vgg, dtype) for _ in range(REPRO_TIMED)]
        print(f"{name} ms/step of the default: {timing[name]}", flush=True)
    print(f"inputs the weight-gradient kernel copied to NHWC over those steps: {conv_wgrad.relayouts}", flush=True)
    check.done()
    return {"differs": differs, "ms": timing, "table": table}


RECORD_PHOTOS = 64  # synthetic 640x480 JPEGs, COCO's usual size, plus one PNG and one grayscale JPEG
RECORD_STEPS = 6
DP_STEPS = 3
RATE_BATCHES = 50  # batches timed per Batcher, after the first


def write_photos(root: Path) -> Path:
    """RECORD_PHOTOS 640x480 JPEGs, a PNG and a grayscale JPEG, from the seed."""
    import cv2

    rng = np.random.default_rng(SEED + 2)
    d = root / "photos"
    d.mkdir()
    yy, xx = np.mgrid[0:480, 0:640] / 480.0
    for i in range(RECORD_PHOTOS + 2):
        offset = rng.uniform(0, 2 * np.pi, 3)
        img = 127 + 100 * np.sin(2 * np.pi * (xx[..., None] * (i % 7 + 1) + yy[..., None]) + offset)
        img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
        if i == RECORD_PHOTOS:
            image_io.imwrite(d / "photo_png.png", img)
        elif i == RECORD_PHOTOS + 1:
            cv2.imwrite(str(d / "photo_gray.jpg"), img[..., 0])
        else:
            image_io.imwrite(d / f"photo_{i:03d}.jpg", img)
    return d


def port_subprocess(args: list, cwd: Path, timeout: int) -> subprocess.CompletedProcess:
    """`python <args>` with the repo importable, from `cwd`; raises with
    the tail of its output if it fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: NCCL's bootstrap stays on the loopback
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(args[:4])} ... exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    return proc


def params_diff(a: Path, b: Path) -> tuple[float, float]:
    """(largest |a - b|, share of entries beyond 1e-5) of two params .npz."""
    pa, pb = inference.load_params_numpy(a), inference.load_params_numpy(b)
    d = np.concatenate([np.abs(pa[blk][v] - pb[blk][v]).ravel() for blk in pa for v in pa[blk]])
    return float(d.max()), float((d > 1e-5).mean())


def train_cli(cwd: Path, records: Path, vgg_path: Path, steps: int, *extra) -> tuple:
    """cli.train --train_dir in-process from `cwd` at b4@256 float32; returns
    (state, wall s)."""
    cwd.mkdir()
    prev = os.getcwd()
    os.chdir(cwd)  # the CLI writes training/, models/, summaries/ here
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = cli_train.main(records_args(records, vgg_path, steps) + list(extra))
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0
    finally:
        os.chdir(prev)


LOSS_PARTS = ("loss", "content_loss", "style_loss", "tv_loss")


def metric_rows(run_dir: Path) -> list:
    """The rows of the metrics CSV that cli.train wrote under `run_dir`."""
    with open(next((run_dir / "summaries" / "train").glob("*/metrics.csv")), newline="") as f:
        return list(csv.DictReader(f))


def records_args(records: Path, vgg_path: Path, steps: int) -> list:
    return ["--train_dir", str(records), "--vgg_path", str(vgg_path),
            "--style_img_path", str(REPO / "style_images" / "starry_night_crop.jpg"),
            "--batch_size", "4", "--preprocess_size", "256", "256", "--n_epochs", "4",
            "--num_steps_break", str(steps), "--num_steps_ckpt", "3",
            # a small shuffle buffer: the default 4000 holds 3.1 GB of decoded images
            "--num_pipe_buffer", "16"]


def records_phase() -> dict:
    phase("records")
    check = Checks("records")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_records_") as tmp:
        root = Path(tmp)
        vgg_path, _ = write_inputs(root)
        photos = write_photos(root)
        records = root / "records"

        # 1. the dataset: the writer CLI, then every record read back
        t0 = time.perf_counter()
        port_subprocess(["-m", "faststyle_tpu_torch.cli.tfrecords_writer", "--train_directory", str(photos),
                         "--output_directory", str(records), "--train_shards", "4", "--num_threads", "2"],
                        root, timeout=300)
        wall = time.perf_counter() - t0
        shards = sorted(records.glob("train-*"))
        recs = [r for s in shards for r in tfrecord.iter_records(s, verify=True)]
        plain = [r for s in shards for r in tfrecord.iter_records(s, verify=True, plain=True)]
        names, shapes_ok = set(), True
        for rec in recs:
            ex = tfrecord.decode_example(rec)
            names.add(ex["image/filename"].decode())
            img = image_io.imdecode(ex["image/encoded"])
            shapes_ok &= img.shape == (ex["image/height"], ex["image/width"], 3) == (480, 640, 3)
        check([s.name for s in shards] == [f"train-{i:05d}-of-00004" for i in range(4)] and len(recs) == RECORD_PHOTOS + 2
              and recs == plain and shapes_ok and {"photo_png.png", "photo_gray.jpg"} <= names,
              f"cli.tfrecords_writer: {len(recs)} records in {len(shards)} shards ({sum(s.stat().st_size for s in shards)} "
              f"bytes) in {wall:.3f} s wall; C++ scan with CRCs byte-equal to the plain Python reader: {recs == plain}; "
              f"all decode to 480x640x3: {shapes_ok}")
        bad = root / "bad.tfrecord"
        raw = bytearray(shards[0].read_bytes())
        raw[len(raw) // 2] ^= 0x01
        bad.write_bytes(bytes(raw))
        try:
            list(tfrecord.iter_records(bad, verify=True))
            err = None
        except ValueError as e:
            err = str(e)
        check(err is not None and "corrupt" in err, f"one flipped byte in a shard: {err}")

        # 2. training from the shards: the main path, with the kernel's count
        gram.GramFunction.launches = conv_wgrad.launches = 0
        state, wall = train_cli(root / "run6", records, vgg_path, RECORD_STEPS)
        launches, wgrad_launches = gram.GramFunction.launches, conv_wgrad.launches
        want = 4 * RECORD_STEPS + 4  # four style layers per step, plus the target Grams once
        want_w = wgrads_per_step() * RECORD_STEPS
        check(state.step == RECORD_STEPS and launches >= want and wgrad_launches >= want_w,
              f"cli.train --train_dir: {state.step} steps at b4@256 float32 in {wall:.3f} s wall (pipeline, targets, "
              f"checkpoints, final save); gram launches {launches} (need >= {want}), conv_wgrad launches "
              f"{wgrad_launches} (need >= {want_w})")
        run6 = root / "run6"
        ckpts = [(run6 / "training" / "model" / f"step_{s}" / "state.npz").exists() for s in (3, 6)]
        rows = metric_rows(run6)
        parts = [{k: float(r[k]) for k in LOSS_PARTS} for r in rows]
        rate = rows[-1].get("steps_per_sec") or "none"
        check(all(ckpts) and (run6 / "models" / "model_final.npz").exists()
              and all(math.isfinite(v) for p in parts for v in p.values()),
              f"checkpoints at 3 and 6: {ckpts}; final npz; loss parts {parts}; steps/s between the checkpoints {rate}")

        # 3. --data_parallel through torch.distributed.run, against two
        # plain runs, no flag set: the step is bit-reproducible (phase
        # repro), and one rank's all-reduce(SUM) leaves its gradients as
        # they are, so the DP run must give the same bits
        train_cli(root / "plain3", records, vgg_path, DP_STEPS)
        train_cli(root / "plain3b", records, vgg_path, DP_STEPS)
        floor = params_diff(root / "plain3" / "models" / "model_final.npz",
                            root / "plain3b" / "models" / "model_final.npz")
        check(floor[0] == 0.0, f"two plain cli.train runs, {DP_STEPS} steps at b4@256 float32, same flags, no "
                               f"determinism flag: params max diff {floor[0]:.3e} (need 0: bit-equal)")
        (root / "dp3").mkdir()
        t0 = time.perf_counter()
        proc = port_subprocess(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                                "-m", "faststyle_tpu_torch.cli.train", *records_args(records, vgg_path, DP_STEPS),
                                "--data_parallel"], root / "dp3", timeout=600)
        wall = time.perf_counter() - t0
        diff, share = params_diff(root / "plain3" / "models" / "model_final.npz",
                                  root / "dp3" / "models" / "model_final.npz")
        plain_loss, dp_loss = (metric_rows(root / run)[-1] for run in ("plain3", "dp3"))
        same_loss = all(float(dp_loss[k]) == float(plain_loss[k]) for k in LOSS_PARTS)
        check(diff == 0.0 and same_loss and "final weights" in proc.stdout,
              f"--data_parallel, one NCCL rank through torch.distributed.run, {DP_STEPS} steps in {wall:.3f} s wall "
              f"(process start included), no determinism flag: loss parts at step {DP_STEPS} equal to the plain "
              f"run's: {same_loss}; params max diff {diff:.3e} ({share:.3%} beyond 1e-5; need 0: bit-equal)")

        # 4. NaN checking
        state, wall = train_cli(root / "nans2", records, vgg_path, 2, "--debug_nans")
        check(state.step == 2, f"--debug_nans on clean batches: {state.step} steps in {wall:.3f} s wall")
        vgg_gpu = vgg16.load_npz(vgg_path, device="cuda")
        style = image_io.imread(REPO / "style_images" / "starry_night_crop.jpg")
        nan_batch = np.random.default_rng(SEED + 3).uniform(0, 255, (4, 256, 256, 3)).astype(np.float32)
        nan_batch[2, 100, 50, 1] = np.nan
        try:
            loop.train(vgg_params=vgg_gpu, style_img=style, batches=[nan_batch], config=train_step.TrainConfig.make(),
                       train_root=root / "nan" / "training", models_root=root / "nan" / "models",
                       summaries_root=root / "nan" / "summaries", debug_nans=True)
            err = None
        except FloatingPointError as e:
            err = str(e)
        check(err is not None and err.startswith("step 1"),
              f"a batch with one NaN pixel under debug_nans: FloatingPointError {err!r:.160}")

        # 5. the fused content tower
        fused_check(check, vgg_gpu)
        timing = {}
        for dtype in (None, torch.bfloat16):
            rates = [steps_per_sec(vgg_gpu, dtype, fused=f) for f in (False, True, True, False)]
            timing["bfloat16" if dtype else "float32"] = rates
        # 6. input rate on this machine's host
        input_rates = {
            "tfrecord": batcher_rate(pipeline.Batcher(shards, batch_size=4, min_after_dequeue=16,
                                                      num_decode_threads=8)),
            "image_dir": batcher_rate(pipeline.image_dir_batcher(photos, batch_size=4, min_after_dequeue=16,
                                                                 num_decode_threads=8)),
        }
    check.done()
    return {"launches": launches, "wgrad_launches": wgrad_launches, "fused_ms": timing, "input_rates": input_rates}


def fused_check(check: "Checks", vgg_gpu) -> None:
    """One fused-tower step against the plain step from the same state at
    b4@256 float32: loss parts within 1e-4 relative, params within 2 * lr."""
    config = train_step.TrainConfig.make()
    style = torch.rand(1, 256, 256, 3, generator=torch.Generator().manual_seed(SEED)).cuda() * 255
    grams = slow_style.style_target_grams(vgg_gpu, style, ("conv1_2", "conv2_2", "conv3_3", "conv4_3"))
    batch = torch.rand(4, 256, 256, 3, generator=torch.Generator().manual_seed(SEED + 1)).cuda() * 255
    out = {}
    for fused in (False, True):
        state = train_step.init_state(config, seed=SEED, device="cuda")
        state, metrics = train_step.make_train_step(vgg_gpu, grams, config, fused_content_tower=fused)(state, batch)
        out[fused] = ({k: float(v) for k, v in metrics.items()},
                      torch.cat([p.detach().flatten() for p in state.net.parameters()]))
    rel = {k: abs(out[True][0][k] - v) / max(abs(v), 1e-30) for k, v in out[False][0].items()}
    diffs = (out[True][1] - out[False][1]).abs()
    diff, share = float(diffs.max()), float((diffs > 1e-5).float().mean())
    check(max(rel.values()) <= 1e-4 and diff <= 2.001 * config.learn_rate and share <= 0.01,
          f"fused content tower vs the plain step, b4@256 float32: loss parts {out[True][0]}, relative "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (need <= 1e-4); params max diff {diff:.3e} "
          f"(need <= {2 * config.learn_rate}), {share:.3%} beyond 1e-5")


def batcher_rate(batcher) -> float:
    """Images per second the Batcher yields at b4@256 once its shuffle
    buffer is full (RATE_BATCHES batches after the first)."""
    it = iter(batcher)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(RATE_BATCHES):
            next(it)
        rate = RATE_BATCHES * 4 / (time.perf_counter() - t0)
    finally:
        it.close()
    name = type(batcher).__name__
    print(f"input rate, {name} at b4@256 with 8 decode threads from 640x480 JPEGs on {os.cpu_count()} host cores: "
          f"{rate:.3f} images/s ({rate / 4:.3f} batches/s)", flush=True)
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


def norm_launches(check: "Checks", what: str, forwards: int, counts: dict, bf16: bool) -> None:
    """Checks that the serving run just made launched the instance-norm pair
    16 times a forward and, in bf16, the direct conv twice a forward (none
    in float32; both counters were set to 0 before it), and adds the
    launches and forwards to `counts`."""
    got, want = instance_norm.launches, NORMS_A_FORWARD * forwards
    convs, want_convs = direct_conv.launches, (CONVS_A_FORWARD if bf16 else 0) * forwards
    check(got == want and convs == want_convs,
          f"{what}: instance_norm launches {got} (need {want}, {NORMS_A_FORWARD} for each of {forwards} forwards), "
          f"direct_conv launches {convs} (need {want_convs})")
    counts["launches"] += got
    counts["conv_launches"] += convs
    counts["forwards"] += forwards


def stream_phase() -> dict:
    """The webcam CLI's streams and the Stylizer's forwards on the device;
    returns the instance-norm pair's launches and the forwards that made
    them."""
    phase("stream")
    check = Checks("stream")
    counts = {"launches": 0, "conv_launches": 0, "forwards": 0}
    base = ["--model_path", str(STARRY), "--no_display", "--report_latency"]
    for w, h, precision, depth, packed in STREAMS:
        args = base + ["--num_synthetic_frames", str(STREAM_FRAMES), "--resolution", str(w), str(h),
                       "--precision", precision, "--pipeline_depth", str(depth)] + (["--packed_fetch"] if packed else [])
        instance_norm.launches = direct_conv.launches = 0
        r = cli_webcam.main(args)
        what = f"stream {w}x{h} {precision} depth {depth}{' packed' if packed else ''}"
        check(r["frames"] == STREAM_FRAMES and r["fps"] > 0 and r["p99_ms"] is not None, f"{what}: {stream_reading(r)}")
        # the frames and the warm-up's one
        norm_launches(check, what, r["frames"] + 1, counts, precision == "bfloat16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as tmp:
        import cv2

        root = Path(tmp)
        frames = list(cli_webcam.synthetic_frames(40, 1080, 1920))
        fh, fw = frames[0].shape[:2]
        writer = cv2.VideoWriter(str(root / "in.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (fw, fh))
        for f in frames:
            writer.write(f)
        writer.release()
        instance_norm.launches = direct_conv.launches = 0
        r = cli_webcam.main(base + ["--video_path", str(root / "in.avi"), "--max_frames", "30",
                                    "--output_path", str(root / "out.avi")])
        size = (root / "out.avi").stat().st_size if (root / "out.avi").exists() else 0
        check(r["frames"] == 30 and size > 0, f"video {fw}x{fh} MJPG through --video_path --max_frames 30: "
                                              f"{stream_reading(r)}, output {size} bytes")
        norm_launches(check, f"video {fw}x{fh}", r["frames"] + 1, counts, True)  # the CLI's default bf16
    # the forward alone on the device: uint8 frame in, uint8 (or packed) out
    for w, h, precision, packed in ((1920, 1080, "bfloat16", False), (1920, 1080, "float32", False),
                                    (1920, 1080, "bfloat16", True), (1920, 1080, "float32", True),
                                    (512, 512, "bfloat16", False), (512, 512, "float32", False)):
        s = inference.Stylizer(STARRY, compute_dtype=torch.bfloat16 if precision == "bfloat16" else None,
                               output_uint8=True, packed_input=packed, packed_output=packed)
        frame = next(cli_webcam.synthetic_frames(1, h, w))[None]
        x = torch.from_numpy(inference.pack_u8_host(frame) if packed else frame).cuda()
        fn = (lambda: s.stylize_device(x, (h, w))) if packed else (lambda: s.stylize_device(x))
        instance_norm.launches = direct_conv.launches = 0
        dev = cuda_time_ms(fn, iters=10, graph=True, replays=3)
        eager = cuda_time_ms(fn, iters=10)
        what = f"forward {w}x{h} {precision}{' packed' if packed else ''}"
        print(f"{what}: device-alone {dev:.5f} ms/frame, eager {eager:.5f} ms/frame", flush=True)
        # each timing's 3 warm-up and 10 timed calls
        norm_launches(check, what, 2 * (3 + 10), counts, precision == "bfloat16")
    check.done()
    print(f"instance_norm launches on the stream's serving paths: {counts['launches']} in {counts['forwards']} "
          f"forwards; direct_conv launches {counts['conv_launches']}", flush=True)
    return counts


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
        again, history2 = cli_slow.main(base + ["--cont_img_path", str(ASSETS / "chicago.jpg"),
                                                "--num_steps_break", str(SLOW_STEPS)])
        n = int((np.asarray(again) != np.asarray(out)).sum()) if np.shape(again) == np.shape(out) else -1
        check(n == 0 and history2 == history,
              f"two {SLOW_STEPS}-step slow-style runs: {n} output values differ, losses equal {history2 == history} "
              "(need bit-equal)")

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


DISTILL_IMAGES = 64
DISTILL_STEPS = 100  # per phase: --layerwise, then --gram_w 1 --ema_decay 0.999
DISTILL_REPRO_STEPS = 20
DISTILL_TAPS = 11  # the transform net's taps, each Gram'd for the student and the teacher per fine-tune step


def distill_cli(root: Path, imgs: Path, tag: str, steps: int, *extra) -> dict:
    """tools.distill_validation at b4@256 bfloat16 from starry, its output under root."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = distill.main(["--image_dir", str(imgs), "--teacher", str(STARRY), "--out", str(root / f"{tag}.npz"),
                            "--steps", str(steps), *extra])
    lines = buf.getvalue().splitlines()
    print("\n".join(f"  [{tag}] {line}" for line in lines[:2] + lines[-5:]), flush=True)
    return res


def distill_reference_check(check: Checks) -> None:
    """One make_distill_step (feature_w 1, gram_w 1, EMA 0.99) at b2@64
    float32 on the card against the same step on the CPU, from the same
    student and teacher: losses within 1e-3 relative, params within 2 * lr
    and all but 1% within 1e-5."""
    teacher = inference.load_params_numpy(STARRY)
    batch = np.random.default_rng(SEED + 9).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        step, opt = distill.make_distill_step(1e-3, None, decay_steps=10, feature_w=1.0, gram_w=1.0, ema_decay=0.99)
        net = transform_net.TransformNet(transform_net.init_params(torch.Generator().manual_seed(SEED), device=dev))
        ema = {b: {v: t.detach().clone() for v, t in sub.items()} for b, sub in net.params().items()}
        opt_state = opt.init(net)
        net, ema, _, (loss, pix) = step(net, ema, opt_state, inference.load_params(STARRY, device=dev),
                                        torch.from_numpy(batch).to(dev))
        out[dev] = ((float(loss), float(pix)), torch.cat([p.detach().cpu().flatten() for p in net.parameters()]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    d = (out["cuda"][1] - out["cpu"][1]).abs()
    diff, share = float(d.max()), float((d > 1e-5).float().mean())
    check(rel <= 1e-3 and diff <= 2.001e-3 and share <= 0.01,
          f"one b2@64 float32 distill step (gram_w 1, EMA), card vs CPU: loss and pixel L2 {out['cuda'][0]} vs "
          f"{out['cpu'][0]}, relative {rel:.2e} (need <= 1e-3); params max diff {diff:.3e} (need <= 2e-3), "
          f"{share:.3%} beyond 1e-5 (need <= 1%)")
    del teacher


def distill_phase() -> dict:
    """The distillation trainer on the card: a corpus of DISTILL_IMAGES,
    DISTILL_STEPS --layerwise then DISTILL_STEPS --gram_w 1 --ema_decay
    0.999 steps at b4@256 bf16 from starry (the main path, launch counts);
    the saved student served by the Stylizer; a card step against the CPU;
    two DISTILL_REPRO_STEPS-step runs bit-equal."""
    phase("distill")
    check = Checks("distill")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_distill_") as tmp:
        root = Path(tmp)
        with contextlib.redirect_stdout(io.StringIO()):
            imgs = make_training_images.main([str(root / "imgs"), "--num", str(DISTILL_IMAGES)])
        runs, launches = {}, {}
        for tag, extra in (("layerwise", ["--layerwise", "--learn_rate", "1e-3"]),
                           ("finetune", ["--init_from", str(root / "layerwise.npz"), "--learn_rate", "3e-4",
                                         "--gram_w", "1", "--ema_decay", "0.999"])):
            gram.GramFunction.launches = conv_wgrad.launches = 0
            runs[tag] = distill_cli(root, imgs, tag, DISTILL_STEPS, *extra)
            torch.cuda.synchronize()
            launches[tag] = (gram.GramFunction.launches, conv_wgrad.launches)
            rows = runs[tag]["rows"]
            want_g = 2 * DISTILL_TAPS * DISTILL_STEPS if tag == "finetune" else 0
            want_w = wgrads_per_step(torch.bfloat16) * DISTILL_STEPS
            # the fine-tune's Gram term first raises its loss (the full recipe's
            # second phase: 0.0048 at step 1, 0.045 at step 200, 0.0027 at 8000)
            check((tag == "finetune" or rows[-1][1] < rows[0][1]) and all(math.isfinite(r[1]) for r in rows)
                  and launches[tag][0] >= want_g and launches[tag][1] == want_w,
                  f"distill {tag}, {DISTILL_STEPS} steps at b4@256 bfloat16: loss {rows[0][1]:.5f} at step "
                  f"{rows[0][0]} -> {rows[-1][1]:.5f} at step {rows[-1][0]} (need finite, and falling in the "
                  f"layerwise phase); "
                  f"{runs[tag]['steps_per_sec']:.3f} steps/s ({runs[tag]['wall_s']:.2f} s); gram launches "
                  f"{launches[tag][0]} (need >= {want_g}), conv_wgrad launches {launches[tag][1]} "
                  f"(need {want_w}: bf16 takes cuDNN's deterministic algorithm); held-out SSIM {runs[tag]['ssim']}")
        student = root / "finetune.npz"
        crop = image_io.imread(ASSETS / "chicago_crop256.png")
        served = inference.Stylizer(student)(crop)
        teacher_out = inference.Stylizer(STARRY)(crop)
        score = ssim(served, teacher_out)
        check(served.shape == crop.shape and served.dtype == np.uint8,
              f"the saved student served by the Stylizer on chicago_crop256: {served.shape} {served.dtype}, SSIM "
              f"against the teacher {score:.4f} (a reading after {2 * DISTILL_STEPS} steps)")
        distill_reference_check(check)
        repro = [distill_cli(root, imgs, f"repro{i}", DISTILL_REPRO_STEPS, "--init_from",
                             str(root / "layerwise.npz"), "--learn_rate", "3e-4", "--gram_w", "1",
                             "--ema_decay", "0.999")["out"] for i in range(2)]
        diff, share = params_diff(*repro)
        check(diff == 0.0, f"two distill runs, {DISTILL_REPRO_STEPS} steps --gram_w 1 --ema_decay 0.999 at b4@256 "
                           f"bfloat16: params max diff {diff:.3e} ({share:.3%} beyond 1e-5; need 0: bit-equal)")
    check.done()
    return {"gram_launches": sum(g for g, _ in launches.values()),
            "wgrad_launches": sum(w for _, w in launches.values()),
            "steps_per_sec": {k: r["steps_per_sec"] for k, r in runs.items()}}


SHARDED_FRAMES = 5  # over two entries: padded to 6, shards of 3
SPATIAL_ATOL = 5e-2  # of 255: the shards add their IN partial sums in another order
SPATIAL_SSIM_BF16_MIN = 0.99
SPATIAL_TIMED = 3  # host-clock calls per turn, in turns single, sharded, sharded, single


def turns_ms(fns: dict) -> dict:
    """Median ms of each of two device-resident callables, timed on the host
    clock to a synchronize in turns (a, b, b, a), SPATIAL_TIMED calls a turn."""
    (a, fa), (b, fb) = fns.items()
    times = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb)):
        fn()  # warm up: cuDNN's first-call set-up
    torch.cuda.synchronize()
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        for _ in range(SPATIAL_TIMED):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def multi_card_check(check: Checks, starry, params, frames, single_f32, rng, cards: list, card: str,
                     readings: dict) -> None:
    """ShardedStylizer and SpatialStylizer over distinct cards, against the
    first card alone; 4K ms/frame over the cards as a reading."""
    out = data_parallel.ShardedStylizer(starry, cards).stylize_batch(frames.astype(np.float32))
    err = float(np.abs(out - single_f32).max())
    check(err <= 1e-2, f"ShardedStylizer over {cards}: max |sharded - single-card Stylizer| {err:.3e} (need <= 1e-2)")
    h, w = 2160, 3840
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    s = spatial.SpatialStylizer(params, cards)
    n = s.shards_for(h)
    x = torch.from_numpy(img).cuda()
    with torch.inference_mode():
        ref = transform_net.apply(params, x[None])[0]
        err = float((s._fn(h, w)(x) - ref).abs().max())
        ms = turns_ms({"single": lambda: transform_net.apply(params, x[None]), "sharded": lambda: s._fn(h, w)(x)})
    check(n > 1 and err <= SPATIAL_ATOL, f"SpatialStylizer 4K float32 over {cards}: {n}-way; max |sharded - "
                                         f"single-card forward| {err:.3e} (need <= {SPATIAL_ATOL})")
    readings[f"starry 4K float32 over {len(cards)} cards"] = ms
    print(f"  reading, starry 4K float32 {h}x{w} on {len(cards)} x {card}: one card "
          f"{ms['single']:.3f} ms/frame, {n}-way over the cards {ms['sharded']:.3f} ms/frame (device-resident "
          f"frame on cuda:0, median of {2 * SPATIAL_TIMED})", flush=True)


def parallel_phase(smi: str) -> dict:
    """Serving across device lists on the one card: ShardedStylizer against
    the single-card Stylizer; SpatialStylizer at 4K (4-way) and 1080p deconv
    (auto-reduced to 3-way) against the single-card forward, and in bf16;
    cli.stylize_image --spatial; parallel.dryrun as a world of one with its
    Gram launches counted."""
    phase("parallel")
    check = Checks("parallel")
    card = smi.splitlines()[0]
    starry = inference.load_params_numpy(STARRY)
    rng = np.random.default_rng(SEED + 5)

    # 1. batch-sharded serving over two entries of the card
    frames = rng.integers(0, 256, (SHARDED_FRAMES, 256, 256, 3), dtype=np.uint8)
    two = ["cuda:0"] * 2
    f32 = {"sharded": data_parallel.ShardedStylizer(starry, two).stylize_batch(frames.astype(np.float32)),
           "single": inference.Stylizer(params=starry).stylize_batch(frames.astype(np.float32)).cpu().numpy()}
    err = float(np.abs(f32["sharded"] - f32["single"]).max())
    check(f32["sharded"].shape == frames.shape and err <= 1e-2,
          f"ShardedStylizer over {two}, {SHARDED_FRAMES} frames of {frames.shape[1]}x{frames.shape[2]} float32: "
          f"{f32['sharded'].shape}, max |sharded - single-card Stylizer| {err:.3e} (need <= 1e-2)")
    u8 = data_parallel.ShardedStylizer(starry, two, output_uint8=True).stylize_batch(frames)
    single_u8 = inference.Stylizer(params=starry, output_uint8=True).stylize_batch(frames).cpu().numpy()
    worst, n = count_diff(u8, single_u8)
    check(u8.dtype == np.uint8 and worst <= 1, f"ShardedStylizer uint8: within {worst} count(s) of the single-card "
                                               f"Stylizer, {n} values differ")
    packed = data_parallel.ShardedStylizer(starry, two, packed_input=True, packed_output=True).stylize_batch(frames)
    _, n = count_diff(packed, u8) if packed.shape == u8.shape else (None, -1)
    check(n == 0, f"ShardedStylizer packed-u8 in and out: {packed.shape}, {n} values differ from its uint8 path "
                  "(need 0)")

    # 2. row-sharded serving of one frame, four entries of the card
    four = ["cuda:0"] * 4
    params = inference.load_params(STARRY)
    deconv_params = transform_net.init_params(torch.Generator().manual_seed(SEED), "deconv", device="cuda")
    readings = {}
    for name, p, method, (h, w), dtype, want_n in (
        ("starry 4K float32", params, "resize", (2160, 3840), None, 4),
        ("deconv 1080p float32", deconv_params, "deconv", (1080, 1920), None, 3),
        ("starry 4K bfloat16", params, "resize", (2160, 3840), torch.bfloat16, 4),
    ):
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        s = spatial.SpatialStylizer(p, four, compute_dtype=dtype, upsample_method=method)
        out = s(img)
        x = torch.from_numpy(img).cuda()
        with torch.inference_mode():
            ref = transform_net.apply(p, x[None], method, compute_dtype=dtype)[0].float().cpu().numpy()
        err = float(np.abs(out - ref).max()) if out.shape == ref.shape else float("inf")
        n = s.shards_for(h)
        if dtype is None:
            check(n == want_n and err <= SPATIAL_ATOL,
                  f"SpatialStylizer {name} {h}x{w} over {len(four)} entries: {n}-way (need {want_n}); max |sharded - "
                  f"single-card forward| {err:.3e} (need <= {SPATIAL_ATOL})")
        else:
            score = ssim(np.clip(out, 0, 255).astype(np.uint8), np.clip(ref, 0, 255).astype(np.uint8))
            check(n == want_n and score >= SPATIAL_SSIM_BF16_MIN,
                  f"SpatialStylizer {name} {h}x{w}: {n}-way (need {want_n}); SSIM against the bfloat16 single-card "
                  f"forward {score:.5f} (need >= {SPATIAL_SSIM_BF16_MIN}); max |difference| {err:.3e}")
        if h == 2160:
            fn = s._fn(h, w)
            # the same windows walked one after another by this thread with
            # the plain per-window IN (taps=True keeps every norm in plain
            # torch): what the shard threads add beyond it
            _, win, starts = spatial.windows(h, n)
            with torch.inference_mode():
                padded = layers.reflect_pad(x[None].to(dtype or torch.float32), 40)
                ms = turns_ms({"single": lambda: transform_net.apply(p, x[None], method, compute_dtype=dtype),
                               "sharded": lambda: fn(x)})
                ms.update(turns_ms({"sharded": lambda: fn(x), "windows": lambda: [
                    transform_net._walk_padded(p, padded[:, s0 : s0 + win], method, taps=True)[0]
                    for s0 in starts]}))
            readings[name] = ms
            print(f"  reading, {name} {h}x{w} on {card}: single card {ms['single']:.3f} ms/frame, {n}-way on the one "
                  f"card {ms['sharded']:.3f} ms/frame, its {n} windows walked in one thread {ms['windows']:.3f} ms "
                  f"(device-resident frame, median of {2 * SPATIAL_TIMED} each)", flush=True)
            del padded
        del x, out, ref

    # 2b. on a machine with more cards, the same over every card: the
    # device lists then hold distinct devices, and partial sums cross them
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if len(cards) > 1:
        multi_card_check(check, starry, params, frames, f32["single"], rng, cards, card, readings)

    # 3. the CLI: --spatial on one card is 1-way, the plain forward
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        root = Path(tmp)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_image.main(["--input_img_path", str(ASSETS / "chicago.jpg"), "--output_img_path",
                            str(root / "spatial.png"), "--model_path", str(STARRY), "--spatial"])
        said = buf.getvalue()
        print(said, end="")
        plain = stylize_cli(root, STARRY, "resize", ASSETS / "chicago.jpg")
        got = image_io.imread(root / "spatial.png")
        worst, n = count_diff(got, plain) if got.shape == plain.shape else (None, -1)
        check("Evaluating (1-way row sharding)..." in said and worst is not None and worst <= 1,
              f"cli.stylize_image --spatial on chicago.jpg, one card: {got.shape}, within {worst} count(s) of the "
              f"plain CLI ({n} values differ)")

    # 4. the dry run, as a world of one on the card: its train step is the
    # main path's Gram launches here (over every card when there are more)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: NCCL's bootstrap stays on the loopback
    buf = io.StringIO()
    gram.GramFunction.launches = conv_wgrad.launches = 0
    with contextlib.redirect_stdout(buf):
        dryrun.run(len(cards))
    torch.cuda.synchronize()
    launches, wgrad_launches = gram.GramFunction.launches, conv_wgrad.launches
    print(buf.getvalue(), end="")
    want = 4 + 4  # the target Grams, then the step's four style layers
    check(f"[dryrun] {len(cards)}-device cuda list OK" in buf.getvalue() and launches >= want
          and wgrad_launches >= wgrads_per_step(),
          f"parallel.dryrun.run({len(cards)}): gram launches {launches} (need >= {want}), conv_wgrad launches "
          f"{wgrad_launches} (need >= {wgrads_per_step()})")
    check.done()
    return {"launches": launches, "wgrad_launches": wgrad_launches, "spatial_ms": readings}


BENCH_RUNS = (("bfloat16", ["--quick", "--skip_gate"]),
              ("float32", ["--quick", "--skip_gate", "--precision", "float32"]),
              ("dp", ["--dp", "--quick"]))
BENCH_TIMEOUT = 400  # seconds a bench process


def bench_phase() -> dict:
    """The port's bench in its own processes at --quick sizes: bf16 and
    float32 (each with its DP bench), then --dp alone; each line's value,
    the card's identity and the kernels' launch counts."""
    phase("bench")
    check = Checks("bench")
    card = torch.cuda.get_device_name(0)
    launches = wgrad_launches = 0
    for tag, args in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = port_subprocess(["-m", "faststyle_tpu_torch.bench", *args], REPO, BENCH_TIMEOUT)
        secs = time.perf_counter() - t0
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        d = line["details"]
        print(f"bench {' '.join(args)}: {secs:.1f} s\n{json.dumps(line)}", flush=True)
        check(line["value"] > 0 and d.get("device_name") == card and d.get("power_limit_w"),
              f"bench {tag}: {line['metric']} = {line['value']} {line['unit']}, device_name {d.get('device_name')!r} "
              f"(need {card!r}), power_limit_w {d.get('power_limit_w')}")
        dp = d if tag == "dp" else d["dp_scaling"]
        tf32 = (d["cudnn_allow_tf32"], d["matmul_allow_tf32"], dp["ranks_cudnn_allow_tf32"],
                dp["ranks_matmul_allow_tf32"])
        check(not any(tf32), f"bench {tag}: TF32 off in the bench and its DP ranks (cudnn, matmul; ranks' "
                             f"cudnn, matmul: {tf32})")
        runs = [("dp", dp, "", dp["timed_steps"], torch.float32, 0, True)]  # the DP step is the recipe's, f32
        if tag != "dp":
            dtype = getattr(torch, tag)
            runs += [("train", d, "train_", d["train_timed_steps"], dtype, 0, True),
                     ("slow-style", d, "slow_style_", d["slow_style_steps"], dtype, 4, False)]
        for what, rec, key, steps, dtype, targets, wgrad in runs:
            g, w = rec[f"{key}gram_launches"], rec[f"{key}conv_wgrad_launches"]
            want_g, want_w = 4 * steps + targets, wgrads_per_step(dtype) * steps if wgrad else 0
            check(g == want_g and w == want_w, f"bench {tag}, {what}: {steps} steps, gram launches {g} (need "
                                               f"{want_g}), conv_wgrad launches {w} (need {want_w})")
            launches, wgrad_launches = launches + g, wgrad_launches + w
    check.done()
    return {"launches": launches, "wgrad_launches": wgrad_launches}


def main(argv: list) -> None:
    """Every phase in order, then the kernels and ok lines. With phase names
    as arguments (`python3 chip_smoke.py wgrad repro`): the device and build
    phases, then only those, then a line naming them and no kernels or ok
    line, so a partial run cannot pass for a whole one."""
    smi = device_phase()
    build_phase()
    if argv:
        chosen = {"kernel": kernel_phase, "wgrad": wgrad_phase, "norm": norm_phase, "conv": conv_phase,
                  "repro": repro_phase,
                  "slice": slice_phase,
                  "records": records_phase, "distill": distill_phase, "serve": serve_phase,
                  "parallel": lambda: parallel_phase(smi), "stream": stream_phase, "slow": slow_style_phase,
                  "bench": bench_phase}
        unknown = [a for a in argv if a not in chosen]
        if unknown:
            raise SystemExit(f"chip_smoke: unknown phases {unknown}; the phases are {list(chosen)}")
        for name in argv:
            chosen[name]()
        print(f"chip_smoke: partial run of phases {' '.join(argv)} (with device and build): passed; "
              f"no kernels or ok line")
        return
    k = kernel_phase()
    w = wgrad_phase()
    nm = norm_phase()
    cv = conv_phase()
    repro_phase()
    s = slice_phase()
    r = records_phase()
    d = distill_phase()
    serve_phase()
    p = parallel_phase(smi)
    st = stream_phase()
    ss = slow_style_phase()
    b = bench_phase()
    print(f"gram launches: {s['launches']} on the train slice, {r['launches']} training from TFRecords, "
          f"{d['gram_launches']} distilling, {p['launches']} in parallel.dryrun, {ss['launches']} on slow-style, "
          f"{b['launches']} in the bench")
    print(f"conv_wgrad launches: {s['wgrad_launches']} on the train slice, {r['wgrad_launches']} training from "
          f"TFRecords, {d['wgrad_launches']} distilling, {p['wgrad_launches']} in parallel.dryrun, "
          f"{b['wgrad_launches']} in the bench")
    print(f"instance_norm launches: {nm['frame_launches']} in the 4K packed-u8 bf16 forward, {st['launches']} in "
          f"the stream phase's {st['forwards']} forwards")
    print(f"direct_conv launches: {cv['launches']} in the conv phase, {nm['frame_conv_launches']} in the 4K "
          f"packed-u8 bf16 forward, {st['conv_launches']} in the stream phase")
    print(json.dumps({"kernels": [{
        "name": "gram",
        "route": "cuda",
        "source": "faststyle_tpu_torch/csrc/gram.cu",
        "replaces": "faststyle_tpu/ops/pallas/gram.py:22",
        "launches": s["launches"] + r["launches"] + d["gram_launches"] + p["launches"] + ss["launches"] + b["launches"],
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
    }, {
        # no TPU kernel stands behind it: the JAX package's conv2d, whose
        # weight gradient XLA derives
        "name": "conv_wgrad",
        "route": "cuda",
        "source": "faststyle_tpu_torch/csrc/conv_wgrad.cu",
        "replaces": "faststyle_tpu/ops/layers.py:59",
        "launches": (s["wgrad_launches"] + r["wgrad_launches"] + d["wgrad_launches"] + p["wgrad_launches"]
                     + b["wgrad_launches"]),
        "max_abs_err": w["max_abs_err"],
        "ms": w["ms"],
        "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"],
        "library_ms": w["library_ms"],
        "library_deterministic_ms": w["library_deterministic_ms"],
        "bfloat16_ms": w["bfloat16_ms"],
        "ffma_bound_ms": w["ffma_bound_ms"],
        "strip_ms": w["strip_ms"],
        "tile_ms": w["tile_ms"],
    }, {
        # no TPU kernel stands behind it: the JAX package's instance norm,
        # which XLA compiles
        "name": "instance_norm",
        "route": "cuda",
        "source": "faststyle_tpu_torch/csrc/instance_norm.cu",
        "replaces": "faststyle_tpu/ops/layers.py:227",
        "launches": nm["frame_launches"] + st["launches"],
        "ms": nm["device_ms"],
        "plain_ms": nm["plain_ms"],
        "bound_ms": nm["bound_ms"],
        "bound_by": "bytes",
        "float32_ms": nm["float32_device_ms"],
        "frame_fused_ms": nm["frame_fused_ms"],
        "frame_plain_ms": nm["frame_plain_ms"],
    }, {
        # no TPU kernel stands behind it: the JAX package's 9x9 convs, which
        # XLA compiles
        "name": "direct_conv",
        "route": "cuda",
        "source": "faststyle_tpu_torch/csrc/direct_conv.cu",
        "replaces": "faststyle_tpu/ops/layers.py:59",
        "launches": nm["frame_conv_launches"] + st["conv_launches"],
        "max_limit_ratio": cv["max_ratio"],
        "ms": cv["ms"],
        "initconv_0_ms": cv["initconv_0_ms"],
        "upsample_2_ms": cv["upsample_2_ms"],
        "plain_ms": cv["plain_ms"],
        "bound_ms": cv["bound_ms"],
        "bound_by": "bytes",
        "library_ms": cv["library_ms"],
        "frame_ms": nm["frame_fused_ms"],
        "frame_cudnn_9x9_ms": nm["frame_cudnn_9x9_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
