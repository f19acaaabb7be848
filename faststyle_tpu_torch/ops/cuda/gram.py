"""The normalized Gram matrix, the style loss's hot op, with its CUDA kernel.

    gram(F[b,h,w,c]) = reshape(F,[b,hw,c])^T @ reshape(F,[b,hw,c]) / (h*w*c)

Replaces faststyle_tpu/ops/pallas/gram.py:_gram_kernel. The kernel is
csrc/gram.cu (CUDA C++ for sm_90a, built on first use by `build`, bound
with ctypes); its header gives the design. In short, on an H100 each call
is bound by its bytes (conv1_2 and conv2_2 at b4@256, and bf16) or by its
3xTF32 tensor-core operations over the c(c+1)/2 distinct entries (conv3_3,
conv4_3): 0.0200, 0.0101, 0.0065 and 0.0065 ms for the four float32 style
layers, 0.0051 ms for conv2_2 in bf16. The kernel runs bf16 on mma.sync
bf16 and float32 as 3xTF32 (near-f32 error; two passes on diagonal
tiles), copies rows of F through a cp.async ring, reads each row once per
upper-triangle output tile (one tile owns the whole output for c <= 128),
and splits the hw rows across blocks only as far as `plan` says: enough
blocks to fill the card's block slots, with the split scratch at or under
half the input's bytes. One split is one launch; more add a reduce that
sums them in a fixed order (deterministic, no atomics) with the 1/(hwc)
scale fused.

`gram_matrix` takes NHWC float32 or bfloat16, contiguous, and returns
[b, c, c] float32. A CUDA tensor goes through the kernel or raises; a CPU
tensor goes through `gram_matrix_plain`, the kernel's plain PyTorch
version. The backward, F (G_bar + G_bar^T) / (hwc), is one matmul, as the
JAX package computes it outside Pallas.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from faststyle_tpu_torch.ops.cuda import build

KSTEP = 32  # rows per shared-memory ring stage in csrc/gram.cu
TILES = (64, 128)  # output tile edges the kernel is built for
RESIDENT = {64: 2, 128: 1}  # blocks of each tile edge an SM holds at once


class GramPlan(NamedTuple):
    """How one call is cut: `splits` slices of `chunk` rows per image, over
    `tile` x `tile` upper-triangle output tiles, `blocks` blocks in all."""

    splits: int
    chunk: int
    tile: int
    blocks: int

    @property
    def launches(self) -> int:
        """Kernel launches per call: the tile kernel, plus the reduce when split."""
        return 1 if self.splits == 1 else 2


def gram_matrix_plain(feats: torch.Tensor) -> torch.Tensor:
    """The plain version: an f32 batched matmul and the 1/(hwc) scale."""
    b, h, w, c = feats.shape
    f = feats.reshape(b, h * w, c).float()
    return torch.matmul(f.transpose(1, 2), f) / float(h * w * c)


@functools.cache
def plan(b: int, hw: int, c: int, dtype: torch.dtype, num_sms: int) -> GramPlan:
    """The launch plan for a [b, hw, c] input of `dtype` on a card with
    `num_sms` SMs. One 128-wide tile owns the output when 64 < c <= 128,
    else 64-wide tiles. Each image's hw rows are cut into `splits` slices
    of `chunk` rows (whole KSTEP-row stages, none empty). The split count
    fills the card as evenly as it can: it minimises the rows a block walks
    times the waves of blocks, ceil(blocks / (num_sms * RESIDENT[tile])) *
    chunk, taking the fewest splits on a tie; and it never lets the scratch
    (splits x b x c^2 float32) outweigh half the input, so from the cap on
    one split, one launch, is the rule."""
    tile = TILES[1] if TILES[0] < c <= TILES[1] else TILES[0]
    nt = _cdiv(c, tile)
    tiles = b * nt * (nt + 1) // 2
    elem = torch.finfo(dtype).bits // 8
    cap = (b * hw * c * elem // 2) // (b * c * c * 4)
    slots = num_sms * RESIDENT[tile]
    most = max(1, min(cap, _cdiv(hw, KSTEP), 65535, 4 * _cdiv(slots, tiles)))
    best = None
    for want in range(1, most + 1):
        chunk = _cdiv(_cdiv(hw, want), KSTEP) * KSTEP
        splits = _cdiv(hw, chunk)
        busiest = _cdiv(tiles * splits, slots) * chunk
        if best is None or busiest < best[0]:
            best = (busiest, splits, chunk)
    _, splits, chunk = best
    return GramPlan(splits, chunk, tile, tiles * splits)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(feats: torch.Tensor) -> None:
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gram_matrix: unsupported device {feats.device}")
    if feats.dim() != 4:
        raise ValueError(f"gram_matrix: expected NHWC [b,h,w,c], got shape {tuple(feats.shape)}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gram_matrix: expected float32 or bfloat16, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("gram_matrix: expected a contiguous NHWC tensor")
    if feats.numel() == 0:
        raise ValueError(f"gram_matrix: empty input {tuple(feats.shape)}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("gram")
    lib.fs_gram_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # feats, partial, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # is_bf16, b, hw, c
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,  # splits, chunk, tile, inv_norm
        ctypes.c_void_p,  # stream
    ]
    lib.fs_gram_forward.restype = ctypes.c_int
    lib.fs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fs_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def num_sms(device_index: int) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def gram_cuda(feats: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a checked CUDA tensor (no autograd)."""
    dev = feats.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return gram_cuda(feats)
    b, h, w, c = feats.shape
    hw = h * w
    lib = _lib()
    p = plan(b, hw, c, feats.dtype, num_sms(dev.index))
    out = torch.empty((b, c, c), dtype=torch.float32, device=dev)
    partial = torch.empty(p.splits * b * c * c, dtype=torch.float32, device=dev) if p.splits > 1 else None
    err = lib.fs_gram_forward(
        feats.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
        int(feats.dtype == torch.bfloat16), b, hw, c, p.splits, p.chunk, p.tile,
        1.0 / float(hw * c), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.fs_cuda_error_string(err).decode()
        raise RuntimeError(f"gram kernel launch failed: {msg} (cuda error {err})")
    GramFunction.launches += 1
    return out


class GramFunction(torch.autograd.Function):
    """Differentiable Gram: the kernel forward on CUDA (the plain version on
    CPU) and F (G_bar + G_bar^T) / (hwc) backward, cast to F's dtype.
    `launches` counts calls that launched the kernel, and nothing else."""

    launches = 0

    @staticmethod
    def forward(ctx, feats: torch.Tensor) -> torch.Tensor:
        _check(feats)
        ctx.save_for_backward(feats)
        if feats.is_cuda:
            return gram_cuda(feats)
        return gram_matrix_plain(feats)

    @staticmethod
    def backward(ctx, g_bar: torch.Tensor) -> torch.Tensor:
        (feats,) = ctx.saved_tensors
        b, h, w, c = feats.shape
        sym = (g_bar + g_bar.transpose(1, 2)) / float(h * w * c)
        f = feats.reshape(b, h * w, c).float()
        return torch.matmul(f, sym.float()).reshape(feats.shape).to(feats.dtype)


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """[b,h,w,c] -> [b,c,c] normalized Gram in float32 (differentiable)."""
    return GramFunction.apply(feats)
