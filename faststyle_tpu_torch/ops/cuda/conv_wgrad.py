"""The weight gradient of a 2-D convolution, with its CUDA kernel.

    dW[o, i, kh, kw] = sum over n, y, x of dY[n, y, x, o] * Xpad[n, y*s + kh, x*s + kw, i]

X [n, h, w, ci] and dY [n, oh, ow, co] are NHWC; Xpad is X zero-padded by
(ph, pw) on both sides; dW is [co, ci, kh, kw] (OIHW) float32. The kernel
is csrc/conv_wgrad.cu (CUDA C++ for sm_90a, built on first use by `build`,
bound with ctypes); its header gives the design: an implicit GEMM over the
n*oh*ow output pixels on the tensor cores (bf16 mma.sync; float32 as
3xTF32), the im2col rows of X gathered on the fly, the pixel rows split
across blocks as `plan` says and the splits added in a fixed order. No
atomics, so two calls on the same inputs give the same bits: it is what
makes the train step reproducible on the card (ops/conv_grad.py).

No TPU kernel stands behind it (the JAX package's conv gradients are
XLA's). A CUDA tensor goes through the kernel or raises; a CPU tensor goes
through `conv_weight_grad_plain`, the im2col product in plain PyTorch.
`launches` counts calls that launched the kernel, and nothing else;
`relayouts` counts inputs that had to be copied to NHWC first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from faststyle_tpu_torch.ops.cuda import build

KSTEP = 32  # pixel rows per shared-memory stage in csrc/conv_wgrad.cu
TP = 128  # im2col columns per output tile
TILE_C = (8, 16, 32, 64)  # output-channel tile widths the kernel is built for
RESIDENT = 2  # blocks an SM holds at once

launches = 0
relayouts = 0


class WgradPlan(NamedTuple):
    """How one call is cut: `splits` slices of `chunk` pixel rows over
    128 x `tile_c` output tiles, `blocks` blocks in all."""

    splits: int
    chunk: int
    tile_c: int
    blocks: int

    @property
    def launches(self) -> int:
        """Kernel launches per call: the tile kernel, plus the reduce when split."""
        return 1 if self.splits == 1 else 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    """Output extent of a conv over n with kernel k, stride and pad per side."""
    return (n + 2 * pad - k) // stride + 1


@functools.cache
def plan(rows: int, p: int, co: int, in_bytes: int, num_sms: int) -> WgradPlan:
    """The launch plan for `rows` = n*oh*ow output pixels, p = kh*kw*ci
    im2col columns and co output channels, with X and dY together
    `in_bytes` long, on a card with `num_sms` SMs. The split count fills the
    card as evenly as it can, minimising the rows a block walks times the
    waves of blocks, taking the fewest splits on a tie; and the split
    scratch (splits x p x co float32) never outweighs half the input, the
    byte budget of ops/cuda/gram.py's plan."""
    tile_c = next((t for t in TILE_C if co <= t), TILE_C[-1])
    tiles = _cdiv(p, TP) * _cdiv(co, tile_c)
    cap = (in_bytes // 2) // (p * co * 4)
    slots = num_sms * RESIDENT
    most = max(1, min(cap, _cdiv(rows, KSTEP), 65535, 4 * _cdiv(slots, tiles)))
    best = None
    for want in range(1, most + 1):
        chunk = _cdiv(_cdiv(rows, want), KSTEP) * KSTEP
        splits = _cdiv(rows, chunk)
        busiest = _cdiv(tiles * splits, slots) * chunk
        if best is None or busiest < best[0]:
            best = (busiest, splits, chunk)
    _, splits, chunk = best
    return WgradPlan(splits, chunk, tile_c, tiles * splits)


def _check(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int, padding) -> None:
    if x.device != dy.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_weight_grad: x on {x.device}, dy on {dy.device}")
    if x.dim() != 4 or dy.dim() != 4 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"conv_weight_grad: expected NHWC x and dy, got {tuple(x.shape)}, {tuple(dy.shape)}")
    if x.dtype != dy.dtype or x.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"conv_weight_grad: x {x.dtype} and dy {dy.dtype} must be one of float32, bfloat16")
    (kh, kw), (ph, pw) = kernel_size, padding
    _, h, w, _ = x.shape
    want = (out_size(h, kh, stride, ph), out_size(w, kw, stride, pw))
    if tuple(dy.shape[1:3]) != want:
        raise ValueError(f"conv_weight_grad: dy {tuple(dy.shape)} does not match x {tuple(x.shape)}, "
                         f"kernel {kernel_size}, stride {stride}, padding {padding} (want {want})")


def conv_weight_grad_plain(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int, padding) -> torch.Tensor:
    """The plain version: im2col of X (unfold) times the rows of dY, summed
    in float32 (float64 for float64 input). Returns [co, ci, kh, kw]."""
    _check(x, dy, kernel_size, stride, padding)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    n, _, _, ci = x.shape
    co = dy.shape[3]
    cols = F.unfold(x.permute(0, 3, 1, 2).to(acc), kernel_size, padding=padding, stride=stride)  # [n, ci*kh*kw, L]
    rows = dy.to(acc).reshape(n, -1, co)  # [n, L, co]
    return torch.einsum("nkl,nlo->ok", cols, rows).reshape(co, ci, *kernel_size)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("conv_wgrad")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fs_conv_wgrad.argtypes = [
        ptr, ptr, ptr, ptr, i32,  # x, dy, partial, out, is_bf16
        i32, i32, i32, i32,  # n, h, w, ci
        i32, i32, i32,  # oh, ow, co
        i32, i32, i32, i32, i32,  # kh, kw, s, ph, pw
        i32, ctypes.c_longlong, i32,  # splits, chunk, tile_c
        ptr,  # stream
    ]
    lib.fs_conv_wgrad.restype = ctypes.c_int
    lib.fs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fs_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def num_sms(device_index: int) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous NHWC tensor, counting the copies it takes."""
    global relayouts
    if t.is_contiguous():
        return t
    relayouts += 1
    return t.contiguous()


def conv_weight_grad_cuda(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int, padding) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors."""
    global launches
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return conv_weight_grad_cuda(x, dy, kernel_size, stride, padding)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_weight_grad: the kernel takes float32 or bfloat16, got {x.dtype}")
    x, dy = _nhwc(x), _nhwc(dy)
    (kh, kw), (ph, pw) = kernel_size, padding
    n, h, w, ci = x.shape
    _, oh, ow, co = dy.shape
    p = kh * kw * ci
    rows = n * oh * ow
    pl = plan(rows, p, co, (x.numel() + dy.numel()) * x.element_size(), num_sms(dev.index))
    out = torch.empty((co, ci, kh, kw), dtype=torch.float32, device=dev)
    partial = torch.empty(pl.splits * p * co, dtype=torch.float32, device=dev) if pl.splits > 1 else None
    lib = _lib()
    err = lib.fs_conv_wgrad(
        x.data_ptr(), dy.data_ptr(), None if partial is None else partial.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), n, h, w, ci, oh, ow, co, kh, kw, stride, ph, pw,
        pl.splits, pl.chunk, pl.tile_c, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.fs_cuda_error_string(err).decode()
        raise RuntimeError(f"conv_wgrad kernel launch failed: {msg} (cuda error {err})")
    launches += 1
    return out


def conv_weight_grad(x: torch.Tensor, dy: torch.Tensor, kernel_size, stride: int = 1, padding=(0, 0)) -> torch.Tensor:
    """NHWC x [n,h,w,ci] and dy [n,oh,ow,co] -> dW [co, ci, kh, kw] float32:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    kernel_size, padding = tuple(kernel_size), tuple(padding)
    _check(x, dy, kernel_size, stride, padding)
    if x.is_cuda:
        return conv_weight_grad_cuda(x, dy, kernel_size, stride, padding)
    return conv_weight_grad_plain(x, dy, kernel_size, stride, padding)
