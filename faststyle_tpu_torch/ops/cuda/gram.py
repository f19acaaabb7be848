"""The normalized Gram matrix, the style loss's hot op, with its CUDA kernel.

    gram(F[b,h,w,c]) = reshape(F,[b,hw,c])^T @ reshape(F,[b,hw,c]) / (h*w*c)

Replaces faststyle_tpu/ops/pallas/gram.py:_gram_kernel. The kernel is
csrc/gram.cu (CUDA C++ for sm_90a, built on first use by `build`, bound
with ctypes); its header gives the design. In short: on an H100 each call
at the b4@256 training shapes is 2^31 FLOP against 8-67 MB read, so exact
f32 work is bound by operations, not bytes; the kernel tiles the c x c
output (upper triangle only, G is symmetric) and splits the hw reduction
across blocks so the card fills, then reduces the splits in a fixed order
(deterministic, no atomics) with the 1/(hwc) scale fused into the write.

`gram_matrix` takes NHWC float32 or bfloat16, contiguous, and returns
[b, c, c] float32. A CUDA tensor goes through the kernel or raises; a CPU
tensor goes through `gram_matrix_plain`, the kernel's plain PyTorch
version. The backward, F (G_bar + G_bar^T) / (hwc), is one matmul, as the
JAX package computes it outside Pallas.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from faststyle_tpu_torch.ops.cuda import build

KSTEP = 32  # rows per shared-memory stage in csrc/gram.cu
TILE = 64  # output tile edge in csrc/gram.cu
BLOCKS_PER_SM = 4  # split hw until about this many blocks per SM are in flight


def gram_matrix_plain(feats: torch.Tensor) -> torch.Tensor:
    """The plain version: an f32 batched matmul and the 1/(hwc) scale."""
    b, h, w, c = feats.shape
    f = feats.reshape(b, h * w, c).float()
    return torch.matmul(f.transpose(1, 2), f) / float(h * w * c)


def plan(b: int, hw: int, c: int, num_sms: int) -> tuple[int, int]:
    """(splits, chunk): cut each image's hw rows into `splits` slices of
    `chunk` rows (a multiple of KSTEP) so that splits x b x upper-triangle
    tiles is about BLOCKS_PER_SM blocks per SM, and never a slice of zero rows."""
    nt = -(-c // TILE)
    tiles = nt * (nt + 1) // 2
    want = -(-BLOCKS_PER_SM * num_sms // (b * tiles))
    splits = max(1, min(want, -(-hw // KSTEP), 65535))
    rows = -(-hw // splits)
    chunk = -(-rows // KSTEP) * KSTEP
    return -(-hw // chunk), chunk


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
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # splits, chunk, inv_norm
        ctypes.c_void_p,  # stream
    ]
    lib.fs_gram_forward.restype = ctypes.c_int
    lib.fs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def gram_cuda(feats: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a checked CUDA tensor (no autograd)."""
    b, h, w, c = feats.shape
    hw = h * w
    if b > 65535:
        raise ValueError(f"gram_matrix: batch {b} exceeds the kernel's grid limit")
    lib = _lib()
    with torch.cuda.device(feats.device):
        sms = torch.cuda.get_device_properties(feats.device).multi_processor_count
        splits, chunk = plan(b, hw, c, sms)
        partial = torch.empty(splits * b * c * c, dtype=torch.float32, device=feats.device)
        out = torch.empty((b, c, c), dtype=torch.float32, device=feats.device)
        err = lib.fs_gram_forward(
            feats.data_ptr(), partial.data_ptr(), out.data_ptr(),
            int(feats.dtype == torch.bfloat16), b, hw, c, splits, chunk,
            1.0 / float(hw * c), torch.cuda.current_stream(feats.device).cuda_stream,
        )
    if err != 0:
        msg = lib.fs_cuda_error_string(err).decode()
        raise RuntimeError(f"gram kernel launch failed: {msg} (cuda error {err})")
    GramFunction.launches += 1
    return out


class GramFunction(torch.autograd.Function):
    """Differentiable Gram: the kernel forward on CUDA (the plain version on
    CPU) and F (G_bar + G_bar^T) / (hwc) backward, cast to F's dtype.
    `launches` counts kernel launches, and nothing else."""

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
