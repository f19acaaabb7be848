"""Instance norm fused with what follows it, the serving path's norms, with
a CUDA kernel pair.

    y = scale * ((x - mean) * rsqrt(var + eps)) + shift,  then an epilogue

over NHWC x, with moments over H and W in float32 whatever the
activation's dtype (`layers.instance_norm`; var = M2 / (count -
correction): the transform net's eps 1e-3 with the biased variance, the
default, or AdaIN's 1e-5 with the unbiased one, the style's sigma and mean
as scale and shift), then one of EPILOGUES:
"none"; "relu"; "residual", + skip[:, 2:-2, 2:-2], a resblock's input;
"tanh", `layers.scaled_tanh`; "tanh_u8", the scaled tanh clamped to
[0, 255] and cast to uint8, as `transform_net.apply`'s uint8 output.

No TPU kernel stands behind it: the JAX package's instance norm is XLA's.
The kernels are csrc/instance_norm.cu (CUDA C++ for sm_90a, built on first
use by `build`, bound with ctypes); its header gives the design. In short,
each norm is bound by its bytes on an H100: x read twice and the output
written once, 6 bytes an element in bf16 (12 in float32), against ~48 in
the plain PyTorch chain. `instance_norm_stats_kernel` walks contiguous
slabs of each image with 16-byte loads, a thread always meeting the same
channels, and keeps per-channel Welford moments in float32;
`instance_norm_merge_kernel` merges the slabs' moments in a fixed order
(Chan's formula; no atomics, so two calls give the same bits) into the
mean and rsqrt(var + eps); `instance_norm_apply_kernel` reads x once more,
applies them with the epilogue fused, and writes once. The apply rounds
where the plain chain rounds, so given the same mean and rstd the two
outputs are equal bit for bit; only the moments' summation order differs
from `torch.var_mean`'s.

`instance_norm_epilogue` takes NHWC float32 or bfloat16, contiguous, with
C dividing 384 (3, 16, 32 and 64 in the net) or a 16-byte load's stride,
384 * 16 / element size (AdaIN's 512), and has no gradient. A CUDA
tensor goes through the kernels or raises; a CPU tensor through
`instance_norm_epilogue_plain`, `layers.instance_norm` followed by the
same epilogue. `engages` says when the transform net's walk takes it.
`launches` counts calls that launched the kernels, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from faststyle_tpu_torch.ops import layers as L
from faststyle_tpu_torch.ops.cuda import build

EPILOGUES = ("none", "relu", "residual", "tanh", "tanh_u8")
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 384  # a block's threads in csrc/instance_norm.cu; C divides it, or THREADS * a vector

launches = 0


class NormPlan(NamedTuple):
    """How one call is cut: `vec` elements a load (16 bytes' worth, or 1);
    the statistics over `splits` slabs of `slab` elements an image; the
    apply over `blocks` blocks an image."""

    vec: int
    splits: int
    slab: int
    blocks: int


def epilogue_plain(y: torch.Tensor, epilogue: str, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What follows the norm, on its output y, in plain PyTorch."""
    if epilogue == "none":
        return y
    if epilogue == "relu":
        return L.relu(y)
    if epilogue == "residual":
        return y + skip[:, 2:-2, 2:-2, :]
    if epilogue == "tanh":
        return L.scaled_tanh(y)
    if epilogue == "tanh_u8":
        return L.scaled_tanh(y).clamp(0, 255).to(torch.uint8)
    raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")


def instance_norm_epilogue_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    epilogue: str = "none",
    skip: Optional[torch.Tensor] = None,
    stats: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    eps: float = 1e-3,
    correction: int = 0,
) -> torch.Tensor:
    """The kernels' plain version: `layers.instance_norm`, then the
    epilogue. `stats` = (mean, rstd), each [n, c] float32, replaces the
    moments with given ones in the same chain (the card's check hands it
    the kernels' own)."""
    y = L.instance_norm(x, scale, shift, eps, stats=stats, correction=correction)
    return epilogue_plain(y, epilogue, skip)


def takes(x: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """Whether the kernels take a norm wherever its activation lives: x is
    float32 or bfloat16, and autograd records nothing through it (grad
    mode off, or none of x and `others` requires grad)."""
    if x.dtype not in DTYPES:
        return False
    return not torch.is_grad_enabled() or not any(t is not None and t.requires_grad for t in (x, *others))


def engages(x: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """Whether a norm of the walk runs as the kernels: on the card, where
    they `takes` it."""
    return x.is_cuda and takes(x, *others)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def plan(n: int, hwc: int, vec: int, slots: tuple[int, int]) -> NormPlan:
    """The launch plan for n images of hwc elements, `vec` a load, where the
    card holds `slots` = (statistics, apply) blocks at once: each kernel
    one wave of at most that many blocks, the same number an image (fewer
    when an image has fewer vectors than a block's stride), so every SM
    finishes its equal share together; slabs a whole number of block
    strides, none empty."""
    stride = THREADS * vec
    most = _cdiv(hwc, stride)
    want = max(1, min(slots[0] // n, most))
    slab = _cdiv(_cdiv(hwc, want), stride) * stride
    return NormPlan(vec, _cdiv(hwc, slab), slab, max(1, min(slots[1] // n, most)))


def fits(c: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take C channels of `dtype`: C divides a block's
    stride of THREADS 16-byte vectors (THREADS itself, for the walk with one
    element a load)."""
    return c > 0 and (THREADS * 128 // torch.finfo(dtype).bits) % c == 0


def vector_width(x: torch.Tensor, skip: Optional[torch.Tensor]) -> int:
    """16 bytes of elements a load when every pointer is 16-byte aligned,
    each image's elements fill whole vectors and (for the residual) each
    row of C-wide pixels does too; else 1."""
    _, h, w, c = x.shape
    vec = 16 // x.element_size()
    ptrs = [x.data_ptr()] + ([] if skip is None else [skip.data_ptr()])
    if any(p % 16 for p in ptrs) or (h * w * c) % vec or (skip is not None and c % vec):
        return 1
    return vec


def _check(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, epilogue: str,
           skip: Optional[torch.Tensor], eps: float, correction: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"instance_norm_epilogue: expected NHWC [n,h,w,c], got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if x.dtype not in DTYPES:
        raise TypeError(f"instance_norm_epilogue: expected float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("instance_norm_epilogue: expected a contiguous NHWC tensor")
    if x.numel() == 0:
        raise ValueError(f"instance_norm_epilogue: empty input {tuple(x.shape)}")
    if not fits(c, x.dtype):
        raise ValueError(f"instance_norm_epilogue: C must divide {THREADS} or {THREADS} 16-byte vectors, got {c}")
    if correction not in (0, 1) or not eps > 0 or (correction and h * w < 2):
        raise ValueError(f"instance_norm_epilogue: needs eps > 0 and a correction of 0, or 1 over 2 pixels or more; "
                         f"got eps {eps}, correction {correction} over {h}x{w}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (c,) or t.device != x.device:
            raise ValueError(f"instance_norm_epilogue: {name} must be [{c}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"instance_norm_epilogue: epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if (epilogue == "residual") != (skip is not None):
        raise ValueError("instance_norm_epilogue: a skip tensor goes with the residual epilogue, and only there")
    if skip is not None and (skip.shape != (n, h + 4, w + 4, c) or skip.dtype != x.dtype
                             or skip.device != x.device or not skip.is_contiguous()):
        raise ValueError(f"instance_norm_epilogue: skip must be a contiguous {x.dtype} [{n},{h + 4},{w + 4},{c}] "
                         f"on {x.device}, got {skip.dtype} {tuple(skip.shape)} on {skip.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("instance_norm")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fs_instance_norm_stats.argtypes = [
        ptr, ptr, ptr, ptr,  # x, partial, mean, rstd
        i32, i32, i32, i64, i32,  # is_bf16, vec, n, hwc, c
        i32, i64, ctypes.c_float, i32, ptr,  # splits, slab, eps, correction, stream
    ]
    lib.fs_instance_norm_stats.restype = i32
    lib.fs_instance_norm_apply.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # x, skip, out, mean, rstd, scale, shift
        i32, i32, i32,  # is_bf16, vec, epilogue
        i32, i32, i32, i32, i32, ptr,  # n, h, w, c, blocks, stream
    ]
    lib.fs_instance_norm_apply.restype = i32
    lib.fs_instance_norm_blocks_per_sm.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.fs_instance_norm_blocks_per_sm.restype = i32
    lib.fs_cuda_error_string.argtypes = [i32]
    lib.fs_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def card_slots(device_index: int, dtype: torch.dtype, vec: int, epilogue: str) -> tuple[int, int]:
    """(statistics, apply) blocks the card holds at once: its SMs times the
    kernels' occupancy, read once per device and kernel."""
    per_sm = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        err = _lib().fs_instance_norm_blocks_per_sm(int(dtype == torch.bfloat16), vec, EPILOGUES.index(epilogue),
                                                    per_sm)
    _raise_on(err, "occupancy")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm[0], sms * per_sm[1]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().fs_cuda_error_string(err).decode()
        raise RuntimeError(f"instance norm {what} launch failed: {msg} (cuda error {err})")


def _plan_for(x: torch.Tensor, epilogue: str, skip: Optional[torch.Tensor]) -> NormPlan:
    n, h, w, c = x.shape
    vec = vector_width(x, skip)
    return plan(n, h * w * c, vec, card_slots(x.device.index, x.dtype, vec, epilogue))


def stats_cuda(x: torch.Tensor, p: Optional[NormPlan] = None, eps: float = 1e-3,
               correction: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The statistics kernels on a checked CUDA tensor: (mean, rsqrt(var +
    eps)), each [n, c] float32, var with the given correction."""
    n, h, w, c = x.shape
    p = p or _plan_for(x, "none", None)
    stats = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    partial = torch.empty(n * p.splits * c * 3, dtype=torch.float32, device=x.device)
    err = _lib().fs_instance_norm_stats(
        x.data_ptr(), partial.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
        int(x.dtype == torch.bfloat16), p.vec, n, h * w * c, c, p.splits, p.slab, eps, correction,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "statistics")
    return stats[0], stats[1]


def instance_norm_epilogue_cuda(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, epilogue: str,
                                skip: Optional[torch.Tensor], eps: float = 1e-3,
                                correction: int = 0) -> torch.Tensor:
    """Launch the kernel pair on checked CUDA tensors (no autograd)."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return instance_norm_epilogue_cuda(x, scale, shift, epilogue, skip, eps, correction)
    global launches
    n, h, w, c = x.shape
    if (THREADS * vector_width(x, skip)) % c:  # a C that needs whole vectors, on an unaligned tensor
        x, skip = x.clone(), None if skip is None else skip.clone()
    p = _plan_for(x, epilogue, skip)
    mean, rstd = stats_cuda(x, p, eps, correction)
    scale, shift = scale.float().contiguous(), shift.float().contiguous()
    out = torch.empty(x.shape, dtype=torch.uint8 if epilogue == "tanh_u8" else x.dtype, device=dev)
    err = _lib().fs_instance_norm_apply(
        x.data_ptr(), None if skip is None else skip.data_ptr(), out.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), scale.data_ptr(), shift.data_ptr(), int(x.dtype == torch.bfloat16), p.vec,
        EPILOGUES.index(epilogue), n, h, w, c, p.blocks, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "apply")
    launches += 1
    return out


def instance_norm_epilogue(
    x: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    epilogue: str = "none",
    skip: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
    correction: int = 0,
) -> torch.Tensor:
    """[n,h,w,c] -> the norm with its epilogue, x's dtype (uint8 for
    "tanh_u8"); the kernels on a CUDA tensor, the plain version on the CPU.
    `eps` and `correction` (0: the biased variance, 1: the unbiased) as
    `layers.instance_norm` takes them."""
    _check(x, scale, shift, epilogue, skip, eps, correction)
    if x.is_cuda:
        return instance_norm_epilogue_cuda(x, scale, shift, epilogue, skip, eps, correction)
    return instance_norm_epilogue_plain(x, scale, shift, epilogue, skip, eps=eps, correction=correction)
