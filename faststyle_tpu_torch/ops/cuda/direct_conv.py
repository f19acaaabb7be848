"""The serving walk's two full-frame 9x9 convolutions with a CUDA kernel.

    y[n, oy, ox, co] = sum over kh, kw, ci of x[n, oy + kh - 4, ox + kw - 4, ci] * w[co, ci, kh, kw]

a 9x9 SAME conv at stride 1 (zero pad 4 a side), no bias, over NHWC bf16 x
with (ci, co) = (3, 16), the transform net's initconv_0, or (16, 3), its
upsample_2 (and the deconv variant's final conv, taken as the SAME conv
with the adjoint kernel). Products and sums in float32, rounded once to
bf16: the contract cuDNN's bf16 convs keep.

No TPU kernel stands behind it: the JAX package leaves this conv to XLA.
cuDNN's NHWC tensor-core kernels want channel counts in multiples of 8, so
at these shapes they compute mostly padding (a 3-channel frame copied out
to 8, or 3 outputs in a tile 32-128 wide): 6.7 and 6.2 ms at 3840x2160 on an
H100, against least times of 0.0996 and 0.0941 ms, bound by bytes. The
kernels are csrc/direct_conv.cu (CUDA C++ for sm_90a, built on first use by
`build`, bound with ctypes); its header gives the design. In short, blocks
stage input rows with their 4-px halo in shared memory by cp.async (cells
outside the image as zeros) while the last rows compute, hold the weights
in registers, and run mma.sync m16n8k16 on im2col fragments read in place,
each warp two output rows at once. Two forms, by (ci, co):
  * "pixels" (ci = 3, `direct_conv_kernel`): K = kh x (kw, ci), 27 padded
    to 32 a kh, N = co = 16; persistent blocks walk tiles of 16 x 128
    outputs;
  * "kn" (co = 3, `direct_conv_kn_kernel`): N = (kw, co), 27 of 32, K = ci
    a kh; the mma gives each input column's partials over (kw, co), and
    output column c sums partial (c + kw, kw, co) over kw; a block walks
    down a band of 88 output columns (96 staged input columns) 8 rows a
    step, the input rows streaming through a ring.
The tiling lives in the .cu file alone: a launch passes the blocks the card
holds at once (`card_slots`), and the kernel cuts the call from that.

`direct_conv` takes a contiguous [n, h, w, ci] bf16 x and [co, ci, 9, 9]
weights, and has no gradient. A CUDA tensor goes through the kernels or
raises; a CPU tensor through `direct_conv_plain`, `F.conv2d` in float32 on
the same bf16 values, rounded to bf16. `takes` is the rule by which
`layers.conv2d` routes a conv here, `engages` the same on the card;
`launches` counts calls that launched a kernel, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from faststyle_tpu_torch.ops.cuda import build

K = 9  # kernel extent
PAD = 4  # SAME pad a side
SHAPES = {(3, 16): "pixels", (16, 3): "kn"}  # (ci, co) -> form

launches = 0


def direct_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' plain version: F.conv2d in float32 on the same bf16
    values, SAME pad 4, rounded once to x's dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.to(x.dtype).float(), padding=PAD)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def takes(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME", bias=None,
          relu: bool = False) -> bool:
    """Whether a `layers.conv2d` call is one the kernels compute, wherever
    its tensors live: x bf16 [n, h, w, ci], a 9x9 kernel with (ci, co) one of
    SHAPES, stride 1, SAME, no bias, no relu, and autograd recording nothing
    (grad mode off, or neither x nor w requires grad)."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or w.dim() != 4 or bias is not None or relu:
        return False
    co, ci, kh, kw = w.shape
    if (kh, kw) != (K, K) or (ci, co) not in SHAPES or x.shape[3] != ci or stride != 1 or padding != "SAME":
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))


def engages(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME", bias=None,
            relu: bool = False) -> bool:
    """Whether the call runs as the kernels: on the card, where they `takes` it."""
    return x.is_cuda and takes(x, w, stride, padding, bias, relu)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"direct_conv: expected NHWC x and OIHW w, got {tuple(x.shape)} and {tuple(w.shape)}")
    co, ci, kh, kw = w.shape
    if (kh, kw) != (K, K) or (ci, co) not in SHAPES or x.shape[3] != ci:
        raise ValueError(f"direct_conv: takes 9x9 kernels with (ci, co) in {list(SHAPES)}, got x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"direct_conv: expected bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("direct_conv: expected a contiguous NHWC tensor")
    if x.numel() == 0:
        raise ValueError(f"direct_conv: empty input {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"direct_conv: w on {w.device}, x on {x.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("direct_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fs_direct_conv.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.fs_direct_conv.restype = i32
    lib.fs_direct_conv_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.fs_direct_conv_blocks_per_sm.restype = i32
    lib.fs_cuda_error_string.argtypes = [i32]
    lib.fs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().fs_cuda_error_string(err).decode()
        raise RuntimeError(f"direct conv {what} failed: {msg} (cuda error {err})")


@functools.cache
def card_slots(device_index: int, ci: int, co: int) -> int:
    """Blocks of the (ci, co) form the card holds at once: its SMs times the
    kernel's occupancy, read once per device and form."""
    per_sm = ctypes.c_int()
    with torch.cuda.device(device_index):
        _raise_on(_lib().fs_direct_conv_blocks_per_sm(ci, co, ctypes.byref(per_sm)), "occupancy query")
    return torch.cuda.get_device_properties(device_index).multi_processor_count * per_sm.value


def direct_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors (no autograd)."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return direct_conv_cuda(x, w)
    global launches
    n, h, wd, ci = x.shape
    co = w.shape[0]
    if x.data_ptr() % 16:  # the kernels stage 16-byte runs
        x = x.clone()
    w = w.to(torch.bfloat16).contiguous()
    y = torch.empty((n, h, wd, co), dtype=torch.bfloat16, device=dev)
    err = _lib().fs_direct_conv(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, ci, co,
                                card_slots(dev.index, ci, co), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "launch")
    launches += 1
    return y


def direct_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[n, h, w, ci] bf16 -> [n, h, w, co] bf16, the 9x9 SAME conv with w
    [co, ci, 9, 9] (cast to bf16); the kernel on a CUDA tensor, the plain
    version on the CPU."""
    _check(x, w)
    if x.is_cuda:
        return direct_conv_cuda(x, w)
    return direct_conv_plain(x, w)
