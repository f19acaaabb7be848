"""Convolution gradients that are deterministic by construction.

`Conv2dFunction` runs the forward as `F.conv2d` and its backward without
cuDNN's default gradient algorithms, whose choices for many of the train
step's float32 shapes split their sums and add the parts with atomics, so
two runs of one step differ in their last bits:
  * the data gradient dX is itself a convolution of dY, and in float32 (and
    on the CPU) runs as forward convolutions, which are deterministic on the
    card (the same reason the upsample convs run their phase forms,
    ops/layers.py) and, in float32 on an H100, 1-15x faster than cuDNN's
    data-gradient algorithms:
      - stride 1: dY convolved with the flipped, in/out-swapped kernel,
        padded by kh-1-ph and kw-1-pw;
      - stride s > 1: the sub-pixel phase decomposition, one stride-1 conv
        of dY with s*s*ci outputs (phase (ry, rx) takes the taps
        w[ry + s*j, rx + s*k]), then depth-to-space and a crop;
  * in float32 the weight gradient dW is the hand-written kernel of
    ops/cuda/conv_wgrad.py on the card (a fixed-order reduction, no
    atomics), or for the shapes `wgrad_by_kernel` gives to cuDNN, cuDNN's
    deterministic algorithm in a scoped flag; its plain im2col product on
    the CPU;
  * in bfloat16 on the card, dX and dW come from one call of cuDNN's
    deterministic algorithms in a scoped flag: there they are its default
    algorithms, as fast as the forward convolutions or faster at every
    shape of the step, and one call per convolution keeps the host-bound
    bf16 step's launches down;
  * the bias gradient is dY summed over n, y and x.
Only what `ctx.needs_input_grad` asks for is computed. dW is cast to the
weight's dtype: the caller casts the weight to the activations' dtype
first (ops/layers.conv2d), so in bf16 dW is rounded to bf16 before
autograd casts it back to float32, as the JAX package's vjp gives it.

`conv2d` takes the Function only when a gradient can flow (grad mode on
and x or w requiring one); otherwise it is `F.conv2d` itself, so serving,
`torch.no_grad` paths and CUDA-graph captures keep their ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from faststyle_tpu_torch.ops.cuda import conv_wgrad


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def phase_kernel(w: torch.Tensor, stride: int) -> torch.Tensor:
    """OIHW w [co, ci, kh, kw] -> the stride-1 kernel [s*s*ci, co, th, tw]
    (th = ceil(kh/s)) of its data gradient's phase decomposition: output
    channel (ry, rx, i), tap (t, u) = w[o, i, ry + s*(th-1-t), rx + s*(tw-1-u)],
    zero past the kernel's edge."""
    s = stride
    co, ci, kh, kw = w.shape
    th, tw = _cdiv(kh, s), _cdiv(kw, s)
    wp = F.pad(w, (0, s * tw - kw, 0, s * th - kh)).reshape(co, ci, th, s, tw, s)
    return wp.flip(2, 4).permute(3, 5, 1, 0, 2, 4).reshape(s * s * ci, co, th, tw)


def input_grad(dy: torch.Tensor, w: torch.Tensor, stride: int, padding: tuple[int, int],
               x_hw: tuple[int, int]) -> torch.Tensor:
    """dX [n, ci, h, w] of y = conv2d(x, w, stride, padding) from dY
    [n, co, oh, ow] (NCHW views), by forward convolutions only."""
    kh, kw = w.shape[2:]
    ph, pw = padding
    h, wd = x_hw
    if stride == 1:  # SAME and VALID pad at most k - 1, so the complementary pads are >= 0
        return F.conv2d(dy, w.flip(2, 3).transpose(0, 1), padding=(kh - 1 - ph, kw - 1 - pw))
    s = stride
    n, co, oh, ow = dy.shape
    ci = w.shape[1]
    th, tw = _cdiv(kh, s), _cdiv(kw, s)
    mh, mw = _cdiv(h + 2 * ph, s), _cdiv(wd + 2 * pw, s)  # phase rows and columns to cover Xpad
    dyp = F.pad(dy, (tw - 1, mw - ow, th - 1, mh - oh))
    y = F.conv2d(dyp, phase_kernel(w, s)).permute(0, 2, 3, 1)  # [n, mh, mw, (ry, rx, ci)]
    y = y.reshape(n, mh, mw, s, s, ci).permute(0, 1, 3, 2, 4, 5).reshape(n, mh * s, mw * s, ci)
    return y[:, ph : ph + h, pw : pw + wd].permute(0, 3, 1, 2)


def wgrad_by_kernel(w_shape: tuple, stride: int, dtype: torch.dtype) -> bool:
    """Whether a CUDA weight gradient runs the conv_wgrad kernel (True) or
    cuDNN's deterministic algorithm under a scoped
    `cudnn.flags(deterministic=True)` (False): a fixed rule on the shape,
    from the device-alone times of chip_smoke.py's wgrad phase on an H100
    (PERF.md section 6). In float32 the kernel wins every shape of the
    step but the 3x3 stride-1 convolutions over 64 or more input channels
    (the resblocks, whose deterministic cuDNN algorithm is its default). In
    bfloat16 every shape takes cuDNN, in the one call that gives dX too:
    the kernel's device-time gain on two shapes (0.12 ms of device time a step) does
    not pay for a second call on a host-bound step."""
    _, ci, kh, kw = w_shape
    return dtype != torch.bfloat16 and not (kh == kw == 3 and stride == 1 and ci >= 64)


class Conv2dFunction(torch.autograd.Function):
    """F.conv2d on an NCHW view (channels_last in memory) with symmetric
    padding; the backward above."""

    @staticmethod
    def forward(ctx, x, w, bias, stride: int, padding: tuple[int, int]):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, bias is not None)
        return F.conv2d(x, w, bias, stride=stride, padding=padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, has_bias = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        by_kernel = not x.is_cuda or wgrad_by_kernel(tuple(w.shape), stride, w.dtype)
        cudnn_x = need_x and x.is_cuda and w.dtype == torch.bfloat16
        cudnn_w = need_w and not by_kernel
        dx = dw = db = None
        if cudnn_x or cudnn_w:
            cudnn = torch.backends.cudnn
            with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=True,
                             allow_tf32=cudnn.allow_tf32):
                dx, dw, _ = torch.ops.aten.convolution_backward(dy, x, w, None, [stride] * 2, list(padding), [1, 1],
                                                                False, [0, 0], 1, [cudnn_x, cudnn_w, False])
        if need_x and not cudnn_x:
            dx = input_grad(dy, w, stride, padding, tuple(x.shape[2:]))
        if need_w and by_kernel:
            dw = conv_wgrad.conv_weight_grad(
                x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1), w.shape[2:], stride, padding
            ).to(w.dtype)
        if need_b and has_bias:
            db = dy.sum((0, 2, 3), dtype=torch.promote_types(dy.dtype, torch.float32)).to(dy.dtype)
        return dx, dw, db, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, bias, stride: int, padding: tuple[int, int]) -> torch.Tensor:
    """F.conv2d(x, w, bias, stride, padding) on an NCHW view, through
    Conv2dFunction when a gradient can flow into x, w or bias."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (bias is not None and bias.requires_grad)):
        return Conv2dFunction.apply(x, w, bias, stride, tuple(padding))
    return F.conv2d(x, w, bias, stride=stride, padding=padding)
