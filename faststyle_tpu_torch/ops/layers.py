"""Layer primitives for the transform net and VGG tower (counterpart of
faststyle_tpu/ops/layers.py).

Activations are NHWC at every public function, as in the JAX package.
Kernels are in torch layouts: OIHW for convolutions, IOHW for transposed
convolutions (`convert` maps the files' HWIO/HWOI to these). Convolutions
run on the NCHW view of an NHWC tensor, which is `channels_last` in memory,
so the permutes at the boundary move no data.

Numerical contracts kept from the JAX package:
  * reflect_pad      — TF REFLECT, repeating for pads >= the extent
  * conv2d SAME      — TF's split, pad_lo = pad_total // 2
  * transposed_conv2d — TF SAME transposed conv (the adjoint of SAME)
  * instance norm    — biased moments in float32, eps=1e-3 inside the rsqrt
  * scaled_tanh      — (255*tanh(x) + 255) / 2, in float32
  * relu             — subgradient 0 at x == 0 (torch.relu's own rule)
  * max_pool_2x2_same — TF SAME: odd extents pad the high side with -inf
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from faststyle_tpu_torch.ops import conv_grad


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    # contiguous() is free when the conv kept channels_last (the usual case)
    return x.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Padding / resize
# ---------------------------------------------------------------------------


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each position of a REFLECT-padded axis of length n.
    Reflection is periodic with period 2(n-1), which is what jnp.pad does
    for pads >= n (torch's 'reflect' mode refuses those)."""
    pos = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(pos)
    period = 2 * (n - 1)
    m = pos.remainder(period)
    return torch.where(m >= n, period - m, m)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """REFLECT-pad H and W of an NHWC tensor by `pad` px per side."""
    _, h, w, _ = x.shape
    x = x.index_select(1, _reflect_index(h, pad, x.device))
    return x.index_select(2, _reflect_index(w, pad, x.device))


def resize_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest-neighbour upsample of NHWC (pixel replication)."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME", bias=None
) -> torch.Tensor:
    """NHWC x OIHW convolution; SAME/VALID as TF defines them (SAME splits
    the pad as pad_lo = total // 2, so stride-2 on an even extent pads
    (0, 1), which torch's symmetric `padding=` cannot express). When a
    gradient can flow, its backward is ops/conv_grad's: forward convs and
    the deterministic weight-gradient kernel, not cuDNN's atomics."""
    k_h, k_w = w.shape[2], w.shape[3]
    xn = _nchw(x)
    pad = (0, 0)
    if padding == "SAME":
        ph = _same_pads(x.shape[1], k_h, stride)
        pw = _same_pads(x.shape[2], k_w, stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(conv_grad.conv2d(xn, w.to(x.dtype), b, stride, pad))


def transposed_conv2d(x: torch.Tensor, w_iohw: torch.Tensor, stride: int) -> torch.Tensor:
    """TF `conv2d_transpose(..., padding='SAME')` with output H*s x W*s: the
    adjoint of the SAME strided conv on that output. torch's transposed conv
    yields the adjoint onto the forward conv's PADDED input, (H-1)*s + k
    long; the real output is that with the forward pad (lo, hi) cut off."""
    k = w_iohw.shape[2]
    out_h, out_w = x.shape[1] * stride, x.shape[2] * stride
    lo_h = _same_pads(out_h, k, stride)[0]
    lo_w = _same_pads(out_w, k, stride)[0]
    y = F.conv_transpose2d(_nchw(x), w_iohw.to(x.dtype), stride=stride)
    return _nhwc(y[:, :, lo_h : lo_h + out_h, lo_w : lo_w + out_w])


def upsample_conv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Resize-convolution as the reference writes it: NN-resize 4x, then a
    SAME stride-2 conv (a net 2x upsample). The oracle for upsample_conv."""
    return conv2d(resize_nearest(x, 4), w, stride=2, padding="SAME")


def upsample_phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """3x3 OIHW kernel -> the 2-tap phase kernel [4*cout, cin, 2, 2] of the
    fused resize-convolution; phase order (hy, hx) row-major in the output
    channels. Per axis: even phase taps (w0+w1+w2, 0), odd (w0+w1, w2)."""
    if w.shape[2:] != (3, 3):
        raise ValueError(f"specialized for 3x3 kernels, got {tuple(w.shape)}")
    w = w.float()
    zero = torch.zeros_like(w[:, :, 0])
    even_h = torch.stack([w[:, :, 0] + w[:, :, 1] + w[:, :, 2], zero], dim=2)
    odd_h = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)  # [o,i,2,kw]
    phases = []
    for ph in (even_h, odd_h):
        zw = torch.zeros_like(ph[..., 0])
        phases.append(torch.stack([ph[..., 0] + ph[..., 1] + ph[..., 2], zw], dim=3))
        phases.append(torch.stack([ph[..., 0] + ph[..., 1], ph[..., 2]], dim=3))
    return torch.cat(phases, dim=0)


def deconv_phase_kernel(w_iohw: torch.Tensor) -> torch.Tensor:
    """3x3 IOHW stride-2 SAME transposed-conv kernel -> the 2-tap phase
    kernel [4*cout, cin, 2, 2] of its sub-pixel decomposition (taps read
    x[m-1], x[m]: a 2x2 VALID conv over x zero-padded by 1 at LO). With
    v = the adjoint kernel (flipped, io-swapped), per axis: even phase taps
    (v0, v2), odd (0, v1)."""
    if w_iohw.shape[2:] != (3, 3):
        raise ValueError(f"specialized for 3x3 kernels, got {tuple(w_iohw.shape)}")
    v = w_iohw.flip(2, 3).transpose(0, 1).float()  # OIHW of the adjoint conv
    zero = torch.zeros_like(v[:, :, 0])
    even_h = torch.stack([v[:, :, 0], v[:, :, 2]], dim=2)
    odd_h = torch.stack([zero, v[:, :, 1]], dim=2)
    phases = []
    for ph in (even_h, odd_h):
        zw = torch.zeros_like(ph[..., 0])
        phases.append(torch.stack([ph[..., 0], ph[..., 2]], dim=3))
        phases.append(torch.stack([zw, ph[..., 1]], dim=3))
    return torch.cat(phases, dim=0)


def _depth_to_space2(y: torch.Tensor) -> torch.Tensor:
    """[n, h, w, (py, px, c)] -> [n, 2h, 2w, c]."""
    n, h, w, c4 = y.shape
    c = c4 // 4
    y = y.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w, c)


def upsample_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused resize-convolution: the exact phase decomposition of
    upsample_conv_reference — one 2x2 conv with 4*cout outputs over x
    zero-padded by one at the high side, then depth-to-space."""
    xp = F.pad(x, (0, 0, 0, 1, 0, 1))
    return _depth_to_space2(conv2d(xp, upsample_phase_kernel(w), padding="VALID"))


def deconv_upsample(x: torch.Tensor, w_iohw: torch.Tensor) -> torch.Tensor:
    """Fused stride-2 SAME transposed conv (3x3): the exact phase
    decomposition of transposed_conv2d(x, w, 2) — one 2x2 conv with 4*cout
    outputs over x zero-padded by one at the low side, then depth-to-space.
    A forward convolution: deterministic on the card, where cuDNN may run a
    transposed conv (a data gradient) with atomic, run-to-run varying sums."""
    xp = F.pad(x, (0, 0, 1, 0, 1, 0))
    return _depth_to_space2(conv2d(xp, deconv_phase_kernel(w_iohw), padding="VALID"))


def deconv_same_s1(x: torch.Tensor, w_iohw: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME transposed conv as the SAME conv with the adjoint
    kernel (flipped, in/out swapped): transposed_conv2d(x, w, 1) exactly,
    as a forward convolution."""
    return conv2d(x, w_iohw.flip(2, 3).transpose(0, 1))


# ---------------------------------------------------------------------------
# Normalization / activations
# ---------------------------------------------------------------------------


def instance_norm(
    x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """Instance norm over H, W with a per-channel affine: biased variance,
    eps inside the rsqrt, moments in float32 whatever the activation dtype."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 2), correction=0, keepdim=True)
    out = scale.float() * ((xf - mean) * torch.rsqrt(var + eps)) + shift.float()
    return out.to(x.dtype)


def scaled_tanh(x: torch.Tensor) -> torch.Tensor:
    """(255*tanh(x) + 255) / 2 -> [0, 255], computed in float32."""
    return ((255.0 * torch.tanh(x.float()) + 255.0) / 2.0).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0); torch's backward passes no gradient at x == 0, the TF/JAX
    package convention."""
    return torch.relu(x)


# ---------------------------------------------------------------------------
# Pooling (VGG)
# ---------------------------------------------------------------------------


def max_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 SAME max-pool of NHWC. On an odd extent TF pads the
    high side with -inf; ceil_mode's clipped last window is the same max."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel_size=2, stride=2, ceil_mode=True))
