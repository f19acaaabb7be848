"""Johnson-style image transformation network, instance-norm variant
(counterpart of faststyle_tpu/models/transform_net.py, naive NHWC walk).

Topology:
  reflect_pad 40
  initconv_0: 9x9  3->16 s1 SAME  | IN | relu
  initconv_1: 3x3 16->32 s2 SAME  | IN | relu
  initconv_2: 3x3 32->64 s2 SAME  | IN | relu
  resblock_0..4: [3x3 64->64 VALID | IN | relu | 3x3 VALID | IN] + crop-2 skip
  upsample_0: resize-conv (or deconv) 3x3 64->32 net-2x | IN | relu
  upsample_1: resize-conv (or deconv) 3x3 32->16 net-2x | IN | relu
  upsample_2: 9x9 16->3 s1 SAME (or its transposed form) | IN | scaled_tanh

Input NHWC, RGB in [0, 255], any H and W; output in [0, 255] with the shape
law of `output_shape`. Params are `{block: {var: tensor}}` in torch layouts
(OIHW convs, IOHW transposed convs; see `convert`) under the JAX package's
block and variable names. The JAX package's packed space-to-depth layout is
a TPU matrix-unit trick that computes the same function, so its walk is not
ported; its packed-u8 I/O contract is (`apply_packed`): the naive walk
between a device-side unpack of host-packed input and a pack of the uint8
output.
"""

from __future__ import annotations

from typing import Dict, Generator

import torch
from torch import nn

from faststyle_tpu_torch.ops import layers as L

Params = Dict[str, Dict[str, torch.Tensor]]
# a walk's generator: yields (x, scale, shift) at each instance norm, is sent
# the normalized x, returns (output, taps)
Walk = Generator[
    tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor, tuple[torch.Tensor, Dict[str, torch.Tensor]]
]

# (kernel, cin, cout, stride) per block — the instance-norm "halved" widths
_INIT_SPECS = [(9, 3, 16, 1), (3, 16, 32, 2), (3, 32, 64, 2)]
_NUM_RESBLOCKS = 5
_UP_SPECS = [(3, 64, 32), (3, 32, 16)]
_FINAL_SPEC = (9, 16, 3)

UPSAMPLE_METHODS = ("resize", "deconv")
LAYOUTS = ("nhwc", "packed_u8")
_PAD = 40  # reflect pad per side before initconv_0
_P = 4  # packed-u8 cell edge: [.., 4x4 pixels x 3 channels = 48 bytes]


def init_params(
    generator: torch.Generator,
    upsample_method: str = "resize",
    *,
    device: str | torch.device = "cuda",
) -> Params:
    """Fresh training init with the reference's distributions: conv
    W ~ N(0, 0.1^2); the upsample convs N(0, 1) (TF's random_normal default,
    kept because it defines the published recipe), and the final deconv too;
    IN scale 1, shift 0; no biases. Drawn on the CPU from `generator`, so a
    seed gives the same params on every device."""
    if upsample_method not in UPSAMPLE_METHODS:
        raise ValueError(f"upsample_method must be one of {UPSAMPLE_METHODS}")

    def norm(shape, stddev):
        return (stddev * torch.randn(shape, generator=generator)).to(device)

    def affine(cout):
        return torch.ones(cout, device=device), torch.zeros(cout, device=device)

    params: Params = {}
    for i, (k, cin, cout, _s) in enumerate(_INIT_SPECS):
        scale, shift = affine(cout)
        params[f"initconv_{i}"] = {"W": norm((cout, cin, k, k), 0.1), "INscale": scale, "INshift": shift}
    for i in range(_NUM_RESBLOCKS):
        blk = {}
        for j in ("1", "2"):
            blk["W" + j] = norm((64, 64, 3, 3), 0.1)
            blk["INscale" + j], blk["INshift" + j] = affine(64)
        params[f"resblock_{i}"] = blk
    deconv = upsample_method == "deconv"
    for i, (k, cin, cout) in enumerate(_UP_SPECS + [_FINAL_SPEC]):
        # transposed convs are IOHW, i.e. (cin, cout, k, k)
        shape = (cin, cout, k, k) if deconv else (cout, cin, k, k)
        scale, shift = affine(cout)
        std = 1.0 if (deconv or i < 2) else 0.1
        params[f"upsample_{i}"] = {"W": norm(shape, std), "INscale": scale, "INshift": shift}
    return params


def output_shape(h: int, w: int) -> tuple[int, int]:
    """The net's spatial shape law: H -> 4*ceil(ceil((H+80)/2)/2) - 80; equal
    to (h, w) whenever both divide 4, up to 3 px larger otherwise."""

    def law(x: int) -> int:
        half = -(-(x + 80) // 2)
        quarter = -(-half // 2)
        return 4 * (quarter - 20)

    return law(h), law(w)


def apply_with_features(
    params: Params,
    x: torch.Tensor,
    upsample_method: str = "resize",
    *,
    fused_upsample: bool = True,
    compute_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The naive NHWC forward, also returning the intermediate taps
    (post-IN, pre-nonlinearity): init_0..2, res_0..4, up_0..1, pre_tanh.

    `compute_dtype` casts the activations for the conv stack; IN statistics
    and the tanh stay float32. Returns the pre-clip float output: uint8 in
    gives float32 out here (apply's output_dtype does the clip).
    `fused_upsample` runs both upsample variants in their exact phase
    (sub-pixel) forms, forward convolutions only; False runs the literal
    resize-then-conv or transposed convolutions, the oracles of those."""
    if upsample_method not in UPSAMPLE_METHODS:
        raise ValueError(f"upsample_method must be one of {UPSAMPLE_METHODS}")
    orig_dtype = x.dtype
    if compute_dtype is not None or orig_dtype == torch.uint8:
        x = x.to(compute_dtype if compute_dtype is not None else torch.float32)
    y, feats = _walk_padded(params, L.reflect_pad(x, _PAD), upsample_method, fused_upsample)
    if orig_dtype != torch.uint8:
        y = y.to(orig_dtype)
    return y, feats


def _walk_steps(params: Params, h: torch.Tensor, upsample_method: str, fused_upsample: bool = True) -> Walk:
    """The walk after the reflect pad, as a generator: it yields
    (x, scale, shift) at each of the 16 instance norms, in walk order, takes
    the normalized tensor back by `send`, and returns the scaled-tanh output
    and the taps. `_walk_padded` drives it with one norm; `parallel.spatial`
    drives one per row window in lockstep, with statistics that span the
    whole frame."""
    feats: Dict[str, torch.Tensor] = {}
    for i, (_k, _ci, _co, s) in enumerate(_INIT_SPECS):
        blk = params[f"initconv_{i}"]
        h = yield L.conv2d(h, blk["W"], stride=s), blk["INscale"], blk["INshift"]
        feats[f"init_{i}"] = h
        h = L.relu(h)

    for i in range(_NUM_RESBLOCKS):
        blk = params[f"resblock_{i}"]
        r = L.conv2d(h, blk["W1"], padding="VALID")
        r = L.relu((yield r, blk["INscale1"], blk["INshift1"]))
        r = L.conv2d(r, blk["W2"], padding="VALID")
        r = yield r, blk["INscale2"], blk["INshift2"]
        h = r + h[:, 2:-2, 2:-2, :]
        feats[f"res_{i}"] = h

    for i in range(2):
        blk = params[f"upsample_{i}"]
        if upsample_method == "deconv":
            u = L.deconv_upsample(h, blk["W"]) if fused_upsample else L.transposed_conv2d(h, blk["W"], stride=2)
        elif fused_upsample:
            u = L.upsample_conv(h, blk["W"])
        else:
            u = L.upsample_conv_reference(h, blk["W"])
        u = yield u, blk["INscale"], blk["INshift"]
        feats[f"up_{i}"] = u
        h = L.relu(u)

    blk = params["upsample_2"]
    if upsample_method == "deconv":
        h = L.deconv_same_s1(h, blk["W"]) if fused_upsample else L.transposed_conv2d(h, blk["W"], stride=1)
    else:
        h = L.conv2d(h, blk["W"])
    h = yield h, blk["INscale"], blk["INshift"]
    feats["pre_tanh"] = h
    return L.scaled_tanh(h), feats


def _walk_padded(
    params: Params, h: torch.Tensor, upsample_method: str, fused_upsample: bool = True
) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The walk after the reflect pad: the net on an already padded NHWC
    tensor in its compute dtype; returns the scaled-tanh output and taps."""
    steps = _walk_steps(params, h, upsample_method, fused_upsample)
    try:
        x = next(steps)
        while True:
            x = steps.send(L.instance_norm(*x))
    except StopIteration as done:
        return done.value


def apply(
    params: Params,
    x: torch.Tensor,
    upsample_method: str = "resize",
    *,
    fused_upsample: bool = True,
    compute_dtype: torch.dtype | None = None,
    output_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Forward pass: NHWC RGB [0, 255] -> [0, 255]. `output_dtype=uint8`
    clips and casts on the device; uint8 input defaults to uint8 output,
    float input to the same float."""
    if output_dtype not in (None, torch.uint8):
        raise ValueError(f"output_dtype must be None or torch.uint8, got {output_dtype}")
    if output_dtype is None and x.dtype == torch.uint8:
        output_dtype = torch.uint8
    y, _ = apply_with_features(
        params, x, upsample_method, fused_upsample=fused_upsample, compute_dtype=compute_dtype
    )
    if output_dtype == torch.uint8:
        return y.clamp(0, 255).to(torch.uint8)
    return y


def unpack_u8(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[N, Hb, Wb, 48] packed uint8 -> [N, height, width, 3], cropping the
    grid's tails: src[by, bx, (dy*4+dx)*3+ch] == dst[4by+dy, 4bx+dx, ch].
    A view and a permute; the crop leaves it strided."""
    n, hb, wb, cc = x.shape
    if cc != _P * _P * 3 or height > hb * _P or width > wb * _P:
        raise ValueError(f"packed shape {tuple(x.shape)} cannot hold {height}x{width} RGB")
    full = x.reshape(n, hb, wb, _P, _P, 3).permute(0, 1, 3, 2, 4, 5).reshape(n, hb * _P, wb * _P, 3)
    return full[:, :height, :width]


def pack_u8(y: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, ceil(H/4), ceil(W/4), 48], zero tails: the
    inverse of unpack_u8, contiguous."""
    n, h, w, c = y.shape
    hb, wb = -(-h // _P), -(-w // _P)
    if (hb * _P, wb * _P) != (h, w):
        y = torch.nn.functional.pad(y, (0, 0, 0, wb * _P - w, 0, hb * _P - h))
    return y.reshape(n, hb, _P, wb, _P, c).permute(0, 1, 3, 2, 4, 5).reshape(n, hb, wb, _P * _P * c)


def apply_packed(
    params: Params,
    x: torch.Tensor,
    *,
    compute_dtype: torch.dtype | None = None,
    output_dtype: torch.dtype | None = None,
    output_layout: str = "nhwc",
    input_layout: str = "nhwc",
    input_hw: tuple[int, int] | None = None,
    upsample_method: str = "resize",
) -> torch.Tensor:
    """The forward with packed-u8 I/O (the JAX `apply_packed`'s tensors,
    not its TPU layout walk).

    input_layout='packed_u8': x is [N, ceil((h+80)/4), ceil((w+80)/4), 48]
    uint8, already reflect-padded by 40 and packed on the host
    (`inference.pack_u8_host`); `input_hw` = (h, w) is the image's extent.
    output_layout='packed_u8' (implies uint8 output): the clipped uint8
    output [N, OH, OW, 3] packed to [N, ceil(OH/4), ceil(OW/4), 48] with
    zero tails, (OH, OW) = output_shape(h, w).

    Between the two, the naive walk of `apply` on the same values in the
    same layout: the unpacked input is made contiguous in the compute dtype
    before the first conv, as `apply`'s reflect pad leaves it, so the result
    is bit-exact with `apply` on the unpacked uint8 frames."""
    if input_layout not in LAYOUTS or output_layout not in LAYOUTS:
        raise ValueError(f"layouts must be in {LAYOUTS}, got {input_layout!r} -> {output_layout!r}")
    if upsample_method not in UPSAMPLE_METHODS:
        raise ValueError(f"upsample_method must be one of {UPSAMPLE_METHODS}")
    if output_dtype not in (None, torch.uint8):
        raise ValueError(f"output_dtype must be None or torch.uint8, got {output_dtype}")
    if output_layout == "packed_u8" and output_dtype is None and x.dtype != torch.uint8:
        raise ValueError("packed_u8 output implies uint8 output")
    if input_layout == "nhwc":
        y = apply(params, x, upsample_method, compute_dtype=compute_dtype, output_dtype=output_dtype)
    else:  # uint8 in, so uint8 out
        if x.dtype != torch.uint8 or input_hw is None:
            raise ValueError("packed_u8 input is uint8 and needs input_hw=(h, w)")
        h, w = input_hw
        dtype = compute_dtype if compute_dtype is not None else torch.float32
        padded = unpack_u8(x, h + 2 * _PAD, w + 2 * _PAD).to(dtype).contiguous()
        y = _walk_padded(params, padded, upsample_method)[0].clamp(0, 255).to(torch.uint8)
    return pack_u8(y) if output_layout == "packed_u8" else y


class TransformNet(nn.Module):
    """The net as a module: one ParameterDict per block, so optimizers and
    state dicts see `blocks.<block>.<var>`; `params()` gives the nested
    dict that `apply` takes."""

    def __init__(self, params: Params, upsample_method: str = "resize"):
        super().__init__()
        if upsample_method not in UPSAMPLE_METHODS:
            raise ValueError(f"upsample_method must be one of {UPSAMPLE_METHODS}")
        self.upsample_method = upsample_method
        self.blocks = nn.ModuleDict(
            {
                blk: nn.ParameterDict({var: nn.Parameter(t.detach().clone()) for var, t in sub.items()})
                for blk, sub in params.items()
            }
        )

    def params(self) -> Params:
        return {blk: dict(sub.items()) for blk, sub in self.blocks.items()}

    def forward(
        self,
        x: torch.Tensor,
        *,
        compute_dtype: torch.dtype | None = None,
        output_dtype: torch.dtype | None = None,
    ) -> torch.Tensor:
        return apply(
            self.params(), x, self.upsample_method,
            compute_dtype=compute_dtype, output_dtype=output_dtype,
        )
