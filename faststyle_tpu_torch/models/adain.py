"""Arbitrary style transfer with adaptive instance normalization (Huang and
Belongie, ICCV 2017, arXiv:1703.06868), as naoto0804/pytorch-AdaIN's
`net.py` and `function.py` write it, in the port's NHWC walk.

Topology (every 3x3 conv after a ReflectionPad2d(1), with a bias):
  encoder, `vgg_normalised` to relu4_1:
    conv0 1x1 3->3 (RGB in [0, 1] -> BGR x 255 less the ImageNet mean)
    conv1_1 3->64 | relu, conv1_2 64->64 | relu, 2x2/s2 max-pool (ceil)
    conv2_1 64->128 | relu, conv2_2 128->128 | relu, max-pool
    conv3_1 128->256 | relu, conv3_2..3_4 256->256 | relu, max-pool
    conv4_1 256->512 | relu                                  (relu4_1)
  AdaIN: t = sigma(s) * (c - mu(c)) / sigma(c) + mu(s), per-channel moments
    over H and W, sigma = sqrt(unbiased variance + 1e-5) (`calc_mean_std`)
  decoder:
    dec4_1 512->256 | relu, nearest 2x
    dec3_4, dec3_3, dec3_2 256->256 | relu, dec3_1 256->128 | relu, 2x
    dec2_2 128->128 | relu, dec2_1 128->64 | relu, 2x
    dec1_2 64->64 | relu, dec1_1 64->3               (output in [0, 1])

The port's contract is the transform net's: NHWC RGB in [0, 255] in, [0,
255] out (uint8: the decoder's output x 255, + 0.5, clamped and truncated,
as `test.py`'s `save_image` writes it), any H and W, output extent
`output_shape` (8 * ceil(ceil(ceil(H / 2) / 2) / 2)). The walk folds the
1/255 of the [0, 1] input into conv0, and runs each reflect-padded 3x3
conv as `layers.conv3x3_reflect` (a zero-padded conv whose border is
recomputed from strips: no padded copy), its bias and relu in cuDNN's
epilogue on the card; pools and upsamples are plain torch.

A style is its float32 (mean, sigma) at relu4_1 (`encode_style`, the same
encoder in the same dtype). The content's AdaIN runs as the instance-norm
kernel pair wherever they engage (`instance_norm.engages`: on the card,
autograd recording nothing), the style's sigma and mean as scale and shift,
inside an `adain.norm` span; elsewhere as `layers.instance_norm` with the
unbiased variance. `compute_dtype` runs the convs in bf16; the moments are
float32 always.

Params: `{block: {"W": OIHW, "b": [co]}}` under the names of ENCODER and
DECODER. The published `vgg_normalised.pth` and `decoder.pth` are not in the
repository: `init_params` draws seeded weights of the same shapes.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from faststyle_tpu_torch.models import transform_net
from faststyle_tpu_torch.ops import layers as L
from faststyle_tpu_torch.ops.cuda import instance_norm as IN
from faststyle_tpu_torch.utils import profiling

Params = Dict[str, Dict[str, torch.Tensor]]

POOL, UP = "pool", "up"
# (block, kernel, cin, cout), POOL: vgg_normalised to relu4_1
ENCODER = (
    ("conv0", 1, 3, 3),
    ("conv1_1", 3, 3, 64), ("conv1_2", 3, 64, 64), POOL,
    ("conv2_1", 3, 64, 128), ("conv2_2", 3, 128, 128), POOL,
    ("conv3_1", 3, 128, 256), ("conv3_2", 3, 256, 256), ("conv3_3", 3, 256, 256), ("conv3_4", 3, 256, 256), POOL,
    ("conv4_1", 3, 256, 512),
)
# (block, kernel, cin, cout), UP: the mirrored decoder
DECODER = (
    ("dec4_1", 3, 512, 256), UP,
    ("dec3_4", 3, 256, 256), ("dec3_3", 3, 256, 256), ("dec3_2", 3, 256, 256), ("dec3_1", 3, 256, 128), UP,
    ("dec2_2", 3, 128, 128), ("dec2_1", 3, 128, 64), UP,
    ("dec1_2", 3, 64, 64), ("dec1_1", 3, 64, 3),
)
CONVS = tuple(s for s in ENCODER + DECODER if s not in (POOL, UP))
EPS = 1e-5  # calc_mean_std's
CORRECTION = 1  # torch.var's default: the unbiased variance
MEAN_BGR = (103.939, 116.779, 123.68)  # vgg_normalised's conv0 bias, negated
STYLE_SIZE = 512  # test.py's style_size: the style image's shorter side
# the last conv's weights scaled and its bias set so that the weights of
# seed WEIGHTS_SEED give frames in [0, 1] with few clipped pixels over
# video-like frames and styles (under 0.5% at 270x480, styles of 512 px)
WEIGHTS_SEED = 1703
LAST_SCALE = 0.004
LAST_BIAS = (0.63, 0.21, 0.565)
PAD = 0  # packed-u8 input carries no border: every pad is inside the walk


class Style(NamedTuple):
    """An encoded style: float32 [c] mean and sigma at relu4_1, on the
    content's device. `id` names it in the `adain.style` span."""

    id: int
    mean: torch.Tensor
    std: torch.Tensor


def is_adain(params) -> bool:
    """Whether `params` holds this model's blocks (a transform net's has
    `initconv_0` and none of these)."""
    return all(name in params for name, *_ in CONVS)


def init_params(generator: torch.Generator, *, device: str | torch.device = "cuda") -> Params:
    """Seeded weights of the published shapes, drawn on the CPU from
    `generator`, so a seed gives the same weights on every device: each
    conv He-normal (std sqrt(2 / fan_in)) with zero biases; conv0 as
    published, RGB -> BGR x 255 with the negated ImageNet BGR mean as its
    bias; the last conv's weights times LAST_SCALE, its bias LAST_BIAS."""
    params: Params = {}
    for name, k, ci, co in CONVS:
        w = torch.randn((co, ci, k, k), generator=generator) * math.sqrt(2.0 / (ci * k * k))
        params[name] = {"W": w, "b": torch.zeros(co)}
    w0 = torch.zeros(3, 3, 1, 1)
    for i in range(3):
        w0[2 - i, i] = 255.0
    params["conv0"] = {"W": w0, "b": -torch.tensor(MEAN_BGR)}
    last = params[DECODER[-1][0]]
    last["W"] = last["W"] * LAST_SCALE
    last["b"] = torch.tensor(LAST_BIAS, dtype=torch.float32)
    return {blk: {v: t.to(device) for v, t in sub.items()} for blk, sub in params.items()}


def output_shape(h: int, w: int) -> tuple[int, int]:
    """The decoder's extent for an h x w input: three ceil-mode pools, three
    2x upsamples; (h, w) whenever 8 divides both."""

    def law(x: int) -> int:
        for _ in range(3):
            x = -(-x // 2)
        return 8 * x

    return law(h), law(w)


class Prepared(dict):
    """Params as the walk reads them in one compute dtype (`prepare`)."""

    dtype: torch.dtype


def prepare(params: Params, compute_dtype: Optional[torch.dtype] = None) -> Prepared:
    """The params in the compute dtype (float32 when None), each conv's
    weights channels_last as cuDNN takes them and conv0's with the input's
    1/255 folded in (computed in float32), so that a forward casts and
    relayouts no weight. Prepared params for the same dtype come back as
    they are: a Stylizer prepares once."""
    dtype = compute_dtype or torch.float32
    if isinstance(params, Prepared) and params.dtype == dtype:
        return params
    out = Prepared()
    out.dtype = dtype
    for name, sub in params.items():
        w = sub["W"].float() / 255.0 if name == "conv0" else sub["W"]
        out[name] = {"W": w.to(dtype, memory_format=torch.channels_last), "b": sub["b"].to(dtype)}
    return out


def _conv(params: Prepared, name: str, h: torch.Tensor, relu: bool) -> torch.Tensor:
    blk = params[name]
    return L.conv3x3_reflect(h, blk["W"], blk["b"], relu)


def encode(params: Params, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC RGB [0, 255] -> relu4_1 features, NHWC in the compute dtype
    (float32 when None). conv0 takes x / 255 as published: the 1/255 is in
    its prepared weights."""
    p = prepare(params, compute_dtype)
    h = L.conv2d(x.to(p.dtype).contiguous(), p["conv0"]["W"], padding="VALID", bias=p["conv0"]["b"])
    for step in ENCODER[1:]:
        h = L.max_pool_2x2_same(h) if step == POOL else _conv(p, step[0], h, relu=True)
    return h


def decode(params: Params, t: torch.Tensor) -> torch.Tensor:
    """AdaIN's output -> the decoder's output, nominally [0, 1], NHWC in t's
    dtype."""
    p = prepare(params, t.dtype)
    h = t
    for step in DECODER:
        h = L.resize_nearest(h, 2) if step == UP else _conv(p, step[0], h, relu=step != DECODER[-1])
    return h


def moments(feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`calc_mean_std` in float32: per image and channel, (mean, sqrt(var +
    1e-5)) over H and W with the unbiased variance, each [n, c]."""
    var, mean = torch.var_mean(feats.float(), dim=(1, 2), correction=CORRECTION)
    return mean, torch.sqrt(var + EPS)


def encode_style(
    params: Params, image: torch.Tensor, compute_dtype: Optional[torch.dtype] = None, style_id: int = 0
) -> Style:
    """A style image, [1, h, w, 3] or [h, w, 3] RGB in [0, 255], -> its
    Style, inside an `adain.style` span with `style_id` as id."""
    if image.dim() == 3:
        image = image[None]
    if image.shape[0] != 1:
        raise ValueError(f"encode_style takes one style image, got {tuple(image.shape)}")
    with profiling.span("adain.style", style_id):
        mean, std = moments(encode(params, image, compute_dtype))
    return Style(style_id, mean[0], std[0])


def adain(feats: torch.Tensor, style: Style) -> torch.Tensor:
    """The content's AdaIN: the kernels where they engage (one `adain.norm`
    span), else plain torch; feats' dtype."""
    if IN.engages(feats, style.std, style.mean) and IN.fits(feats.shape[-1], feats.dtype):
        with profiling.span("adain.norm"):
            return IN.instance_norm_epilogue(feats, style.std, style.mean, "none", eps=EPS, correction=CORRECTION)
    return L.instance_norm(feats, style.std, style.mean, EPS, correction=CORRECTION)


def to_u8(y: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8 as `save_image` writes it: x 255, + 0.5, clamped,
    truncated."""
    return (y.float() * 255.0 + 0.5).clamp_(0, 255).to(torch.uint8)


def apply(
    params: Params,
    x: torch.Tensor,
    style: Style,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    output_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """NHWC RGB [0, 255] -> the stylized frame in [0, 255], output_shape's
    extent: uint8 with `output_dtype=uint8` or uint8 input, else float32
    (the decoder's output x 255, unclamped)."""
    if output_dtype not in (None, torch.uint8):
        raise ValueError(f"output_dtype must be None or torch.uint8, got {output_dtype}")
    y = decode(params, adain(encode(params, x, compute_dtype), style))
    if output_dtype == torch.uint8 or x.dtype == torch.uint8:
        return to_u8(y)
    return y.float() * 255.0


def apply_packed(
    params: Params,
    x: torch.Tensor,
    style: Style,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    output_layout: str = "nhwc",
    input_layout: str = "nhwc",
    input_hw: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """The forward with packed-u8 I/O, as `transform_net.apply_packed` has
    it but with no border: input_layout='packed_u8' takes [N, ceil(h/4),
    ceil(w/4), 48] uint8 from `inference.pack_u8_host(frames, pad=0)` with
    `input_hw` = (h, w); output_layout='packed_u8' packs the uint8 output,
    output_shape(h, w), to [N, ceil(OH/4), ceil(OW/4), 48] with zero tails."""
    layouts = transform_net.LAYOUTS
    if input_layout not in layouts or output_layout not in layouts:
        raise ValueError(f"layouts must be in {layouts}, got {input_layout!r} -> {output_layout!r}")
    if input_layout == "packed_u8":
        if x.dtype != torch.uint8 or input_hw is None:
            raise ValueError("packed_u8 input is uint8 and needs input_hw=(h, w)")
        x = transform_net.unpack_u8(x, *input_hw)
    out_u8 = output_layout == "packed_u8" or x.dtype == torch.uint8
    y = apply(params, x, style, compute_dtype=compute_dtype, output_dtype=torch.uint8 if out_u8 else None)
    return transform_net.pack_u8(y) if output_layout == "packed_u8" else y
