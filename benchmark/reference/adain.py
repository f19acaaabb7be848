"""AdaIN, plainly (Huang and Belongie 2017, as naoto0804/pytorch-AdaIN's
`net.py` and `function.py` write it): the benchmark's own copy of the port's
plain reference, with the control's lower precisions and the seeded weights.

NCHW float32, TF32 off. The encoder is `vgg_normalised` to relu4_1 (a 1x1
conv, then 3x3 convs after a ReflectionPad2d(1), each with relu, and 2x2
ceil-mode max-pools); AdaIN moves the content's per-channel mean and
sigma (sqrt of the unbiased variance + 1e-5, `calc_mean_std`) to the
style's; the decoder mirrors the encoder with nearest 2x upsamples and no
relu after its last conv. Content and style are RGB in [0, 1] (uint8 /
255); the output is written as `save_image` does (x 255, + 0.5, clamped,
truncated) and cropped to the content's extent. Weights: `{block: {"W":
OIHW, "b": [co]}}`, drawn here from the configuration's seed (the published
files are not in the repository). Departures from the published code: none
in the operations.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import round_to

VGG = ("conv0", "conv1_1", "conv1_2", "pool", "conv2_1", "conv2_2", "pool", "conv3_1", "conv3_2", "conv3_3",
       "conv3_4", "pool", "conv4_1")
DECODER = ("dec4_1", "up", "dec3_4", "dec3_3", "dec3_2", "dec3_1", "up", "dec2_2", "dec2_1", "up", "dec1_2", "dec1_1")


def init_params(config: dict) -> dict:
    """The configuration's seeded weights on the CPU: each conv of `model`'s
    encoder and decoder He-normal (std sqrt(2 / fan_in)) with a zero bias,
    drawn in order from one generator seeded with `weights_seed`; conv0 as
    published (RGB -> BGR x 255, the negated ImageNet BGR mean as bias); the
    last conv's weights times `last_conv_scale`, its bias `last_conv_bias`."""
    model = config["model"]
    gen = torch.Generator().manual_seed(int(config["weights_seed"]))
    params = {}
    for name, k, ci, co in model["encoder"] + model["decoder"]:
        w = torch.randn((co, ci, k, k), generator=gen) * math.sqrt(2.0 / (ci * k * k))
        params[name] = {"W": w, "b": torch.zeros(co)}
    w0 = torch.zeros(3, 3, 1, 1)
    for i in range(3):
        w0[2 - i, i] = 255.0
    params["conv0"] = {"W": w0, "b": -torch.tensor(model["mean_bgr"], dtype=torch.float32)}
    last = params[model["decoder"][-1][0]]
    last["W"] = last["W"] * float(config["last_conv_scale"])
    last["b"] = torch.tensor(config["last_conv_bias"], dtype=torch.float32)
    return params


def to_device(params: dict, device) -> dict:
    return {blk: {v: t.to(device) for v, t in sub.items()} for blk, sub in params.items()}


def _full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _conv(params: dict, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    w, b = params[name]["W"].float(), params[name]["b"].float()
    if w.shape[-1] == 3:
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(round_to(x, precision), round_to(w, precision), b)


def vgg(params: dict, x: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """[N, 3, H, W] RGB in [0, 1] -> relu4_1."""
    _full_float32()
    h = x.float()
    for name in VGG:
        if name == "pool":
            h = F.max_pool2d(h, (2, 2), (2, 2), (0, 0), ceil_mode=True)
        else:
            h = _conv(params, name, h, precision)
            if name != "conv0":
                h = torch.relu(h)
    return h


def decoder(params: dict, t: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    _full_float32()
    h = t.float()
    for name in DECODER:
        if name == "up":
            h = F.interpolate(h, scale_factor=2, mode="nearest")
        else:
            h = _conv(params, name, h, precision)
            if name != DECODER[-1]:
                h = torch.relu(h)
    return h


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5, stats_precision: str = "float32"):
    """function.py's (mean, sqrt(var + eps)), each [N, C, 1, 1], the
    unbiased variance; for "bfloat16" statistics (a control), the moments
    of the bf16 features, returned as bf16 gives them."""
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    if stats_precision == "bfloat16":
        flat = flat.to(torch.bfloat16)
    elif stats_precision != "float32":
        raise ValueError(f"unknown statistics precision {stats_precision!r}")
    feat_var = flat.var(dim=2).float() + eps
    return flat.mean(dim=2).float().view(n, c, 1, 1), feat_var.sqrt().view(n, c, 1, 1)


def adaptive_instance_normalization(content_feat, style_mean, style_std, stats_precision: str = "float32"):
    size = content_feat.size()
    content_mean, content_std = calc_mean_std(content_feat, stats_precision=stats_precision)
    normalized = (content_feat - content_mean.expand(size)) / content_std.expand(size)
    return normalized * style_std.expand(size) + style_mean.expand(size)


def nchw01(img: np.ndarray, device) -> torch.Tensor:
    """[H, W, 3] uint8 RGB -> [1, 3, H, W] float32 in [0, 1]."""
    return torch.from_numpy(np.ascontiguousarray(img)).to(device).permute(2, 0, 1)[None].float() / 255.0


def style_moments(params: dict, style: np.ndarray, device, precision: str = "float32",
                  stats_precision: str = "float32"):
    """A [h, w, 3] uint8 style image -> its (mean, sigma) at relu4_1."""
    with torch.no_grad():
        return calc_mean_std(vgg(params, nchw01(style, device), precision), stats_precision=stats_precision)


def stylize_u8(params: dict, frame: np.ndarray, moments, device, precision: str = "float32",
               stats_precision: str = "float32") -> np.ndarray:
    """One [H, W, 3] uint8 RGB frame in the style of `moments` (from
    `style_moments`) -> [H, W, 3] uint8. `precision` rounds every conv's
    operands and `stats_precision` sets the moments, for the control."""
    h, w = frame.shape[:2]
    with torch.no_grad():
        feats = adaptive_instance_normalization(vgg(params, nchw01(frame, device), precision), *moments,
                                                stats_precision)
        y = decoder(params, feats, precision)[0, :, :h, :w]
        return y.mul(255).add_(0.5).clamp_(0, 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
