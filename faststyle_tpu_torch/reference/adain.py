"""AdaIN, plainly: naoto0804/pytorch-AdaIN's `net.py` (`vgg` to relu4_1 and
`decoder`) and `function.py` (`calc_mean_std`,
`adaptive_instance_normalization`) as float32 operations in NCHW, with
`test.py`'s alpha of 1 and `save_image`'s rounding. TF32 off.

It imports nothing of the port: the weights are handed in as `{block:
{"W": OIHW, "b": [co]}}` under the published layers' names (conv0,
conv1_1 .. conv4_1; dec4_1 .. dec1_1). Departures from the published code:
none in the operations; the weights are seeded, not the published files.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# vgg_normalised to relu4_1 and the decoder: block names, "pool", "up"
VGG = ("conv0", "conv1_1", "conv1_2", "pool", "conv2_1", "conv2_2", "pool", "conv3_1", "conv3_2", "conv3_3",
       "conv3_4", "pool", "conv4_1")
DECODER = ("dec4_1", "up", "dec3_4", "dec3_3", "dec3_2", "dec3_1", "up", "dec2_2", "dec2_1", "up", "dec1_2", "dec1_1")


def _full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _conv(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    w, b = params[name]["W"].float(), params[name]["b"].float()
    if w.shape[-1] == 3:
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")  # nn.ReflectionPad2d((1, 1, 1, 1))
    return F.conv2d(x, w, b)


def vgg(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] RGB in [0, 1] -> relu4_1, [N, 512, H/8, W/8] (ceil)."""
    _full_float32()
    h = x.float()
    for name in VGG:
        if name == "pool":
            h = F.max_pool2d(h, (2, 2), (2, 2), (0, 0), ceil_mode=True)
        else:
            h = _conv(params, name, h)
            if name != "conv0":
                h = torch.relu(h)
    return h


def decoder(params: dict, t: torch.Tensor) -> torch.Tensor:
    """relu4_1-shaped features -> [N, 3, 8 * ., 8 * .], nominally [0, 1]."""
    _full_float32()
    h = t.float()
    for name in DECODER:
        if name == "up":
            h = F.interpolate(h, scale_factor=2, mode="nearest")
        else:
            h = _conv(params, name, h)
            if name != DECODER[-1]:
                h = torch.relu(h)
    return h


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """function.py's: per image and channel, the mean and sqrt(var + eps),
    torch.var's unbiased variance; each [N, C, 1, 1]."""
    n, c = feat.shape[:2]
    feat_var = feat.view(n, c, -1).var(dim=2) + eps
    feat_std = feat_var.sqrt().view(n, c, 1, 1)
    feat_mean = feat.view(n, c, -1).mean(dim=2).view(n, c, 1, 1)
    return feat_mean, feat_std


def adaptive_instance_normalization(content_feat: torch.Tensor, style_feat: torch.Tensor) -> torch.Tensor:
    size = content_feat.size()
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    normalized_feat = (content_feat - content_mean.expand(size)) / content_std.expand(size)
    return normalized_feat * style_std.expand(size) + style_mean.expand(size)


def style_transfer(params: dict, content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """test.py's style_transfer at alpha 1: [N, 3, H, W] and [1, 3, h, w]
    in [0, 1] -> the decoder's output."""
    return decoder(params, adaptive_instance_normalization(vgg(params, content), vgg(params, style)))


def save_image_u8(y: torch.Tensor) -> torch.Tensor:
    """save_image's rounding: x 255, + 0.5, clamped to [0, 255], uint8."""
    return y.mul(255).add_(0.5).clamp_(0, 255).to(torch.uint8)


def _nchw01(img: np.ndarray, device) -> torch.Tensor:
    """[H, W, 3] uint8 RGB -> [1, 3, H, W] float32 in [0, 1] (ToTensor)."""
    return torch.from_numpy(np.ascontiguousarray(img)).to(device).permute(2, 0, 1)[None].float() / 255.0


def stylize_u8(params: dict, frame: np.ndarray, style: np.ndarray, device="cuda") -> np.ndarray:
    """One [H, W, 3] uint8 RGB content frame in the style of a [h, w, 3]
    uint8 RGB image -> [H, W, 3] uint8, the output cropped to the frame."""
    h, w = frame.shape[:2]
    with torch.no_grad():
        y = style_transfer(params, _nchw01(frame, device), _nchw01(style, device))[0, :, :h, :w]
        return save_image_u8(y).permute(1, 2, 0).cpu().numpy()
