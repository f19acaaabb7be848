"""The image transform network, plainly (Johnson et al. 2016 with instance
norm, as ghwatson/faststyle's im_transf_net.py writes it).

NCHW float32 throughout. The sizes come from the configuration's `model`:
  reflect pad; per `init` spec a k x k SAME conv (TF's split of the pad,
  the low side taking total // 2) | instance norm | relu; `resblocks`
  residual blocks [3x3 VALID | IN | relu | 3x3 VALID | IN] + the input
  cropped by 2; per `upsample` spec nearest-neighbour resize by 4 then a
  3x3 stride-2 SAME conv (a net 2x) | IN | relu; the `final` 9x9 SAME conv
  | IN | scaled tanh, (255 tanh(x) + 255) / 2. Instance norm: biased
  moments over H and W, eps inside the rsqrt, a per-channel scale and shift.
Weights: the files' HWIO kernels under '<block>/<var>' keys.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import round_to

Params = dict  # {block: {var: tensor}}, conv kernels OIHW


def load_npz(path, device) -> Params:
    """The '<block>/<var>' npz as OIHW float32 tensors on `device`."""
    params: Params = {}
    with np.load(path) as flat:
        for key in flat.files:
            blk, var = key.split("/")
            arr = torch.from_numpy(flat[key].astype(np.float32))
            if arr.ndim == 4:
                arr = arr.permute(3, 2, 0, 1)  # HWIO -> OIHW
            params.setdefault(blk, {})[var] = arr.contiguous().to(device)
    return params


def conv_same(x, w, stride: int, precision: str = "float32"):
    """TF's SAME convolution: the pad split with the low side total // 2."""
    k_h, k_w = w.shape[2:]
    pads = []
    for n, k in ((x.shape[3], k_w), (x.shape[2], k_h)):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(round_to(x, precision), pads), round_to(w, precision), stride=stride)


def conv_valid(x, w, precision: str = "float32"):
    return F.conv2d(round_to(x, precision), round_to(w, precision))


def instance_norm(x, scale, shift, eps: float, stats_precision: str = "float32"):
    """For "bfloat16" statistics (a control), the moments of the bfloat16
    activations, returned as bfloat16 (as `var_mean` of a bfloat16 tensor
    gives them); the normalisation itself in float32."""
    if stats_precision == "float32":
        var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    elif stats_precision == "bfloat16":
        var, mean = (m.float() for m in torch.var_mean(x.to(torch.bfloat16), dim=(2, 3), correction=0, keepdim=True))
    else:
        raise ValueError(f"unknown statistics precision {stats_precision!r}")
    return scale.view(1, -1, 1, 1) * (x - mean) * torch.rsqrt(var + eps) + shift.view(1, -1, 1, 1)


def forward(params: Params, x, model: dict, precision: str = "float32", stats_precision: str = "float32"):
    """[N, 3, H, W] RGB in [0, 255] -> [N, 3, OH, OW] float32 in [0, 255];
    `precision` rounds the convolutions' operands, `stats_precision` sets
    instance norm's moments."""
    if model["upsample_method"] != "resize":
        raise ValueError("the reference is written for resize-convolution upsampling")
    eps = model["instance_norm_eps"]
    pad = model["reflect_pad"]

    def norm(h, blk, j=""):
        return instance_norm(h, blk["INscale" + j], blk["INshift" + j], eps, stats_precision)

    h = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    for i, (_k, _ci, _co, s) in enumerate(model["init"]):
        blk = params[f"initconv_{i}"]
        h = torch.relu(norm(conv_same(h, blk["W"], s, precision), blk))
    for i in range(model["resblocks"]):
        blk = params[f"resblock_{i}"]
        r = torch.relu(norm(conv_valid(h, blk["W1"], precision), blk, "1"))
        r = norm(conv_valid(r, blk["W2"], precision), blk, "2")
        h = r + h[:, :, 2:-2, 2:-2]
    for i in range(len(model["upsample"])):
        blk = params[f"upsample_{i}"]
        u = F.interpolate(h, scale_factor=4, mode="nearest")
        h = torch.relu(norm(conv_same(u, blk["W"], 2, precision), blk))
    blk = params[f"upsample_{len(model['upsample'])}"]
    h = norm(conv_same(h, blk["W"], 1, precision), blk)
    return (255.0 * torch.tanh(h) + 255.0) / 2.0


def stylize_u8(params: Params, frame: np.ndarray, model: dict, device, precision: str = "float32",
               stats_precision: str = "float32") -> np.ndarray:
    """One HxWx3 uint8 RGB frame -> the stylized HxWx3 uint8 frame: the
    net's output cropped to the input's extent, clipped and truncated."""
    h, w = frame.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(frame)).to(device).permute(2, 0, 1)[None].float()
    with torch.no_grad():
        y = forward(params, x, model, precision, stats_precision)[0, :, :h, :w]
        return y.clamp(0, 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()
