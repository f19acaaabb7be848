"""VGG16's convolutional tower (Simonyan and Zisserman 2014), plainly:
ImageNet mean subtracted from 0-255 RGB, groups of 3x3 SAME convs with
bias and relu, a 2x2 stride-2 SAME max-pool after each group (an odd
extent padded at the high side)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import round_to


def features(params: dict, x, vgg: dict, layers, precision: str = "float32") -> dict:
    """{layer: NCHW activation} for `layers` of [N, 3, H, W] RGB in [0, 255];
    stops after the deepest one."""
    wanted = set(layers)
    mean = torch.tensor(vgg["mean_rgb"], dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    h = x - mean
    acts = {}
    for gi, (_co, depth) in enumerate(vgg["groups"], start=1):
        for j in range(1, depth + 1):
            name = f"conv{gi}_{j}"
            p = params[name]
            h = torch.relu(F.conv2d(round_to(h, precision), round_to(p["W"], precision), p["b"], padding=1))
            if name in wanted:
                acts[name] = h
                if len(acts) == len(wanted):
                    return acts
        h = F.max_pool2d(h, kernel_size=2, stride=2, ceil_mode=True)
    raise ValueError(f"layers {sorted(wanted - set(acts))} are not in VGG16")
