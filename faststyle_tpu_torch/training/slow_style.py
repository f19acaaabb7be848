"""Style and content targets of the perceptual losses (counterpart of the
target half of faststyle_tpu/training/slow_style.py; the Gatys pixel
optimization itself is a later slice)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from faststyle_tpu_torch import losses
from faststyle_tpu_torch.models import vgg16


def _image(img: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(img, dtype=torch.float32, device=device)


def style_target_grams(
    vgg_params: vgg16.Params, style_img: np.ndarray | torch.Tensor, style_layers: tuple[str, ...]
) -> Dict[str, torch.Tensor]:
    """The style image's normalized Gram matrices, one [1,c,c] per layer,
    computed once on the VGG params' device."""
    device = vgg_params["conv1_1"]["W"].device
    with torch.no_grad():
        acts = vgg16.apply(vgg_params, _image(style_img, device), style_layers)
        return {name: losses.gram_matrix(acts[name]) for name in style_layers}


def content_targets(
    vgg_params: vgg16.Params, content_img: np.ndarray | torch.Tensor, content_layers: tuple[str, ...]
) -> Dict[str, torch.Tensor]:
    device = vgg_params["conv1_1"]["W"].device
    with torch.no_grad():
        return vgg16.apply(vgg_params, _image(content_img, device), content_layers)
