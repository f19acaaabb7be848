"""Perceptual losses: content, Gram-matrix style, total variation
(counterpart of faststyle_tpu/losses.py, the same math):

  gram(F[b,h,w,c])   = F'^T F' / (h*w*c), F' = reshape(F, [b, h*w, c])
  content_loss       = sum_i w_i * sum((A_i - T_i)^2) / (h_i*w_i*c_i)
                       — not normalized by batch
  style_loss         = sum_i w_i * sum((G_i - G*_i)^2) / (c_i*c_i)
                       — a one-image target Gram broadcasts over the batch
  tv_loss            = sum(hdiff^2) + sum(vdiff^2), unnormalized
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from faststyle_tpu_torch.ops.cuda import gram as gram_op


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """[b,h,w,c] -> [b,c,c] normalized Gram in float32. Every CUDA tensor
    goes through the CUDA kernel; a CPU tensor through its plain version."""
    return gram_op.gram_matrix(feats)


def content_loss(
    layers: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    weights: Mapping[str, float],
) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=_device(layers, targets))
    for name, weight in weights.items():
        act, tgt = layers[name].float(), targets[name].float()
        _, h, w, c = act.shape
        total = total + weight * torch.sum(torch.square(act - tgt)) / float(h * w * c)
    return total


def style_loss(
    grams: Mapping[str, torch.Tensor],
    target_grams: Mapping[str, torch.Tensor],
    weights: Mapping[str, float],
) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=_device(grams, target_grams))
    for name, weight in weights.items():
        g = grams[name].float()
        t = target_grams[name].float()  # [1,c,c] broadcasts over the batch
        c = g.shape[-1]
        total = total + weight * torch.sum(torch.square(g - t)) / float(c * c)
    return total


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized total variation: squared adjacent-pixel differences in H and W."""
    xf = x.float()
    vdiff = xf[:, 1:, :, :] - xf[:, :-1, :, :]
    hdiff = xf[:, :, 1:, :] - xf[:, :, :-1, :]
    return torch.sum(torch.square(hdiff)) + torch.sum(torch.square(vdiff))


def perceptual_loss(
    vgg_acts: Mapping[str, torch.Tensor],
    content_targets: Mapping[str, torch.Tensor],
    target_grams: Mapping[str, torch.Tensor],
    content_weights: Mapping[str, float],
    style_weights: Mapping[str, float],
    stylized: torch.Tensor,
    beta: float,
) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss and its four parts (the reference's four TB scalars)."""
    grams = {name: gram_matrix(vgg_acts[name]) for name in style_weights}
    c_loss = content_loss(vgg_acts, content_targets, content_weights)
    s_loss = style_loss(grams, target_grams, style_weights)
    t_loss = beta * tv_loss(stylized)
    total = c_loss + s_loss + t_loss
    return total, {"loss": total, "content_loss": c_loss, "style_loss": s_loss, "tv_loss": t_loss}


def _device(*dicts: Mapping[str, torch.Tensor]) -> torch.device:
    for d in dicts:
        for t in d.values():
            return t.device
    return torch.device("cpu")
