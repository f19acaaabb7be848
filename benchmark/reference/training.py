"""The perceptual-loss train step, plainly (Johnson et al. 2016, the
reference train.py's recipe):

  content targets = VGG16 features of the batch;
  y = transform_net(batch);
  loss = sum_c w_c * sum((A_c(y) - T_c)^2) / (h w c)
       + sum_s w_s * sum((G_s(y) - G_s(style))^2) / c^2
       + beta * TV(y),
  with G(F) = F F^T / (h w c) per image (a one-image style Gram broadcast
  over the batch), summed (not averaged) over the batch;
  Adam (torch.optim.Adam's form: step lr / (1 - b1^t), denominator
  sqrt(v) / sqrt(1 - b2^t) + eps).

Batches are NHWC float32 in [0, 255]; parameters are the transform net's
`{block: {var}}` with OIHW kernels.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.reference import transform_net, vgg16
from benchmark.reference.precision import round_to


def gram(f, precision: str = "float32"):
    """[N, C, H, W] -> [N, C, C] / (h w c)."""
    n, c, h, w = f.shape
    flat = round_to(f.reshape(n, c, h * w), precision)
    return torch.bmm(flat, flat.transpose(1, 2)) / float(h * w * c)


@contextlib.contextmanager
def products_in(precision: str, device):
    """For "tf32" on a card, cuDNN and cuBLAS run TF32 inside the block;
    otherwise full float32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = precision == "tf32" and torch.device(device).type == "cuda"
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def style_grams(vgg_params: dict, style_img: np.ndarray, config: dict, device, precision: str = "float32") -> dict:
    """The style image's Grams, [1, C, C] per style layer."""
    x = torch.from_numpy(np.asarray(style_img, np.float32)).to(device).permute(2, 0, 1)[None]
    layers = list(config["loss"]["style_layers"])
    with torch.no_grad(), products_in(precision, device):
        acts = vgg16.features(vgg_params, x, config["vgg16"], layers, precision)
        return {name: gram(acts[name], precision) for name in layers}


def loss(params: dict, vgg_params: dict, grams: dict, batch, config: dict, precision: str = "float32"):
    """The recipe's loss on one NHWC batch."""
    spec = config["loss"]
    x = batch.permute(0, 3, 1, 2)
    with torch.no_grad():
        targets = vgg16.features(vgg_params, x, config["vgg16"], list(spec["content_layers"]), precision)
    y = transform_net.forward(params, x, config["model"], precision)
    layers = list(dict.fromkeys(list(spec["content_layers"]) + list(spec["style_layers"])))
    acts = vgg16.features(vgg_params, y, config["vgg16"], layers, precision)
    total = torch.zeros((), device=batch.device)
    for name, weight in spec["content_layers"].items():
        a = acts[name]
        total = total + weight * torch.sum((a - targets[name]) ** 2) / float(a[0].numel())
    for name, weight in spec["style_layers"].items():
        g = gram(acts[name], precision)
        total = total + weight * torch.sum((g - grams[name]) ** 2) / float(g.shape[-1] ** 2)
    if spec["beta"]:
        tv = torch.sum((y[:, :, 1:] - y[:, :, :-1]) ** 2) + torch.sum((y[:, :, :, 1:] - y[:, :, :, :-1]) ** 2)
        total = total + spec["beta"] * tv
    return total


def _loss_of(params, vgg_params, grams, batch, config, precision, half_batch):
    if half_batch:
        return 2.0 * loss(params, vgg_params, grams, batch[: batch.shape[0] // 2], config, precision)
    return loss(params, vgg_params, grams, batch, config, precision)


def _leaves(params: dict) -> tuple[dict, dict]:
    """({(block, var): leaf requiring grad}, the same leaves as {block: {var}})."""
    leaves = {(b, v): t.detach().clone().requires_grad_(True) for b, sub in params.items() for v, t in sub.items()}
    nested: dict = {}
    for (b, v), t in leaves.items():
        nested.setdefault(b, {})[v] = t
    return leaves, nested


def train_steps(params0: dict, vgg_params: dict, style_img: np.ndarray, batches, config: dict, device,
                precision: str = "float32", half_batch: bool = False):
    """Adam steps from `params0` over `batches`: returns (the losses, the
    first step's gradients, the parameters after the last step), the
    gradients and parameters as {(block, var): tensor}. `half_batch`
    plants a fault for the control: each loss over the first half of the
    batch, doubled."""
    opt = config["optimizer"]
    leaves, params = _leaves(params0)
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    s = {k: torch.zeros_like(t) for k, t in leaves.items()}
    grams = style_grams(vgg_params, style_img, config, device, precision)
    losses, grad1 = [], None
    with products_in(precision, device):
        for t, batch in enumerate(batches, start=1):
            value = _loss_of(params, vgg_params, grams, batch, config, precision, half_batch)
            grads = torch.autograd.grad(value, list(leaves.values()))
            losses.append(float(value.detach()))
            if grad1 is None:
                grad1 = {k: g.detach().clone() for k, g in zip(leaves, grads)}
            c1, c2 = 1 - opt["beta1"] ** t, 1 - opt["beta2"] ** t
            with torch.no_grad():
                for (k, p), g in zip(leaves.items(), grads):
                    m[k].mul_(opt["beta1"]).add_(g, alpha=1 - opt["beta1"])
                    s[k].mul_(opt["beta2"]).addcmul_(g, g, value=1 - opt["beta2"])
                    p.sub_(opt["learn_rate"] / c1 * m[k] / (s[k].sqrt() / math.sqrt(c2) + opt["eps"]))
    return losses, grad1, {k: p.detach() for k, p in leaves.items()}


def loss_and_grads(params: dict, vgg_params: dict, style_img: np.ndarray, batch, config: dict, device,
                   precision: str = "float32", half_batch: bool = False):
    """The loss and its gradients at `params` ({(block, var): tensor}) on one
    batch: (loss, {(block, var): gradient})."""
    nested: dict = {}
    for (b, v), t in params.items():
        nested.setdefault(b, {})[v] = t
    leaves, nested = _leaves(nested)
    grams = style_grams(vgg_params, style_img, config, device, precision)
    with products_in(precision, device):
        value = _loss_of(nested, vgg_params, grams, batch, config, precision, half_batch)
        grads = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), {k: g.detach() for k, g in zip(leaves, grads)}
