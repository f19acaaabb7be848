"""Gatys-style direct pixel optimization, and the style and content targets
of the perceptual losses (counterpart of faststyle_tpu/training/slow_style.py).

`optimize` runs Adam on the pixels only, with the loss content + style +
beta * tv through `losses.perceptual_loss`, so every step runs the Gram
kernel forward on each style layer (and its backward matmul) at the content
image's own size. The JAX package runs the steps as a jitted scan; here
they run eagerly, and the host reads the loss only at the `log_every`
boundaries.

Fidelity notes (the reference's slow_style.py):
  * pixels start as uniform white noise in [0, 255); the JAX package draws
    it from jax.random, which torch cannot reproduce, so the port draws its
    own from a seeded torch.Generator, and `init=` takes an explicit array
    (the tests pass the JAX package's draw to compare step by step)
  * Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, as optax's)
  * no clamping to [0, 255] during or after: the image writer clips
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

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


def pixel_loss(
    vgg_params: vgg16.Params,
    pixels: torch.Tensor,
    tgt_content: Mapping[str, torch.Tensor],
    tgt_grams: Mapping[str, torch.Tensor],
    content_weights: Mapping[str, float],
    style_weights: Mapping[str, float],
    beta: float,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The loss `optimize` descends: content + style + beta * tv of the
    pixels [1,H,W,3] through the VGG tower up to the deepest layer named."""
    layers = tuple(dict.fromkeys(tuple(content_weights) + tuple(style_weights)))
    acts = vgg16.apply(vgg_params, pixels, layers, compute_dtype=compute_dtype)
    loss, _ = losses.perceptual_loss(acts, tgt_content, tgt_grams, content_weights, style_weights, pixels, beta)
    return loss


def optimize(
    vgg_params: vgg16.Params,
    content_img: np.ndarray,
    style_img: np.ndarray,
    *,
    content_weights: Mapping[str, float],
    style_weights: Mapping[str, float],
    beta: float = 1e-4,
    learn_rate: float = 1e1,
    num_steps: int = 500,
    log_every: int = 10,
    seed: int = 0,
    log_fn: Optional[Callable[[int, float], None]] = None,
    compute_dtype: torch.dtype | None = None,
    init: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Run the pixel optimization on the VGG params' device; returns the
    HWC float image (unclamped). `log_fn(done, loss)` gets the loss of the
    last step of every `log_every` steps (and of the last, shorter chunk),
    never past `num_steps`; `log_every <= 0` logs once at the end.
    `init` ([H,W,3] or [1,H,W,3]) replaces the seeded white-noise start."""
    device = vgg_params["conv1_1"]["W"].device
    content_img = np.asarray(content_img, np.float32)
    if content_img.ndim == 3:
        content_img = content_img[None]
    style_img = np.asarray(style_img, np.float32)
    if style_img.ndim == 3:
        style_img = style_img[None]

    c_layers = tuple(content_weights)
    s_layers = tuple(style_weights)
    if not c_layers + s_layers:
        raise ValueError("need at least one content or style layer")
    # single-sided runs are legitimate (style-only = texture synthesis):
    # skip the absent side's target pass
    tgt_grams = style_target_grams(vgg_params, style_img, s_layers) if s_layers else {}
    tgt_content = content_targets(vgg_params, content_img, c_layers) if c_layers else {}

    if init is None:
        gen = torch.Generator().manual_seed(seed)
        start = torch.rand(content_img.shape, generator=gen) * 255.0
    else:
        start = torch.from_numpy(np.array(init, np.float32)).reshape(content_img.shape)
    pixels = start.to(device).requires_grad_()
    opt = torch.optim.Adam([pixels], lr=learn_rate, betas=(0.9, 0.999), eps=1e-8)

    if log_every <= 0:
        log_every = num_steps  # no periodic logging: one chunk
    for done in range(1, num_steps + 1):
        opt.zero_grad(set_to_none=True)
        loss = pixel_loss(
            vgg_params, pixels, tgt_content, tgt_grams, content_weights, style_weights, beta, compute_dtype
        )
        loss.backward()
        opt.step()
        if log_fn is not None and (done % log_every == 0 or done == num_steps):
            log_fn(done, loss.item())
    return pixels.detach()[0].cpu().numpy()
