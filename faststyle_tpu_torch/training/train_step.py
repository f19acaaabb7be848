"""Perceptual-loss training step (counterpart of
faststyle_tpu/training/train_step.py).

One step: content targets = VGG features of the raw batch (no grad);
transform-net forward; VGG on the stylized output; content, style (Gram
kernel) and TV losses; backward; Adam update. PyTorch runs it eagerly and
updates the net and the optimizer in place, so `train_step` returns the
state object it was given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from faststyle_tpu_torch import losses
from faststyle_tpu_torch.models import transform_net, vgg16
from faststyle_tpu_torch.utils.profiling import span


@dataclass
class TrainState:
    net: transform_net.TransformNet
    optimizer: torch.optim.Optimizer
    step: int = 0


class TrainConfig(NamedTuple):
    content_weights: Tuple[Tuple[str, float], ...]
    style_weights: Tuple[Tuple[str, float], ...]
    beta: float
    learn_rate: float
    upsample_method: str = "resize"
    compute_dtype: Any = None  # e.g. torch.bfloat16 for the conv stacks

    @staticmethod
    def make(
        content_layers=("conv3_3",),
        content_weights=(1.0,),
        style_layers=("conv1_2", "conv2_2", "conv3_3", "conv4_3"),
        style_weights=(5.0, 5.0, 5.0, 5.0),
        beta: float = 0.0,
        learn_rate: float = 1e-3,
        upsample_method: str = "resize",
        compute_dtype=None,
    ) -> "TrainConfig":
        """Defaults = the reference training recipe."""
        if len(content_layers) != len(content_weights):
            raise ValueError(
                f"{len(content_layers)} content layers but {len(content_weights)} weights"
            )
        if len(style_layers) != len(style_weights):
            raise ValueError(f"{len(style_layers)} style layers but {len(style_weights)} weights")
        return TrainConfig(
            tuple(zip(content_layers, content_weights)),
            tuple(zip(style_layers, style_weights)),
            beta,
            learn_rate,
            upsample_method,
            compute_dtype,
        )


def make_optimizer(config: TrainConfig, net: torch.nn.Module) -> torch.optim.Adam:
    # optax.adam's / tf.train.AdamOptimizer's defaults, eps outside the sqrt
    return torch.optim.Adam(net.parameters(), lr=config.learn_rate, betas=(0.9, 0.999), eps=1e-8)


def init_state(
    config: TrainConfig,
    *,
    seed: int = 0,
    params: transform_net.Params | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    """A fresh state: `params`, or the reference init drawn from `seed`."""
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        params = transform_net.init_params(gen, config.upsample_method, device=device)
    net = transform_net.TransformNet(params, config.upsample_method).to(device)
    return TrainState(net, make_optimizer(config, net), 0)


def make_grad_fn(
    vgg_params: vgg16.Params,
    target_grams: Mapping[str, torch.Tensor],
    config: TrainConfig,
    *,
    fused_content_tower: bool = False,
) -> Callable[[transform_net.TransformNet, torch.Tensor], Dict[str, torch.Tensor]]:
    """(net, batch) -> loss parts, leaving the gradients in the net's .grad.

    The one definition of the training loss: `make_train_step` steps Adam
    right after it, `parallel.data_parallel.make_dp_train_step` all-reduces
    the gradients first.

    `fused_content_tower=True` runs one VGG pass on cat([batch, y]) up to
    the pool after the deepest content layer, takes the (detached) batch
    half as the content targets, and continues only the y half into the
    deeper style layers. The same function as the plain form; the batch
    half carries no gradient, but the backward's input-gradient convs run
    over the doubled batch through the shared blocks. Default off, as in
    the reference; with no content layer it is the plain form."""
    content_w = dict(config.content_weights)
    style_w = dict(config.style_weights)
    all_layers = tuple(dict.fromkeys(tuple(content_w) + tuple(style_w)))
    content_layers = tuple(content_w)
    if not all_layers:
        raise ValueError("need at least one content or style layer")
    fused_content_tower = fused_content_tower and bool(content_layers)

    if fused_content_tower:
        # the pool boundary at or after the deepest content layer: the joint
        # [batch; y] prefix covers every content layer
        deepest_content = max(vgg16.layer_index(l) for l in content_layers)
        split_pool = next(
            name for name in vgg16.LAYER_ORDER[deepest_content:] if name.startswith("pool")
        )
        split = vgg16.layer_index(split_pool)
        prefix_layers = tuple(
            dict.fromkeys(tuple(l for l in all_layers if vgg16.layer_index(l) <= split) + (split_pool,))
        )
        suffix_layers = tuple(l for l in all_layers if vgg16.layer_index(l) > split)

    def fused_acts(batch: torch.Tensor, y: torch.Tensor):
        n = batch.shape[0]
        pair = torch.cat([batch, y.to(batch.dtype)])
        joint = vgg16.apply(vgg_params, pair, prefix_layers, compute_dtype=config.compute_dtype)
        tgt, acts = {}, {}
        for name, act in joint.items():
            acts[name] = act[n:]
            if name in content_w:
                tgt[name] = act[:n].detach()
        # the split-pool activation seeds the continuation; it leaves the
        # loss dict unless it is a loss layer itself
        pool_act = acts[split_pool] if split_pool in all_layers else acts.pop(split_pool)
        if suffix_layers:
            acts.update(
                vgg16.apply(
                    vgg_params, pool_act, suffix_layers,
                    compute_dtype=config.compute_dtype, input_layer=split_pool,
                )
            )
        return acts, tgt

    def grad_fn(net: transform_net.TransformNet, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("train.forward"):
            if fused_content_tower:
                y = net(batch, compute_dtype=config.compute_dtype)
                acts, tgt = fused_acts(batch, y)
            else:
                with torch.no_grad():
                    tgt = (
                        vgg16.apply(vgg_params, batch, content_layers, compute_dtype=config.compute_dtype)
                        if content_layers
                        else {}
                    )
                y = net(batch, compute_dtype=config.compute_dtype)
                acts = vgg16.apply(vgg_params, y, all_layers, compute_dtype=config.compute_dtype)
            total, parts = losses.perceptual_loss(
                acts, tgt, target_grams, content_w, style_w, y, config.beta
            )
        with span("train.backward"):
            total.backward()
        return {k: v.detach() for k, v in parts.items()}

    return grad_fn


def to_device(batch, device: str | torch.device = "cuda") -> torch.Tensor:
    """A numpy or torch NHWC batch as a float32 tensor on `device`."""
    if not torch.is_tensor(batch):
        batch = torch.from_numpy(np.asarray(batch, np.float32))
    return batch.to(device, non_blocking=True)


def make_train_step(
    vgg_params: vgg16.Params,
    target_grams: Mapping[str, torch.Tensor],
    config: TrainConfig,
    *,
    fused_content_tower: bool = False,
) -> Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build (state, batch) -> (state, metrics). The state is updated in
    place; the metrics stay on the device (reading them syncs)."""
    grad_fn = make_grad_fn(vgg_params, target_grams, config, fused_content_tower=fused_content_tower)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train.step", state.step):
            batch = to_device(batch, next(state.net.parameters()).device)
            state.optimizer.zero_grad(set_to_none=True)
            parts = grad_fn(state.net, batch)
            with span("train.optimizer"):
                state.optimizer.step()
            state.step += 1
        return state, parts

    return train_step
