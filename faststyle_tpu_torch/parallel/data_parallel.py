"""Data-parallel training step over torch.distributed (counterpart of
faststyle_tpu/parallel/data_parallel.py's `make_dp_train_step`).

Every loss term is a sum over the batch, so summing the gradients over
ranks makes the K-rank step the one-process step on the concatenated
batch. That is why this is an explicit all-reduce(SUM) and not
DistributedDataParallel, which averages: an average would rescale the
gradients Adam sees against its eps and the logged losses. Instance-norm
statistics are per image, so no collective runs inside the forward.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from faststyle_tpu_torch.models import vgg16
from faststyle_tpu_torch.training.train_step import TrainConfig, TrainState, make_grad_fn, to_device


def broadcast_state(state: TrainState, group: Optional[dist.ProcessGroup] = None) -> None:
    """Make every rank's state rank 0's: the params, Adam's moments and the
    step, so ranks seeded or resumed differently cannot diverge."""
    params = list(state.net.parameters())
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, src=0, group=group)
        offset = 0
        for p in params:
            p.copy_(flat[offset : offset + p.numel()].view_as(p))
            offset += p.numel()
    sd = state.optimizer.state_dict()
    host = {
        "state": {i: {k: torch.as_tensor(v).cpu() for k, v in st.items()} for i, st in sd["state"].items()},
        "step": state.step,
    }
    obj = [host]
    dist.broadcast_object_list(obj, src=0, group=group)
    sd["state"] = obj[0]["state"]
    state.optimizer.load_state_dict(sd)
    state.step = obj[0]["step"]


def make_dp_train_step(
    vgg_params: vgg16.Params,
    target_grams: Mapping[str, torch.Tensor],
    config: TrainConfig,
    *,
    group: Optional[dist.ProcessGroup] = None,
    fused_content_tower: bool = False,
) -> Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """(state, this rank's rows of the batch) -> (state, metrics).

    The loss and backward are `train_step.make_grad_fn`, the one the
    single-process step runs, on the local rows. Then one all-reduce(SUM)
    over one flat buffer that holds every gradient and the loss parts, and
    Adam steps on every rank with the same summed gradients. The first
    call on a state's net broadcasts rank 0's state to every rank. The
    metrics are the global batch's, on every rank.
    """
    grad_fn = make_grad_fn(vgg_params, target_grams, config, fused_content_tower=fused_content_tower)
    synced: "weakref.WeakSet[torch.nn.Module]" = weakref.WeakSet()  # nets already broadcast

    def dp_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.net not in synced:
            broadcast_state(state, group)
            synced.add(state.net)
        params = list(state.net.parameters())
        batch = to_device(batch, params[0].device)
        state.optimizer.zero_grad(set_to_none=True)
        parts = grad_fn(state.net, batch)
        keys = sorted(parts)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack([parts[k].float() for k in keys])])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for p in params:
            p.grad = flat[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        state.optimizer.step()
        state.step += 1
        return state, dict(zip(keys, flat[offset:].unbind()))

    return dp_step
