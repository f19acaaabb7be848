"""Data parallelism: the training step over torch.distributed and
batch-sharded serving over a device list (counterpart of
faststyle_tpu/parallel/data_parallel.py).

Every loss term is a sum over the batch, so summing the gradients over
ranks makes the K-rank step the one-process step on the concatenated
batch. That is why this is an explicit all-reduce(SUM) and not
DistributedDataParallel, which averages: an average would rescale the
gradients Adam sees against its eps and the logged losses. Instance-norm
statistics are per image, so no collective runs inside the forward, and
`ShardedStylizer` spreads a batch over devices with none at all.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from faststyle_tpu_torch import inference
from faststyle_tpu_torch.models import transform_net, vgg16
from faststyle_tpu_torch.parallel.mesh import pad_batch_to_devices, serving_devices
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


class ShardedStylizer:
    """Batch-sharded stylization: a batch spread over a list of devices,
    one process driving them all (counterpart of the JAX package's
    `ShardedStylizer` over its data mesh).

    One `inference.Stylizer` per distinct device holds the params there. A
    batch is padded to a multiple of the device count by repeating its last
    image, split in order into equal shards, one per device entry, and cut
    back after. Every shard is launched before any result is fetched, so
    the cards run together. Nothing is exchanged: instance norm is per
    image.

    `params`: torch tensors in torch layouts, or numpy arrays in the file
    layouts (`inference.load_params_numpy`). `devices` defaults to every
    visible card; an entry may repeat (["cpu"] * 4 splits the batch four
    ways on the CPU). The fast-path flags are `inference.Stylizer`'s, and
    the output is float32 NHWC unless one is set, then uint8; under
    `packed_output` the host unpacks it.
    """

    def __init__(
        self,
        params: Mapping,
        devices: Sequence[str | torch.device] | None = None,
        upsample_method: str = "resize",
        compute_dtype: torch.dtype | None = None,
        *,
        output_uint8: bool = False,
        packed_output: bool = False,
        packed_input: bool = False,
    ):
        self.devices = serving_devices(devices)
        # one replica per distinct device, shared by its repeated entries
        self._replicas = {
            d: inference.Stylizer(
                params=params,
                upsample_method=upsample_method,
                compute_dtype=compute_dtype,
                output_uint8=output_uint8,
                packed_output=packed_output,
                packed_input=packed_input,
                device=d,
            )
            for d in dict.fromkeys(self.devices)
        }
        self._packed_output = packed_output

    def stylize_batch(self, imgs: np.ndarray) -> np.ndarray:
        """NHWC RGB [0, 255] float or uint8, any batch size -> stylized NHWC
        on the host: float32, or uint8 with output_uint8 / packed_*."""
        imgs = np.asarray(imgs)
        padded, n = pad_batch_to_devices(imgs, len(self.devices))
        shards = np.split(padded, len(self.devices))
        outs = [self._replicas[d].stylize_batch(s) for d, s in zip(self.devices, shards)]
        out = torch.cat([o.cpu() for o in outs]).numpy()[:n]
        if self._packed_output:
            out = inference.unpack_u8_host(out, *transform_net.output_shape(imgs.shape[1], imgs.shape[2]))
        return out
