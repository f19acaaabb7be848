"""Process-group helpers for data parallelism (the torch form of
faststyle_tpu/parallel/mesh.py).

The transform net is ~424K params, so the only parallelism that pays is
data parallelism: every rank holds the whole net, takes its rows of each
global batch, and the gradients are summed across ranks. One process per
card, as `torch.distributed.run` starts them; `init_data_parallel` reads
the rank it was given from the environment, or makes a world of one.
Serving needs no process group: one process drives a list of devices
(`serving_devices`).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

from faststyle_tpu_torch import resolve_device


@dataclass(frozen=True)
class DataMesh:
    """This process's place in the default process group's data-parallel
    world: its rank, the world size and the device it computes on. `close`
    destroys the group if `init_data_parallel` made it."""

    rank: int
    size: int
    device: str | torch.device = "cuda"
    owns_group: bool = False

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def world_from_env() -> tuple[int, int, int]:
    """(rank, world size, local rank) as `torch.distributed.run` sets them
    in RANK, WORLD_SIZE and LOCAL_RANK; (0, 1, 0) when they are unset."""
    rank = int(os.environ.get("RANK", 0))
    size = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", rank))
    if not 0 <= rank < size:
        raise ValueError(f"RANK={rank} is outside WORLD_SIZE={size}")
    return rank, size, local


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_data_parallel(device: str | torch.device = "cuda") -> DataMesh:
    """Join (or make) the default process group: `nccl` on cuda:LOCAL_RANK,
    `gloo` on the CPU. Under `torch.distributed.run` the rendezvous is its
    MASTER_ADDR/MASTER_PORT; without them the world is this one process,
    on a free local port. A group that already exists is used as it is."""
    dev = resolve_device(device)
    rank, size, local = world_from_env()
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    if owns:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size)
        elif size == 1:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
        else:
            raise ValueError(f"WORLD_SIZE={size} without MASTER_ADDR: start the ranks with torch.distributed.run")
    return DataMesh(dist.get_rank(), dist.get_world_size(), dev, owns)


def shard_rows(batches: Iterable[np.ndarray], rank: int, size: int) -> Iterator[np.ndarray]:
    """Rows [rank*b/size, (rank+1)*b/size) of each global batch, cut on the
    host before the copy, so `size` ranks that iterate the same seeded
    Batcher train on exactly the batches one process would. Closing this
    closes the source."""
    it = iter(batches)
    try:
        for batch in it:
            n = batch.shape[0]
            if n % size:
                raise ValueError(f"batch of {n} does not split over {size} ranks")
            k = n // size
            yield batch[rank * k : (rank + 1) * k]
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def serving_devices(devices: Sequence[str | torch.device] | None = None) -> list[torch.device]:
    """The device list one serving process drives: `devices` as given (an
    entry may repeat, e.g. ["cpu"] * 4), or every visible card, cuda:0 to
    cuda:k-1 (the counterpart of the JAX package's `data_mesh()`); raises
    when a card is asked for and CUDA is absent."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("need at least one device")
    return out


def pad_batch_to_devices(batch: np.ndarray, n_devices: int) -> tuple[np.ndarray, int]:
    """Pad the batch (repeating the last image) so it divides the devices;
    returns (padded, original size)."""
    n = batch.shape[0]
    rem = n % n_devices
    if rem == 0:
        return batch, n
    pad = n_devices - rem
    return np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)]), n
