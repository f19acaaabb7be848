"""Multi-device dry run at tiny shapes (counterpart of
faststyle_tpu/parallel/dryrun.py): the data-parallel train step, then
batch-sharded serving, packed-u8 deconv serving on ragged frames and
row-sharded serving at a ragged width, over n devices.

    python -m faststyle_tpu_torch.parallel.dryrun --n 2 [--device cpu]

On `cuda` the devices are cuda:0 .. cuda:n-1; on `cpu` the list is
["cpu"] * n. The train step runs in the process group that
`init_data_parallel` gives: a world of one, unless the process was started
by `torch.distributed.run`; the serving runs on rank 0.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from faststyle_tpu_torch.models import transform_net, vgg16
from faststyle_tpu_torch.parallel import data_parallel
from faststyle_tpu_torch.parallel.mesh import init_data_parallel, shard_rows
from faststyle_tpu_torch.parallel.spatial import SpatialStylizer
from faststyle_tpu_torch.training import slow_style
from faststyle_tpu_torch.training.train_step import TrainConfig, init_state

SIZE = 32  # a multiple of 4; the VGG tower takes it down to pool5


def run(n_devices: int, *, device: str = "cuda") -> None:
    if device == "cpu":
        devices = ["cpu"] * n_devices
    else:
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {have} (device='cpu' runs n entries on the CPU)")
        devices = [f"cuda:{i}" for i in range(n_devices)]

    mesh = init_data_parallel(device)
    try:
        # tiny but real: the whole step (transform net, VGG, losses with the
        # Gram, all-reduce, Adam) on a global batch of 2n rows
        config = TrainConfig.make(learn_rate=1e-3, beta=1e-4)
        vgg_params = vgg16.init_params(torch.Generator().manual_seed(0), device=mesh.device)
        state = init_state(config, seed=0, device=mesh.device)
        style = np.random.default_rng(0).uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
        target_grams = slow_style.style_target_grams(vgg_params, style, tuple(dict(config.style_weights)))
        step_fn = data_parallel.make_dp_train_step(vgg_params, target_grams, config)
        batch = np.random.default_rng(1).uniform(0, 255, (2 * n_devices, SIZE, SIZE, 3)).astype(np.float32)
        rows = next(shard_rows(iter([batch]), mesh.rank, mesh.size))
        state, metrics = step_fn(state, rows)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
        if mesh.rank != 0:
            return

        # batch-sharded serving, on a batch the devices do not divide
        stylizer = data_parallel.ShardedStylizer(state.net.params(), devices)
        out = stylizer.stylize_batch(batch[: n_devices + 1])
        if out.shape != (n_devices + 1, SIZE, SIZE, 3) or not np.isfinite(out).all():
            raise AssertionError(f"sharded serving gave {out.shape}, finite {np.isfinite(out).all()}")

        # the serving fast path and the deconv variant together: packed-u8
        # I/O on ragged frames, larger than the 40 px reflect pad
        deconv_params = transform_net.init_params(torch.Generator().manual_seed(3), "deconv", device="cpu")
        packed = data_parallel.ShardedStylizer(
            deconv_params, devices, upsample_method="deconv", packed_input=True, packed_output=True
        )
        frames = np.random.default_rng(3).integers(0, 256, (n_devices, 45, 51, 3), dtype=np.uint8)
        p_out = packed.stylize_batch(frames)
        ohw = transform_net.output_shape(45, 51)  # ragged: (48, 52) by the shape law
        if p_out.shape != (n_devices, *ohw, 3) or p_out.dtype != np.uint8:
            raise AssertionError(f"packed deconv serving gave {p_out.shape} {p_out.dtype}")

        # row-sharded serving of one frame at a ragged width
        big_h = 48 * n_devices  # aligned (H % (4n) == 0) with window room
        big = np.random.default_rng(2).uniform(0, 255, (big_h, 43, 3)).astype(np.float32)
        spatial = SpatialStylizer(state.net.params(), devices, halo=16)
        s_out = spatial(big)
        want = (big_h, transform_net.output_shape(1, 43)[1], 3)  # 43 -> 44 columns
        if s_out.shape != want or not np.isfinite(s_out).all() or spatial.shards_for(big_h) != n_devices:
            raise AssertionError(
                f"spatial serving gave {s_out.shape} (want {want}), finite {np.isfinite(s_out).all()}, "
                f"{spatial.shards_for(big_h)}-way (want {n_devices})"
            )
        print(
            f"[dryrun] {n_devices}-device {device} list OK: train loss {loss:.4f} (DP world of {mesh.size}), "
            f"sharded inference {out.shape}, packed-u8 deconv serving {p_out.shape} (ragged 45x51), "
            f"spatial {s_out.shape} ({n_devices}-way rows, ragged width)"
        )
    finally:
        mesh.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Multi-device dry run of the port at tiny shapes.")
    parser.add_argument("--n", type=int, default=1, help="Number of devices.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
