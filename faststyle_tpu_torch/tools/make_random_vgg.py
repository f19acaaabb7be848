#!/usr/bin/env python3
"""Write a random-init VGG16 in Frossard's npz key format (the port's copy
of tools/make_random_vgg.py: the same keys, shapes, dtypes and scheme).

    python -m faststyle_tpu_torch.tools.make_random_vgg [out.npz] [--seed 0]

A stand-in for `scripts/get_vgg16_weights.sh` where nothing can be
downloaded: `cli.train` and `cli.slow_style` run end to end on it (the
perceptual losses over random features still fall, which exercises the
training machinery), but the reference recipe's style quality needs the
pretrained weights. The weights are `models.vgg16.init_params` drawn on the
CPU from a seeded torch.Generator (truncated normal in [-2, 2] times 0.1,
zero biases), written HWIO as `{layer}_W` / `{layer}_b`. The JAX tool
draws from jax.random, so the two files hold other numbers for the same
seed, from the same distribution.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from faststyle_tpu_torch import convert
from faststyle_tpu_torch.models import vgg16


def setup_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Write a random-init VGG16 in Frossard's npz format.")
    ap.add_argument("out", nargs="?", default="libs/vgg16_weights_random.npz")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> Path:
    args = setup_parser().parse_args(argv)
    params = vgg16.init_params(torch.Generator().manual_seed(args.seed), device="cpu")
    flat = {}
    for name, group in convert.params_to_numpy(params).items():
        flat[f"{name}_W"] = group["W"].astype(np.float32)
        flat[f"{name}_b"] = group["b"].astype(np.float32)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flat)
    vgg16.load_npz(out, device="cpu")  # round trip
    print(f"wrote random-init VGG16 ({len(flat)} arrays) to {out}")
    return out


if __name__ == "__main__":
    main()
