#!/usr/bin/env python3
"""Export a transform-net model to the reference's TF1 checkpoint format
(the port's copy of tools/export_tf_checkpoint.py: the same arguments and
the same bytes).

    python -m faststyle_tpu_torch.tools.export_tf_checkpoint models/starry_distilled.npz \
        /tmp/export/starry_distilled.ckpt [--scope img_t_net]

A model (`.npz`, or a TF1 prefix) becomes `<out>.index` +
`<out>.data-00000-of-00001`, a bundle the reference's TF1 `Saver.restore`
reads unchanged, written by `compat.tf1_checkpoint` without TensorFlow.
Host-only: the params stay numpy arrays in the file layouts.
"""

from __future__ import annotations

import argparse

from faststyle_tpu_torch.compat import tf1_checkpoint
from faststyle_tpu_torch.inference import load_params_numpy


def setup_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Export a transform-net model as a TF1 checkpoint.")
    ap.add_argument("model", help="source model (.npz or TF1 ckpt prefix)")
    ap.add_argument("out", help="output checkpoint prefix (e.g. out/starry.ckpt)")
    ap.add_argument("--scope", default="img_t_net")
    return ap


def main(argv=None) -> None:
    args = setup_parser().parse_args(argv)
    params = load_params_numpy(args.model)
    tf1_checkpoint.save_transform_net_params(params, args.out, scope=args.scope)
    n = sum(len(s) for s in params.values())
    print(f"wrote {n} variables to {args.out}.{{index,data-00000-of-00001}}")


if __name__ == "__main__":
    main()
