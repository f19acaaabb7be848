#!/usr/bin/env python3
"""Gatys-style direct pixel optimization (VGG16 variant).

    python -m faststyle_tpu_torch.cli.slow_style --style_img_path style.jpg \\
        --cont_img_path content.jpg --vgg_path vgg16_weights.npz

The flags are faststyle_tpu's slow_style CLI's, with its defaults (Adam lr
1e1, 500 steps, beta 1e-4), plus `--device {cuda,cpu}` (default cuda; no
silent CPU fallback). Prints `<step> <loss>` every 10 steps. TF32 is off
(`full_float32`).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a style transfer net.")
    parser.add_argument("--style_img_path", help="Path to style template image.")
    parser.add_argument("--cont_img_path", help="Path to content template image.")
    parser.add_argument("--learn_rate", default=1e1, type=float)
    parser.add_argument("--loss_content_layers", nargs="*", default=["conv3_3"])
    parser.add_argument("--loss_style_layers", nargs="*", default=["conv1_2", "conv2_2", "conv3_3", "conv4_3"])
    parser.add_argument("--content_weights", nargs="*", default=[1.0], type=float)
    parser.add_argument("--style_weights", nargs="*", default=[5.0, 5.0, 5.0, 5.0], type=float)
    parser.add_argument("--num_steps_break", default=500, type=int)
    parser.add_argument("--beta", default=1e-4, type=float)
    parser.add_argument("--style_target_resize", default=1.0, type=float)
    parser.add_argument("--cont_target_resize", default=1.0, type=float)
    parser.add_argument("--output_img_path", default="./out.jpg")
    parser.add_argument("--vgg_path", default="libs/vgg16_weights.npz")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument(
        "--precision",
        choices=["float32", "bfloat16"],
        default="float32",
        help="VGG compute precision (pixels always optimize in float32).",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where to optimize; cuda raises when no GPU is present.",
    )
    return parser


def main(argv=None):
    """Returns (the HWC float image, [(step, loss), ...] as logged)."""
    from faststyle_tpu_torch import full_float32

    full_float32()
    args = setup_parser().parse_args(argv)

    import torch

    from faststyle_tpu_torch import resolve_device
    from faststyle_tpu_torch.models import vgg16
    from faststyle_tpu_torch.training import slow_style
    from faststyle_tpu_torch.utils import image_io

    device = resolve_device(args.device)
    vgg_file = Path(args.vgg_path)
    if not vgg_file.exists():
        raise SystemExit(f"VGG16 weights not found at {vgg_file}. Download vgg16_weights.npz and pass --vgg_path.")
    if len(args.loss_content_layers) != len(args.content_weights):
        raise SystemExit("--loss_content_layers and --content_weights lengths differ")
    if len(args.loss_style_layers) != len(args.style_weights):
        raise SystemExit("--loss_style_layers and --style_weights lengths differ")
    vgg_params = vgg16.load_npz(vgg_file, device=device)

    style_img = image_io.imresize(image_io.imread(args.style_img_path), args.style_target_resize).astype("float32")
    cont_img = image_io.imresize(image_io.imread(args.cont_img_path), args.cont_target_resize).astype("float32")

    history = []

    def log(step, loss):
        history.append((step, loss))
        print(step, loss, flush=True)

    out = slow_style.optimize(
        vgg_params,
        cont_img,
        style_img,
        content_weights=dict(zip(args.loss_content_layers, args.content_weights)),
        style_weights=dict(zip(args.loss_style_layers, args.style_weights)),
        beta=args.beta,
        learn_rate=args.learn_rate,
        num_steps=args.num_steps_break,
        seed=args.seed,
        log_fn=log,
        compute_dtype=torch.bfloat16 if args.precision == "bfloat16" else None,
    )
    Path(args.output_img_path).parent.mkdir(parents=True, exist_ok=True)
    image_io.imwrite(args.output_img_path, out)
    print(f"Saved {args.output_img_path}")
    return out, history


if __name__ == "__main__":
    main()
