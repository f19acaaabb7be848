#!/usr/bin/env python3
"""Train a style transfer net (perceptual loss) with the PyTorch port.

    python -m faststyle_tpu_torch.cli.train --image_dir <jpegs> \\
        --vgg_path vgg16_weights.npz --model_name starry

The flags are faststyle_tpu's train CLI's, with its defaults (the published
recipe: batch 4, 256x256, Adam 1e-3, 2 epochs, style weights 5x4), plus
`--device {cuda,cpu}` (default cuda; there is no silent CPU fallback).
`--image_dir` is the data source; `--train_dir` (TFRecords),
`--data_parallel` and `--debug_nans` exit with a "not yet ported" message.
TF32 is off (`full_float32`): `--precision float32` is full float32.
"""

from __future__ import annotations

import argparse
from pathlib import Path

_NOT_PORTED = {
    "train_dir": "--train_dir (TFRecord input) is not yet ported "
    "(ROADMAP.md, modules to port: 'TFRecords'); use --image_dir",
    "data_parallel": "--data_parallel is not yet ported (ROADMAP.md, modules to port: 'parallel/')",
    "debug_nans": "--debug_nans is not yet ported "
    "(ROADMAP.md, modules to port: 'fused_content_tower and --debug_nans')",
}


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a style transfer net.")
    parser.add_argument("--train_dir", help="Directory of TFRecords training data.")
    parser.add_argument("--model_name", help="Name of model being trained.")
    parser.add_argument(
        "--style_img_path",
        default="./style_images/starry_night_crop.jpg",
        help="Path to style target image.",
    )
    parser.add_argument("--learn_rate", default=1e-3, type=float)
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--n_epochs", default=2, type=int)
    parser.add_argument("--preprocess_size", default=[256, 256], nargs=2, type=int)
    parser.add_argument(
        "--run_name",
        default=None,
        help="Name of log directory within ./summaries. Defaults to a unique "
        "name derived from --model_name.",
    )
    parser.add_argument("--loss_content_layers", nargs="*", default=["conv3_3"])
    parser.add_argument(
        "--loss_style_layers",
        nargs="*",
        default=["conv1_2", "conv2_2", "conv3_3", "conv4_3"],
    )
    parser.add_argument("--content_weights", nargs="*", default=[1.0], type=float)
    parser.add_argument("--style_weights", nargs="*", default=[5.0, 5.0, 5.0, 5.0], type=float)
    parser.add_argument("--num_steps_ckpt", default=1000, type=int)
    parser.add_argument(
        "--num_pipe_buffer",
        default=4000,
        type=int,
        help="Number of images in the host shuffle buffer.",
    )
    parser.add_argument("--num_steps_break", default=-1, type=int)
    parser.add_argument(
        "--beta",
        default=0.0,
        type=float,
        help="TV regularization weight (try 1e-4 with --upsample_method deconv).",
    )
    parser.add_argument("--style_target_resize", default=1.0, type=float)
    parser.add_argument("--upsample_method", choices=["deconv", "resize"], default="resize")
    parser.add_argument(
        "--vgg_path",
        default="libs/vgg16_weights.npz",
        help="Frossard-format VGG16 weights .npz.",
    )
    parser.add_argument(
        "--image_dir",
        default=None,
        help="Train from a flat dir of JPEG/PNG files.",
    )
    parser.add_argument("--resume", action="store_true", help="Resume from latest checkpoint.")
    parser.add_argument("--precision", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument(
        "--data_parallel",
        action="store_true",
        help="Shard the batch over all devices (not yet ported).",
    )
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument(
        "--debug_nans",
        action="store_true",
        help="Fail fast on non-finite values (not yet ported).",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where to train; cuda raises when no GPU is present.",
    )
    return parser


def main(argv=None):
    from faststyle_tpu_torch import full_float32

    full_float32()
    args = setup_parser().parse_args(argv)
    for flag, msg in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(msg)
    if not args.image_dir:
        raise SystemExit("need --image_dir (a directory of JPEG/PNG files)")

    import torch

    from faststyle_tpu_torch import resolve_device
    from faststyle_tpu_torch.data import pipeline
    from faststyle_tpu_torch.models import vgg16
    from faststyle_tpu_torch.training import loop
    from faststyle_tpu_torch.training.train_step import TrainConfig
    from faststyle_tpu_torch.utils import image_io

    device = resolve_device(args.device)
    vgg_file = Path(args.vgg_path)
    if not vgg_file.exists():
        raise SystemExit(
            f"VGG16 weights not found at {vgg_file}. Download vgg16_weights.npz "
            "(Frossard's Caffe conversion) and pass --vgg_path."
        )
    vgg_params = vgg16.load_npz(vgg_file, device=device)

    style_img = image_io.imread(args.style_img_path)
    style_img = image_io.imresize(style_img, args.style_target_resize)

    config = TrainConfig.make(
        content_layers=tuple(args.loss_content_layers),
        content_weights=tuple(args.content_weights),
        style_layers=tuple(args.loss_style_layers),
        style_weights=tuple(args.style_weights),
        beta=args.beta,
        learn_rate=args.learn_rate,
        upsample_method=args.upsample_method,
        compute_dtype=torch.bfloat16 if args.precision == "bfloat16" else None,
    )
    batcher = pipeline.image_dir_batcher(
        args.image_dir,
        batch_size=args.batch_size,
        resize_shape=tuple(args.preprocess_size),
        n_epochs=args.n_epochs,
        min_after_dequeue=args.num_pipe_buffer,
        seed=args.seed,
    )
    batches = pipeline.device_prefetch(iter(batcher), depth=2, device=device)
    try:
        return loop.train(
            vgg_params=vgg_params,
            style_img=style_img,
            batches=batches,
            config=config,
            model_name=args.model_name or "model",
            seed=args.seed,
            num_steps_ckpt=args.num_steps_ckpt,
            num_steps_break=args.num_steps_break,
            run_name=args.run_name,
            resume=args.resume,
            device=device,
        )
    finally:
        batches.close()  # stops the prefetch thread and the decode pool


if __name__ == "__main__":
    main()
