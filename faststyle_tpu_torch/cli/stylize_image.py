#!/usr/bin/env python3
"""Stylize an image, or a directory of images, with a trained transform net.

    python -m faststyle_tpu_torch.cli.stylize_image --input_img_path in.jpg \\
        --output_img_path out.jpg --model_path models/starry_final.ckpt

The flags are faststyle_tpu's stylize_image CLI's, with its defaults, plus
`--device {cuda,cpu}` (default cuda; there is no silent CPU fallback).
`--model_path` takes a TF1 checkpoint prefix or a `.npz` (a `.ckpt` name
resolves to the `.npz` beside it when no TF1 files exist). An AdaIN model
(`models/adain.py`, known by its blocks) stylizes with `--style_image`,
its shorter side resized to 512 as the AdaIN reference's test.py does,
and writes the decoder's extent (`adain.output_shape`). `--input_dir`
groups the images by shape and spreads up to `--batch_size` of them per
call over every visible card (`parallel.data_parallel.ShardedStylizer`),
uint8 out of the devices. `--spatial` shards one image's rows over every
visible card (`parallel.spatial.SpatialStylizer`). With `--device cpu`
both run on one CPU entry. TF32 is off (`full_float32`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

_IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png"}


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Use a trained fast style transfer model to filter an "
        "input image, and save to an output image."
    )
    parser.add_argument("--input_img_path", help="Input content image that will be stylized.")
    parser.add_argument("--output_img_path", help="Desired output image path.", default="./results/styled.jpg")
    parser.add_argument(
        "--model_path",
        default="./models/starry_final.ckpt",
        help="Path to .ckpt (TF1) or .npz (native) for the trained model.",
    )
    parser.add_argument(
        "--content_target_resize",
        help="Resize input content image. Useful if having OOM issues.",
        default=1.0,
        type=float,
    )
    parser.add_argument(
        "--upsample_method",
        help="The upsample method that was used to construct the model being loaded.",
        choices=["resize", "deconv"],
        default="resize",
    )
    parser.add_argument(
        "--precision",
        help="Compute precision for the conv stack.",
        choices=["float32", "bfloat16"],
        default="float32",
    )
    parser.add_argument(
        "--input_dir",
        default=None,
        help="Stylize every image in a directory instead of one file; same-size "
        "images are batched and sharded across all visible cards.",
    )
    parser.add_argument("--output_dir", default="./results", help="Output directory for --input_dir mode.")
    parser.add_argument("--batch_size", default=8, type=int, help="Max images per device batch in --input_dir mode.")
    parser.add_argument(
        "--spatial",
        action="store_true",
        help="Shard ONE giant image's rows across all cards "
        "(parallel.spatial; both 'resize' and 'deconv' models). Requires "
        "multiple devices to help; auto-falls back to single-device for "
        "misaligned heights.",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where to stylize; cuda raises when no GPU is present.",
    )
    parser.add_argument("--style_image", default=None, help="The style image of an AdaIN model (any style).")
    return parser


def load_style_image(path) -> "np.ndarray":
    """An AdaIN style image as RGB uint8, its shorter side resized to
    `adain.STYLE_SIZE` (test.py's style_size)."""
    from faststyle_tpu_torch.models import adain
    from faststyle_tpu_torch.utils import image_io

    img = image_io.imread(path)
    return image_io.imresize(img, adain.STYLE_SIZE / min(img.shape[:2]))


def style_for(stylizer, path):
    """The handle of the style image at `path` for a model that stylizes
    with one (AdaIN), None for a transform net; exits on a missing or a
    stray `--style_image`."""
    if not stylizer.takes_style:
        if path:
            raise SystemExit("--style_image is an AdaIN model's; this model is a transform net")
        return None
    if not path:
        raise SystemExit("an AdaIN model needs --style_image")
    return stylizer.encode_style(load_style_image(path))


def _transform_net_params(model_path):
    """The params of a transform net, for the batch and row-sharded modes;
    an AdaIN model is refused there."""
    from faststyle_tpu_torch.inference import load_params_numpy
    from faststyle_tpu_torch.models import adain

    params = load_params_numpy(model_path)
    if adain.is_adain(params):
        raise SystemExit("an AdaIN model is served one image at a time: --input_dir and --spatial are the "
                         "transform net's")
    return params


def _devices(args):
    """Every visible card, or one CPU entry under --device cpu."""
    return ["cpu"] if args.device == "cpu" else None


def stylize_directory(args, compute_dtype) -> int:
    """Batch mode: group the images by (resized) shape and spread up to
    --batch_size of each group per call over the devices
    (`ShardedStylizer`), uint8 frames in (cast on the device, the same
    values as the JAX CLI's float32 frames) and uint8 out. Returns the
    number of images written."""
    import numpy as np

    from faststyle_tpu_torch.parallel.data_parallel import ShardedStylizer
    from faststyle_tpu_torch.utils import image_io

    in_dir, out_dir = Path(args.input_dir), Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in in_dir.iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES)
    if not files:
        raise SystemExit(f"no images in {in_dir}")
    stylizer = ShardedStylizer(
        _transform_net_params(args.model_path),
        _devices(args),
        upsample_method=args.upsample_method,
        compute_dtype=compute_dtype,
        output_uint8=True,  # clip and cast on the device: a quarter of float32's bytes back
    )

    def load(path: Path):
        return image_io.imresize(image_io.imread(path), args.content_target_resize)

    def probe_shape(path: Path):
        # a header-only size read, so grouping holds no decoded frames;
        # decoding happens per batch below
        import PIL.Image

        with PIL.Image.open(path) as im:
            w0, h0 = im.size
        s = args.content_target_resize
        if s != 1.0:
            h0, w0 = round(h0 * s), round(w0 * s)
        return (h0, w0, 3)

    by_shape: dict = {}
    try:
        for f in files:
            by_shape.setdefault(probe_shape(f), []).append(f)
    except ImportError:  # no PIL: decode to probe
        by_shape = {}
        for f in files:
            by_shape.setdefault(load(f).shape, []).append(f)
    done = 0
    for shape, paths in by_shape.items():
        for i in range(0, len(paths), args.batch_size):
            chunk = paths[i : i + args.batch_size]
            batch = np.stack([load(f) for f in chunk])
            if batch.shape[1:] != tuple(shape):  # probe and decode disagree
                raise SystemExit(f"{chunk[0]}: decoded shape {batch.shape[1:]} != probed {shape}")
            out = stylizer.stylize_batch(batch)
            for f, img_out in zip(chunk, out):
                image_io.imwrite(out_dir / f"styled_{f.name}", img_out)
                done += 1
            print(f"{done}/{len(files)} done ({shape[1]}x{shape[0]})")
    return done


def main(argv=None):
    from faststyle_tpu_torch import full_float32

    full_float32()
    args = setup_parser().parse_args(argv)

    import numpy as np
    import torch

    from faststyle_tpu_torch.inference import Stylizer
    from faststyle_tpu_torch.utils import image_io

    dtype = torch.bfloat16 if args.precision == "bfloat16" else None
    if args.input_dir:
        if args.spatial:
            raise SystemExit(
                "--spatial shards ONE image's rows; with --input_dir use the "
                "default batch-sharded mode (images spread across chips)"
            )
        return stylize_directory(args, dtype)
    if not args.input_img_path:
        raise SystemExit("need --input_img_path (or --input_dir)")

    img = image_io.imresize(image_io.imread(args.input_img_path), args.content_target_resize)
    if args.spatial:
        from faststyle_tpu_torch.parallel.spatial import SpatialStylizer

        spatial = SpatialStylizer(
            _transform_net_params(args.model_path),
            _devices(args),
            compute_dtype=dtype,
            upsample_method=args.upsample_method,
        )
        n = spatial.shards_for(img.shape[0])
        print(f"Evaluating ({n}-way row sharding)...")
        out = np.clip(spatial(img), 0, 255).astype(np.uint8)
    else:
        stylizer = Stylizer(
            model_path=args.model_path,
            upsample_method=args.upsample_method,
            compute_dtype=dtype,
            device=args.device,
        )
        style = style_for(stylizer, args.style_image)
        print("Evaluating...")
        out = stylizer(img, style=style)
    print("Saving image.")
    Path(args.output_img_path).parent.mkdir(parents=True, exist_ok=True)
    image_io.imwrite(args.output_img_path, out)
    print("Done.")
    return out


if __name__ == "__main__":
    main()
