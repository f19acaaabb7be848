#!/usr/bin/env python3
"""Stylize an image, or a directory of images, with a trained transform net.

    python -m faststyle_tpu_torch.cli.stylize_image --input_img_path in.jpg \\
        --output_img_path out.jpg --model_path models/starry_final.ckpt

The flags are faststyle_tpu's stylize_image CLI's, with its defaults, plus
`--device {cuda,cpu}` (default cuda; there is no silent CPU fallback).
`--model_path` takes a TF1 checkpoint prefix or a `.npz` (a `.ckpt` name
resolves to the `.npz` beside it when no TF1 files exist). `--input_dir`
groups the images by shape and stylizes up to `--batch_size` of them per
call on the one card, uint8 out of the device. `--spatial` exits with a
"not yet ported" message. TF32 is off (`full_float32`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

_NOT_PORTED_SPATIAL = "--spatial is not yet ported (ROADMAP.md, modules to port: 'parallel/')"
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
        help="Stylize every image in a directory instead of one file; same-size images are batched.",
    )
    parser.add_argument("--output_dir", default="./results", help="Output directory for --input_dir mode.")
    parser.add_argument("--batch_size", default=8, type=int, help="Max images per device batch in --input_dir mode.")
    parser.add_argument(
        "--spatial",
        action="store_true",
        help="Shard ONE giant image's rows across cards (not yet ported).",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where to stylize; cuda raises when no GPU is present.",
    )
    return parser


def stylize_directory(args, compute_dtype) -> int:
    """Batch mode: group the images by (resized) shape and stylize up to
    --batch_size of each group per call, uint8 out of the device. Returns
    the number of images written."""
    import numpy as np

    from faststyle_tpu_torch.inference import Stylizer
    from faststyle_tpu_torch.utils import image_io

    in_dir, out_dir = Path(args.input_dir), Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in in_dir.iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES)
    if not files:
        raise SystemExit(f"no images in {in_dir}")
    stylizer = Stylizer(
        model_path=args.model_path,
        upsample_method=args.upsample_method,
        compute_dtype=compute_dtype,
        output_uint8=True,
        device=args.device,
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
            out = stylizer.stylize_batch(batch).cpu().numpy()
            for f, img_out in zip(chunk, out):
                image_io.imwrite(out_dir / f"styled_{f.name}", img_out)
                done += 1
            print(f"{done}/{len(files)} done ({shape[1]}x{shape[0]})")
    return done


def main(argv=None):
    from faststyle_tpu_torch import full_float32

    full_float32()
    args = setup_parser().parse_args(argv)
    if args.spatial:
        raise SystemExit(_NOT_PORTED_SPATIAL)

    import torch

    from faststyle_tpu_torch.inference import Stylizer
    from faststyle_tpu_torch.utils import image_io

    dtype = torch.bfloat16 if args.precision == "bfloat16" else None
    if args.input_dir:
        return stylize_directory(args, dtype)
    if not args.input_img_path:
        raise SystemExit("need --input_img_path (or --input_dir)")

    stylizer = Stylizer(
        model_path=args.model_path,
        upsample_method=args.upsample_method,
        compute_dtype=dtype,
        device=args.device,
    )
    img = image_io.imresize(image_io.imread(args.input_img_path), args.content_target_resize)
    print("Evaluating...")
    out = stylizer(img)
    print("Saving image.")
    Path(args.output_img_path).parent.mkdir(parents=True, exist_ok=True)
    image_io.imwrite(args.output_img_path, out)
    print("Done.")
    return out


if __name__ == "__main__":
    main()
