#!/usr/bin/env python3
"""Generate a deterministic local training-image set (the port's copy of
tools/make_training_images.py: the same flags, draws and images).

    python -m faststyle_tpu_torch.tools.make_training_images OUTDIR [--num 400] [--size 256] [--seed 0]

The corpus stands in for MS-COCO where no dataset can be downloaded:
  - random crops / flips / rotations / colour jitters of the repo's
    shipped painting photos (tests/assets/candy.jpg and
    starry_night_crop.jpg); chicago is held out by default so it can serve
    as the held-out validation image of `distill_validation`;
  - procedural images: smooth random gradients, band-limited noise, random
    rectangles, for broad low- and high-frequency coverage.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from faststyle_tpu_torch.utils import image_io

REPO = Path(__file__).resolve().parents[2]


def _crop_aug(rng: np.random.Generator, img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    scale = rng.uniform(0.4, 1.0)
    ch = max(size // 4, int(min(h, w) * scale))
    y = rng.integers(0, max(1, h - ch))
    x = rng.integers(0, max(1, w - ch))
    crop = img[y : y + ch, x : x + ch]
    crop = image_io.resize_to(crop, size, size)
    if rng.random() < 0.5:
        crop = crop[:, ::-1]
    k = int(rng.integers(0, 4))
    crop = np.rot90(crop, k)
    gain = rng.uniform(0.6, 1.3, size=(1, 1, 3))
    bias = rng.uniform(-25, 25, size=(1, 1, 3))
    return np.clip(crop.astype(np.float32) * gain + bias, 0, 255)


def _procedural(rng: np.random.Generator, size: int) -> np.ndarray:
    kind = rng.integers(0, 3)
    if kind == 0:  # smooth gradient mixture
        yy, xx = np.mgrid[0:size, 0:size] / size
        img = np.zeros((size, size, 3), np.float32)
        for _ in range(3):
            a, b, c = rng.uniform(-1, 1, 3)
            phase = rng.uniform(0, 2 * np.pi)
            wave = np.sin(2 * np.pi * (a * yy + b * xx) * rng.uniform(0.5, 3) + phase)
            img += c * wave[..., None] * rng.uniform(0, 1, (1, 1, 3))
        return np.clip((img - img.min()) / (np.ptp(img) + 1e-6) * 255, 0, 255)
    if kind == 1:  # band-limited noise (upsampled coarse noise)
        coarse = rng.integers(4, 64)
        img = rng.uniform(0, 255, (coarse, coarse, 3)).astype(np.float32)
        return image_io.resize_to(img, size, size).astype(np.float32)
    img = np.full((size, size, 3), rng.uniform(0, 255, 3), np.float32)  # shapes
    for _ in range(rng.integers(3, 12)):
        color = rng.uniform(0, 255, 3)
        y0, x0 = rng.integers(0, size, 2)
        hh, ww = rng.integers(size // 16, size // 2, 2)
        img[y0 : y0 + hh, x0 : x0 + ww] = color
    return img


def setup_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Write a deterministic training-image corpus.")
    ap.add_argument("outdir")
    ap.add_argument("--num", type=int, default=400)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--include_chicago",
        action="store_true",
        help="include the held-out validation photo in the corpus",
    )
    return ap


def main(argv=None) -> Path:
    args = setup_parser().parse_args(argv)
    sources = [REPO / "tests/assets/candy.jpg", REPO / "tests/assets/starry_night_crop.jpg"]
    if args.include_chicago:
        sources.append(REPO / "tests/assets/chicago.jpg")
    imgs = [image_io.imread(p).astype(np.float32) for p in sources]

    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for i in range(args.num):
        if rng.random() < 0.6:
            img = _crop_aug(rng, imgs[int(rng.integers(0, len(imgs)))], args.size)
        else:
            img = _procedural(rng, args.size)
        # imwrite clips float input to [0, 255]; casting to uint8 first would
        # wrap cubic-resize overshoot (e.g. -12 -> 244) into speckles
        image_io.imwrite(out / f"img_{i:05d}.jpg", img)
    print(f"wrote {args.num} images to {out}")
    return out


if __name__ == "__main__":
    main()
