"""A training image as the recipe feeds it: the JPEG decoded to RGB (PIL,
a decoder apart from the program's) and resized bicubically (a = -0.75,
half-pixel centres, no antialiasing) to the preprocess size, rounded to
uint8, as float32."""

from __future__ import annotations

import io

import numpy as np
import torch
import torch.nn.functional as F


def decode_resize(jpeg: bytes, height: int, width: int) -> np.ndarray:
    """[height, width, 3] float32 in [0, 255], integer valued."""
    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
    x = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(height, width), mode="bicubic", align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).numpy()
