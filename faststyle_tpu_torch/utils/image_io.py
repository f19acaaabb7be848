"""Image I/O with an RGB contract (the port's own copy of
faststyle_tpu/utils/image_io.py).

BGR<->RGB conversion at the boundary, cubic interpolation for upscales and
area interpolation for downscales. cv2 is optional; PIL is the fallback.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    import cv2

    _HAVE_CV2 = True
except Exception:  # pragma: no cover - depends on environment
    cv2 = None
    _HAVE_CV2 = False


def imread(path: str | Path) -> np.ndarray:
    """Read an image file as an RGB uint8 HWC array."""
    path = str(path)
    if _HAVE_CV2:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def imresize(img: np.ndarray, scale: float) -> np.ndarray:
    """Scale both axes by `scale`: cubic when upscaling, area when
    downscaling, identity at 1.0."""
    if scale == 1.0:
        return img
    if _HAVE_CV2:
        interp = cv2.INTER_CUBIC if scale > 1.0 else cv2.INTER_AREA
        return cv2.resize(img, None, interpolation=interp, fx=scale, fy=scale)
    from PIL import Image

    h, w = img.shape[:2]
    new_w, new_h = round(w * scale), round(h * scale)
    resample = Image.BICUBIC if scale > 1.0 else Image.BOX
    return np.asarray(Image.fromarray(img).resize((new_w, new_h), resample))


def imwrite(path: str | Path, img: np.ndarray) -> None:
    """Write an RGB array; float inputs are clipped to [0, 255] and cast."""
    path = str(path)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if _HAVE_CV2:
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        return
    from PIL import Image

    Image.fromarray(img).save(path)


def resize_to(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize to an exact (height, width), scale-aware interpolation."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    if _HAVE_CV2:
        interp = cv2.INTER_CUBIC if height * width > h * w else cv2.INTER_AREA
        return cv2.resize(img, (width, height), interpolation=interp)
    from PIL import Image

    resample = Image.BICUBIC if height * width > h * w else Image.BOX
    return np.asarray(Image.fromarray(img).resize((width, height), resample))
