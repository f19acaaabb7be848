"""Video-like images from a seed, made on the device in a few large calls.

Each image is two random fields, bicubically upsampled from cells of
`coarse_px` and `mid_px` pixels, plus Gaussian texture of `texture` counts:
smooth regions and edges as in camera frames, not white noise, and the
same work for every seed.
"""

from __future__ import annotations


def smooth_fields(n: int, h: int, w: int, content: dict, seed: int, device, chunk: int = 4):
    """[n, h, w, 3] uint8 RGB on `device`."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        img = torch.zeros((m, 3, h, w), device=device)
        for px, weight in ((content["coarse_px"], 0.7), (content["mid_px"], 0.3)):
            cells = torch.rand((m, 3, h // px + 2, w // px + 2), generator=gen, device=device)
            img += weight * F.interpolate(cells, size=(h, w), mode="bicubic", align_corners=False)
        img = img * 255.0 + content["texture"] * torch.randn((m, 3, h, w), generator=gen, device=device)
        out[i : i + m] = img.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1)
    return out
