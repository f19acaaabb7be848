"""Conv-only VGG16 feature tower for the perceptual losses (counterpart of
faststyle_tpu/models/vgg16.py).

13 conv layers (3x3 s1 SAME, bias, relu) in 5 groups with 2x2 s2 SAME
max-pools, after ImageNet mean subtraction on 0-255 RGB (subtract only, no
scaling). `apply` stops after the deepest requested layer, so a loss on
conv4_3 never pays for block 5.

Params: `{'conv1_1': {'W': OIHW, 'b': [out]}, ...}` as torch tensors; the
Frossard `.npz` on disk is HWIO (`load_npz` converts). The JAX package's
space-to-depth `loss_layout` is a TPU matrix-unit trick whose losses are
exact permutations, so it is not ported.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from faststyle_tpu_torch import convert
from faststyle_tpu_torch.ops import layers as L

Params = Dict[str, Dict[str, torch.Tensor]]

# ImageNet channel means (reference libs/vgg16.py:41)
_MEAN_RGB = (123.68, 116.779, 103.939)

_GROUPS: Sequence[Sequence[str]] = (
    ("conv1_1", "conv1_2"),
    ("conv2_1", "conv2_2"),
    ("conv3_1", "conv3_2", "conv3_3"),
    ("conv4_1", "conv4_2", "conv4_3"),
    ("conv5_1", "conv5_2", "conv5_3"),
)
_CHANNELS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}

LAYER_ORDER: List[str] = []
for _gi, _group in enumerate(_GROUPS, start=1):
    LAYER_ORDER.extend(_group)
    LAYER_ORDER.append(f"pool{_gi}")


def layer_index(name: str) -> int:
    return LAYER_ORDER.index(name)


@functools.cache
def _mean_rgb(device: torch.device) -> torch.Tensor:
    # one host-to-device copy per device, not one per forward
    return torch.tensor(_MEAN_RGB, dtype=torch.float32, device=device)


def apply(
    params: Params,
    x: torch.Tensor,
    layers: Optional[Iterable[str]] = None,
    *,
    compute_dtype: torch.dtype | None = None,
) -> Dict[str, torch.Tensor]:
    """Run the tower on NHWC RGB [0, 255]; return {layer: NHWC activation}
    for the requested `layers` (None: every conv and pool)."""
    wanted = set(layers) if layers is not None else set(LAYER_ORDER)
    unknown = wanted - set(LAYER_ORDER)
    if unknown:
        raise ValueError(f"unknown VGG16 layers: {sorted(unknown)}")
    if not wanted:
        raise ValueError("no VGG16 layers requested")
    deepest = max(layer_index(name) for name in wanted)

    h = x.float() - _mean_rgb(x.device)
    if compute_dtype is not None:
        h = h.to(compute_dtype)
    acts: Dict[str, torch.Tensor] = {}
    for name in LAYER_ORDER[: deepest + 1]:
        if name.startswith("pool"):
            h = L.max_pool_2x2_same(h)
        else:
            p = params[name]
            h = L.relu(L.conv2d(h, p["W"], bias=p["b"]))
        if name in wanted:
            acts[name] = h
    return acts


def load_npz(path: str | Path, *, device: str | torch.device = "cuda") -> Params:
    """Load a Frossard-format `vgg16_weights.npz` (keys `conv1_1_W` /
    `conv1_1_b`, fc* ignored) as torch params on `device`."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as raw:
        for key in raw.files:
            if key.startswith("fc"):
                continue
            name, kind = key.rsplit("_", 1)
            if kind not in ("W", "b"):
                # an unknown suffix must not silently land as a bias
                raise ValueError(f"{path}: unrecognized weight key {key!r}")
            params.setdefault(name, {})[kind] = raw[key]
    missing = [n for g in _GROUPS for n in g if n not in params]
    if missing:
        raise ValueError(f"{path} missing VGG16 layers: {missing}")
    return convert.params_from_numpy(params, device=device)


def init_params(generator: torch.Generator, *, device: str | torch.device = "cuda") -> Params:
    """Random init with the reference's truncated-normal(0.1) / zero-bias
    scheme, drawn on the CPU from `generator`. For tests and the smoke run:
    perceptual losses need the pretrained weights to be meaningful."""
    params: Params = {}
    cin = 3
    for gi, group in enumerate(_GROUPS, start=1):
        cout = _CHANNELS[gi]
        for name in group:
            w = torch.empty(cout, cin, 3, 3)
            torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
            params[name] = {"W": (w * 0.1).to(device), "b": torch.zeros(cout, device=device)}
            cin = cout
    return params
