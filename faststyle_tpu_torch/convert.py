"""Weights between the repo's file layout and torch's.

Files (`weights/*.npz`, the VGG16 `.npz`, what `inference.save_params`
writes) keep the JAX package's layouts: conv kernels HWIO, transposed-conv
kernels HWOI. Torch convolutions want OIHW (`F.conv2d`) and IOHW
(`F.conv_transpose2d`). Both conversions are the same axis permutation
(H, W, A, B) -> (B, A, H, W), so one pair of functions serves the transform
net (either upsample variant) and the VGG tower; 1-D leaves (biases,
instance-norm affines) pass through.

Params are nested dicts `{block: {var: array}}` on both sides.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

Params = Dict[str, Dict[str, torch.Tensor]]

_TO_TORCH = (3, 2, 0, 1)  # HWIO -> OIHW, HWOI -> IOHW
_TO_FILE = (2, 3, 1, 0)  # the inverse


def kernel_to_torch(w: np.ndarray | torch.Tensor) -> torch.Tensor:
    """One 4-D file-layout kernel -> its torch layout (a contiguous copy)."""
    return torch.tensor(np.asarray(w)).permute(*_TO_TORCH).contiguous()


def kernel_to_file(w: torch.Tensor) -> np.ndarray:
    """One 4-D torch-layout kernel -> its file layout, as numpy."""
    return np.ascontiguousarray(w.detach().cpu().permute(*_TO_FILE).numpy())


def params_from_numpy(
    np_params: Mapping[str, Mapping[str, np.ndarray]], *, device: str | torch.device = "cuda"
) -> Params:
    """`{block: {var: HWIO/HWOI or 1-D numpy}}` -> float32 torch params in
    torch layouts on `device`."""
    out: Params = {}
    for blk, sub in np_params.items():
        out[blk] = {}
        for var, arr in sub.items():
            arr = np.asarray(arr, np.float32)
            t = kernel_to_torch(arr) if arr.ndim == 4 else torch.from_numpy(arr.copy())
            out[blk][var] = t.to(device)
    return out


def params_to_numpy(params: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """Torch params -> `{block: {var: numpy}}` in the file layouts."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for blk, sub in params.items():
        out[blk] = {}
        for var, t in sub.items():
            out[blk][var] = (
                kernel_to_file(t) if t.ndim == 4 else t.detach().cpu().numpy().copy()
            )
    return out
