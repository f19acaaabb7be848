"""Transform-net weights on disk (counterpart of the params half of
faststyle_tpu/inference.py; the Stylizer is the serving slice).

The container is the JAX package's flat `.npz`: keys `'<block>/<var>'`,
conv kernels HWIO (transposed-conv kernels HWOI), so either package loads
what the other saves. TF1 checkpoint prefixes are the serving slice's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from faststyle_tpu_torch import convert
from faststyle_tpu_torch.models.transform_net import Params


def load_params(model_path: str | Path, *, device: str | torch.device = "cuda") -> Params:
    """Load transform-net params from a `.npz` (a `.ckpt` name or a bare
    stem resolves to the `.npz` beside it) as torch params on `device`."""
    model_path = Path(model_path)
    candidates = [model_path]
    if model_path.suffix == ".ckpt":
        candidates.append(model_path.with_suffix(".npz"))
    elif model_path.suffix != ".npz":
        candidates.append(model_path.with_name(model_path.name + ".npz"))
    for cand in candidates:
        if cand.suffix == ".npz" and cand.exists():
            params: Dict[str, Dict[str, np.ndarray]] = {}
            with np.load(cand) as flat:
                for key in flat.files:
                    blk, var = key.split("/")
                    params.setdefault(blk, {})[var] = flat[key]
            return convert.params_from_numpy(params, device=device)
    raise FileNotFoundError(f"no model found at {model_path} (.npz)")


def save_params(model_path: str | Path, params: Params) -> None:
    """Save torch params as the flat HWIO `.npz` container."""
    flat = {
        f"{blk}/{var}": arr
        for blk, sub in convert.params_to_numpy(params).items()
        for var, arr in sub.items()
    }
    np.savez(model_path, **flat)
