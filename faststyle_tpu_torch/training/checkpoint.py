"""Checkpoint / resume for training state (counterpart of
faststyle_tpu/training/checkpoint.py).

`save` writes `<ckpt_dir>/step_<N>/state.npz` atomically: a temp dir,
fsync, then a rename, so a crash never leaves a published step dir with a
partial file; the newest `keep` step dirs are kept. The npz holds the net's
params in torch layouts, Adam's moments and the step, keyed by this port's
own scheme:

    params/<param name>      e.g. params/blocks.initconv_0.W
    opt/<param name>/<key>   Adam's exp_avg, exp_avg_sq, step
    step
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from faststyle_tpu_torch.training.train_step import TrainState

_STEP_RE = re.compile(r"step_(\d+)$")


class CheckpointMismatch(ValueError):
    """A readable checkpoint that doesn't fit the template (another model
    or config), not corruption, so restore_latest must not skip past it."""


def _flatten(state: TrainState) -> Dict[str, np.ndarray]:
    names = {id(p): n for n, p in state.net.named_parameters()}
    flat = {f"params/{n}": p.detach().cpu().numpy() for n, p in state.net.named_parameters()}
    for p, st in state.optimizer.state.items():
        for key, val in st.items():
            flat[f"opt/{names[id(p)]}/{key}"] = torch.as_tensor(val).detach().cpu().numpy()
    flat["step"] = np.asarray(state.step, np.int64)
    return flat


def save(ckpt_dir: str | Path, state: TrainState, *, keep: int = 5) -> Path:
    """Write `<ckpt_dir>/step_<N>/state.npz` and prune to the newest `keep`."""
    path = Path(ckpt_dir) / f"step_{state.step}"
    tmp = path.with_name(path.name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "state.npz", "wb") as f:
        np.savez(f, **_flatten(state))
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path, ignore_errors=True)
    try:
        tmp.rename(path)
    except OSError:
        # two trainers sharing training/<model_name> can race the rmtree above
        shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
    for old in sorted(all_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(Path(ckpt_dir) / f"step_{old}", ignore_errors=True)
    return path


def all_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = _STEP_RE.search(p.name)
        if m and p.is_dir():
            out.append(int(m.group(1)))
    return out


def _checked(data, key: str, like: torch.Tensor) -> torch.Tensor:
    if key not in data.files:
        raise CheckpointMismatch(f"checkpoint has no leaf {key}")
    arr = data[key]
    if arr.shape != tuple(like.shape):
        raise CheckpointMismatch(f"checkpoint leaf {key} shape {arr.shape} != template {tuple(like.shape)}")
    got = torch.from_numpy(arr)
    if got.dtype != like.dtype:
        raise CheckpointMismatch(f"checkpoint leaf {key} dtype {got.dtype} != template {like.dtype}")
    return got


def restore(ckpt_dir: str | Path, step: int, template: TrainState) -> TrainState:
    """Load step `step` into `template` (its net and optimizer, in place)."""
    with np.load(Path(ckpt_dir) / f"step_{step}" / "state.npz") as data:
        params = dict(template.net.named_parameters())
        loaded = {n: _checked(data, f"params/{n}", p) for n, p in params.items()}
        opt_state = {}
        for n, p in params.items():
            keys = [k for k in data.files if k.startswith(f"opt/{n}/")]
            if keys:
                opt_state[n] = {k.rsplit("/", 1)[1]: torch.from_numpy(data[k]) for k in keys}
                for k in ("exp_avg", "exp_avg_sq"):
                    _checked(data, f"opt/{n}/{k}", p)
        saved_step = int(data["step"])
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(loaded[n])
    sd = template.optimizer.state_dict()
    index = {n: i for i, n in enumerate(params)}  # optimizer order == parameter order
    sd["state"] = {index[n]: st for n, st in opt_state.items()}
    template.optimizer.load_state_dict(sd)
    template.step = saved_step
    return template


def restore_latest(ckpt_dir: str | Path, template: TrainState) -> Optional[TrainState]:
    """Restore the newest readable checkpoint; an unreadable newest dir
    (half-written, bit-rot) falls back to the next-oldest."""
    steps = sorted(all_steps(ckpt_dir), reverse=True)
    if not steps:
        return None
    last_err: Exception | None = None
    for step in steps:
        try:
            return restore(ckpt_dir, step, template)
        except CheckpointMismatch:
            raise  # wrong template/model, not corruption
        except Exception as e:  # unreadable npz: try the next-oldest
            print(f"[checkpoint] step_{step} unreadable ({e}); trying older")
            last_err = e
    raise RuntimeError(f"no readable checkpoint in {ckpt_dir}") from last_err
