"""Training loop: style targets once, then the step over the input pipeline,
with periodic checkpoints, CSV metrics, resume and a final weights-only
save (counterpart of faststyle_tpu/training/loop.py). Optional: NaN
checking (`debug_nans`) and data parallelism over torch.distributed (`dp`),
under which only rank 0 writes files and prints."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from faststyle_tpu_torch import inference, resolve_device
from faststyle_tpu_torch.models import vgg16
from faststyle_tpu_torch.parallel.mesh import DataMesh
from faststyle_tpu_torch.training import checkpoint as ckpt_lib
from faststyle_tpu_torch.training import slow_style
from faststyle_tpu_torch.training.train_step import (
    TrainConfig,
    TrainState,
    init_state,
    make_train_step,
)
from faststyle_tpu_torch.utils.logging import MetricsLogger, unique_run_name

StepFn = Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]


def nan_checked(step_fn: StepFn, *, anomaly: bool = True) -> StepFn:
    """`step_fn` that raises FloatingPointError, naming the step, on the
    first NaN (the counterpart of `jax_debug_nans`). With `anomaly`, the
    step runs under autograd's anomaly detection, which names the forward
    op of a NaN that reaches the backward; after it, every loss part must
    be finite, which catches a NaN in the forward. That check syncs the
    device every step. A data-parallel step runs without anomaly
    detection: a rank that raised inside its backward would leave the
    others waiting in the all-reduce, while the all-reduced loss parts are
    non-finite on every rank at once, so all ranks raise at the same step."""

    def checked(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        step = state.step + 1
        try:
            with torch.autograd.set_detect_anomaly(anomaly):
                state, parts = step_fn(state, batch)
        except RuntimeError as e:
            if "returned nan values" not in str(e):
                raise
            raise FloatingPointError(f"step {step}: {e}") from e
        bad = {k: float(v) for k, v in parts.items() if not bool(torch.isfinite(v).all())}
        if bad:
            raise FloatingPointError(f"step {step}: non-finite loss parts {bad}")
        return state, parts

    return checked


def train(
    *,
    vgg_params: vgg16.Params,
    style_img: np.ndarray,
    batches: Iterable,
    config: TrainConfig,
    model_name: str = "model",
    seed: int = 0,
    num_steps_ckpt: int = 1000,
    num_steps_break: int = -1,
    log_every: int = 10,
    train_root: str | Path = "training",
    models_root: str | Path = "models",
    summaries_root: str | Path = "summaries/train",
    run_name: Optional[str] = None,
    resume: bool = False,
    logger: Optional[MetricsLogger] = None,
    device: str | torch.device = "cuda",
    debug_nans: bool = False,
    dp: Optional[DataMesh] = None,
) -> TrainState:
    """Run perceptual-loss training on `device`; returns the final state.

    `batches` yields NHWC float32 [0, 255] batches: numpy arrays or tensors
    (data.pipeline.device_prefetch hands over tensors already on the device).
    `vgg_params` must already live on `device`. `debug_nans` wraps the step
    in `nan_checked`. With `dp`, `batches` yields this rank's rows of each
    global batch, the step all-reduces the gradients over the default
    process group (`parallel.data_parallel`), and only rank 0 logs,
    checkpoints and saves the final weights.
    """
    device = resolve_device(device)
    lead = dp is None or dp.rank == 0
    say = print if lead else (lambda *args: None)
    style_layers = tuple(dict(config.style_weights))
    target_grams = slow_style.style_target_grams(
        vgg_params, np.asarray(style_img, np.float32)[None], style_layers
    )

    state = init_state(config, seed=seed, device=device)
    ckpt_dir = Path(train_root) / model_name
    if resume:
        restored = ckpt_lib.restore_latest(ckpt_dir, state)
        if restored is not None:
            state = restored
            say(f"[train] resumed from step {state.step}")

    if dp is not None:
        from faststyle_tpu_torch.parallel import data_parallel

        step_fn = data_parallel.make_dp_train_step(vgg_params, target_grams, config)
    else:
        step_fn = make_train_step(vgg_params, target_grams, config)
    if debug_nans:
        step_fn = nan_checked(step_fn, anomaly=dp is None)
    if logger is None and lead:
        logger = MetricsLogger(summaries_root, run_name or unique_run_name(summaries_root, model_name))

    # Deferred metric fetch: float() of a CUDA scalar waits for the step that
    # produced it, so a log tick holds the metrics and converts them at the
    # NEXT tick, when they are long computed. Each row keeps the timestamp of
    # its own tick, so steps_per_sec measures tick-to-tick intervals.
    pending: Optional[tuple] = None

    def flush_pending():
        nonlocal pending
        if pending is not None:
            p_step, p_metrics, p_time = pending
            logger.log(p_step, {k: float(v) for k, v in p_metrics.items()}, at_time=p_time)
            pending = None

    try:
        for batch in batches:
            if num_steps_break >= 0 and state.step >= num_steps_break:
                say("Done training.")
                break
            state, metrics = step_fn(state, batch)
            if not lead:
                continue
            if num_steps_ckpt > 0 and state.step % num_steps_ckpt == 0:
                # saving syncs anyway: log directly, stamped before the save
                flush_pending()
                tick = time.perf_counter()
                ckpt_lib.save(ckpt_dir, state)
                logger.log(state.step, {k: float(v) for k, v in metrics.items()}, at_time=tick)
            elif log_every > 0 and state.step % log_every == 0:
                flush_pending()
                pending = (state.step, metrics, time.perf_counter())
        else:
            say("Done training (epochs exhausted).")
        if lead:
            flush_pending()
            # final weights only on a clean finish: a crashed run must not
            # overwrite a good <model>_final.npz (the checkpoints are the recovery)
            models_root = Path(models_root)
            models_root.mkdir(parents=True, exist_ok=True)
            final = models_root / f"{model_name}_final.npz"
            inference.save_params(final, state.net.params())
            print(f"[train] final weights -> {final}")
    finally:
        if logger is not None:
            logger.close()
    return state
