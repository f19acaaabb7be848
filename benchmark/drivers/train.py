"""Perceptual-loss training through the port's training path.

The entry the window drives is what `cli/train.py` composes:
`data.pipeline.Batcher` over TFRecord shards (decode and bicubic resize on
the Batcher's threads, a shuffle buffer), `data.pipeline.device_prefetch`,
and `training.train_step.make_train_step`'s step, with the loss fetched
deferred every `log_every` steps as `training.loop.train` does.

Set-up: the corpus (written once per checkout), VGG16's weights and the
transform net's initial weights (made on the device from the seed, with
the recipe's init distributions), the style image, the program's style
Grams, train state, step and input pipeline, and the first
`checked_steps` steps through the window's own call and feed. They warm
every shape, and the benchmark keeps their batches, losses, the initial
weights, Adam's first moment after step 1 (the first gradient times
1 - beta1) and the weights after the last of them. The window continues
the same state for `seconds` and ends in a synchronize. Inside it the
benchmark keeps, with device copies that cost the host well under a
millisecond, every `signature_every`-th batch's colour signature and one
whole step at a moment drawn from the seed: its batch, the weights and
Adam's first moment before it, and the moment after it (whose difference
gives the step's gradient).

After the window the plain reference checks what was kept: the batch rows
against its own JPEG decode and resize of the corpus images they came from
(found by their colour signatures); that the checked steps' rows are
distinct, shuffled and that no sampled batch of the window repeats an
earlier one; the window's sampled signatures against the corpus; the
checked steps again from the same initial weights on the same rows (the
first step's loss, the first gradient and the change after the last step,
of the median leaf and of the worst conv kernel); and the kept window step
from the program's weights before it (its loss and gradient).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark import corpus as corpus_lib
from benchmark.harness import Record, derive_seed
from benchmark.reference import decode as ref_decode
from benchmark.reference import training as ref_training


def make_vgg(config: dict, seed: int, device) -> dict:
    """VGG16's convs (He-scaled normal kernels, small normal biases) in one
    draw on the device: {'conv1_1': {'W': OIHW, 'b': [co]}, ...}."""
    import torch

    shapes, ci = [], 3
    for gi, (co, depth) in enumerate(config["vgg16"]["groups"], start=1):
        for j in range(1, depth + 1):
            shapes.append((f"conv{gi}_{j}", co, ci))
            ci = co
    sizes = [co * ci * 9 + co for _, co, ci in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "vgg16"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, co, ci), size in zip(shapes, sizes):
        w = flat[at : at + co * ci * 9].view(co, ci, 3, 3) * math.sqrt(2.0 / (9 * ci))
        b = flat[at + co * ci * 9 : at + size] * 0.01
        out[name] = {"W": w.contiguous(), "b": b.contiguous()}
        at += size
    return out


def make_init(config: dict, seed: int, device) -> dict:
    """The transform net's initial weights with the recipe's distributions
    (conv kernels N(0, 0.1^2), the resize-convs N(0, 1), instance-norm scale
    1 and shift 0), in one draw on the device; OIHW kernels under the
    npz's '<block>/<var>' names."""
    import torch

    model, std = config["model"], config["model"]["init_stddev"]
    kernels = []  # (block, var, shape, stddev)
    for i, (k, ci, co, _s) in enumerate(model["init"]):
        kernels.append((f"initconv_{i}", "", (co, ci, k, k), std["conv"]))
    width = model["resblock_width"]
    for i in range(model["resblocks"]):
        for j in ("1", "2"):
            kernels.append((f"resblock_{i}", j, (width, width, 3, 3), std["conv"]))
    for i, (k, ci, co) in enumerate(model["upsample"]):
        kernels.append((f"upsample_{i}", "", (co, ci, k, k), std["upsample"]))
    k, ci, co = model["final"]
    kernels.append((f"upsample_{len(model['upsample'])}", "", (co, ci, k, k), std["conv"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "transform_net"))
    flat = torch.randn(sum(math.prod(s) for _, _, s, _ in kernels), generator=gen, device=device)
    params, at = {}, 0
    for blk, j, shape, stddev in kernels:
        n = math.prod(shape)
        sub = params.setdefault(blk, {})
        sub["W" + j] = (flat[at : at + n].view(shape) * stddev).contiguous()
        sub["INscale" + j] = torch.ones(shape[0], device=device)
        sub["INshift" + j] = torch.zeros(shape[0], device=device)
        at += n
    return params


def load_style(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


@dataclass
class Kept:
    """What the checked steps leave for the reference."""

    batches: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    params0: dict | None = None
    moment1: dict | None = None
    params_last: dict | None = None


@dataclass
class WindowStep:
    """One step of the window: its batch, the weights and Adam's first
    moment before it, the gradient it gave Adam and its loss."""

    index: int
    batch: object
    params: dict
    moment: dict
    grad: dict
    loss: float


@dataclass
class ProgramRun:
    """A run of the program: set-up, the checked steps and the window."""

    corpus: object
    inputs: dict
    kept: Kept
    window_step: WindowStep
    signatures: np.ndarray  # [sampled batches, batch, GRID, GRID, 3]
    steps: int
    bad: int
    seconds: float
    t0: float
    peak: int


def _leaves(net) -> dict:
    return {tuple(name.split(".")[1:]): p for name, p in net.named_parameters()}


def conv_leaves(keys) -> list:
    """The conv kernels among the transform net's leaves (the `W` variables;
    the rest are instance norm's scales and shifts)."""
    return [k for k in keys if k[1].startswith("W")]


def setup(ctx):
    """(the corpus, the benchmark's inputs, the program's state, step and
    batches)."""
    import torch

    from faststyle_tpu_torch import full_float32
    from faststyle_tpu_torch.data import pipeline
    from faststyle_tpu_torch.training import slow_style, train_step

    ctx.phase("imports")
    full_float32()
    cfg, tr = ctx.config, ctx.traffic
    corpus = corpus_lib.ensure(ctx.bench.root, tr["corpus"], cfg["train_images"], ctx.device)
    ctx.phase("corpus")
    inputs = {
        "vgg": make_vgg(cfg, ctx.seed, ctx.device),
        "params0": make_init(cfg, ctx.seed, ctx.device),
        "style": load_style(ctx.bench.path(cfg["style_image"])),
    }
    ctx.phase("inputs")
    if ctx.device.type == "cuda":  # the peak from here on is the program's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    loss = cfg["loss"]
    config = train_step.TrainConfig.make(
        content_layers=tuple(loss["content_layers"]),
        content_weights=tuple(loss["content_layers"].values()),
        style_layers=tuple(loss["style_layers"]),
        style_weights=tuple(loss["style_layers"].values()),
        beta=loss["beta"],
        learn_rate=cfg["optimizer"]["learn_rate"],
        upsample_method=cfg["model"]["upsample_method"],
        compute_dtype=torch.bfloat16 if cfg["precision"] == "bfloat16" else None,
    )
    grams = slow_style.style_target_grams(inputs["vgg"], inputs["style"].astype(np.float32)[None],
                                          tuple(loss["style_layers"]))
    ctx.phase("grams")
    state = train_step.init_state(config, params=inputs["params0"], device=ctx.device)
    step_fn = train_step.make_train_step(inputs["vgg"], grams, config)
    size = cfg["preprocess_size"]
    batcher = pipeline.Batcher(corpus.files, batch_size=tr["batch_size"], resize_shape=tuple(size),
                               n_epochs=cfg["n_epochs"], min_after_dequeue=cfg["num_pipe_buffer"],
                               num_decode_threads=tr["decode_threads"], seed=derive_seed(ctx.seed, "batcher"))
    batches = pipeline.device_prefetch(iter(batcher), depth=tr["prefetch_depth"], device=ctx.device)
    ctx.phase("program")
    return corpus, inputs, state, step_fn, batches


def checked_steps(ctx, state, step_fn, batches) -> Kept:
    """The first steps, through the window's call and feed, with what the
    reference needs of them."""
    beta1 = ctx.config["optimizer"]["beta1"]
    kept = Kept()
    leaves = _leaves(state.net)
    kept.params0 = {k: p.detach().clone() for k, p in leaves.items()}
    for t in range(ctx.traffic["checked_steps"]):
        batch = next(batches)
        kept.batches.append(batch.clone())
        state, parts = step_fn(state, batch)
        kept.losses.append(parts["loss"])
        if t == 0:
            kept.moment1 = {k: state.optimizer.state[p]["exp_avg"] / (1 - beta1) for k, p in leaves.items()}
    kept.params_last = {k: p.detach().clone() for k, p in leaves.items()}
    kept.losses = [float(v) for v in kept.losses]
    ctx.phase("checked_steps")
    return kept


def signature(batch):
    """[n, h, w, 3] rows -> [n, GRID, GRID, 3] mean colours, on the batch's
    device (the corpus's `grid_means`)."""
    n, h, w, c = batch.shape
    g = corpus_lib.GRID
    return batch.reshape(n, g, h // g, g, w // g, c).mean(dim=(2, 4))


def window(ctx, state, step_fn, batches):
    """Steps for `seconds`: (steps, steps with a non-finite loss, window s,
    start, the kept step, the sampled signatures). The window runs on past
    `seconds` only until it has kept its step (never, at the cells' sizes)."""
    import torch

    spans, tracer, tr = ctx.spans, ctx.tracer, ctx.traffic
    every, sig_every, beta1 = tr["log_every"], tr["signature_every"], ctx.config["optimizer"]["beta1"]
    keep_at = (0.2 + 0.6 * (derive_seed(ctx.seed, "window_step") % 1_000_003) / 1_000_003) * ctx.seconds
    steps = bad = 0
    pending = kept = None
    sigs = []

    def fetch_loss():
        nonlocal bad
        with spans.span("bench.loss_fetch"):
            bad += not math.isfinite(float(pending))

    def moments(leaves):
        return {k: state.optimizer.state[p]["exp_avg"].clone() for k, p in leaves.items()}

    ctx.prepare_trace()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        ctx.tick(elapsed)
        if elapsed >= ctx.seconds and kept is not None:
            break
        with spans.span("bench.batch_wait"):
            batch = next(batches)
        keep = kept is None and elapsed >= keep_at
        if keep:
            with spans.span("bench.keep"):
                leaves = _leaves(state.net)
                before = ({k: p.detach().clone() for k, p in leaves.items()}, moments(leaves), batch.clone())
        with spans.span("bench.step"):
            state, parts = step_fn(state, batch)
        if keep:
            with spans.span("bench.keep"):
                after = moments(leaves)
                grad = {k: (after[k] - beta1 * before[1][k]) / (1 - beta1) for k in after}
                kept = WindowStep(steps, before[2], before[0], before[1], grad, parts["loss"])
        if steps % sig_every == 0:
            sigs.append(signature(batch))
        steps += 1
        if steps % every == 0:
            if pending is not None:
                fetch_loss()
            pending = parts["loss"]
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if tracer.active:
        tracer.stop()
    if pending is not None:
        fetch_loss()
    kept.loss = float(kept.loss)
    return steps, bad, seconds, t0, kept, torch.stack(sigs).cpu().numpy()


def program(ctx) -> ProgramRun:
    """Set-up, the checked steps and the window; the program's state freed
    after the memory peak is read."""
    import torch

    corpus, inputs, state, step_fn, batches = setup(ctx)
    kept = checked_steps(ctx, state, step_fn, batches)
    steps, bad, seconds, t0, window_step, sigs = window(ctx, state, step_fn, batches)
    batches.close()  # stops the prefetch thread and the decode pool
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del state, step_fn, batches
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return ProgramRun(corpus, inputs, kept, window_step, sigs, steps, bad, seconds, t0, peak)


def match(corpus, sigs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per row signature ([n, GRID, GRID, 3]): the nearest corpus image and
    the root-mean-square distance to its signature, in counts."""
    nearest, dist = [], []
    for i in range(0, len(sigs), 64):
        d2 = ((sigs[i : i + 64, None] - corpus.signatures[None]) ** 2).mean(axis=(2, 3, 4))
        nearest.append(d2.argmin(axis=1))
        dist.append(np.sqrt(d2.min(axis=1)))
    return np.concatenate(nearest), np.concatenate(dist)


def check_batches(batches, corpus, size) -> tuple[float, np.ndarray]:
    """The largest difference, in counts, between a batch row and the
    reference's decode and resize of the corpus image it came from, and the
    rows' corpus indices."""
    rows = np.concatenate([b.cpu().numpy() for b in batches])
    index, _ = match(corpus, corpus_lib.grid_means(rows))
    worst = 0.0
    for row, i in zip(rows, index):
        ref = ref_decode.decode_resize(corpus.jpeg(int(i)), *size)
        worst = max(worst, float(np.abs(row - ref).max()))
    return worst, index


def rows_repeated(checked: np.ndarray, batch_size: int, window_index: np.ndarray) -> int:
    """Rows of the checked steps that repeat an earlier one (the first epoch
    has each image once), plus the rows of sampled window batches whose
    images, as a set, are those of an earlier checked or sampled batch."""
    repeats = len(checked) - len(set(checked.tolist()))
    seen = {frozenset(checked[i : i + batch_size].tolist()) for i in range(0, len(checked), batch_size)}
    for rows in window_index:
        key = frozenset(rows.tolist())
        repeats += len(rows) * (key in seen)
        seen.add(key)
    return repeats


def rows_in_file_order(checked: np.ndarray) -> int:
    """Pairs of successive checked rows that are successive images of one
    shard: a shuffled stream has few, an unshuffled one nearly all."""
    return int(np.sum(np.diff(checked) == 1))


def batch_numbers(run: ProgramRun, size, batch_size: int) -> dict:
    n_checked = len(run.kept.batches)
    worst, index = check_batches(run.kept.batches + [run.window_step.batch], run.corpus, size)
    checked = index[: n_checked * batch_size]
    sigs = run.signatures
    window_index, dist = match(run.corpus, sigs.reshape(-1, *sigs.shape[2:]))
    return {
        "batch_err_max": worst,
        "rows_repeated": float(rows_repeated(checked, batch_size, window_index.reshape(sigs.shape[:2]))),
        "rows_in_file_order": float(rows_in_file_order(checked)),
        "window_sig_gap_max": float(dist.max()),
    }


def leaf_gaps(program: dict, reference: dict, keys=None) -> dict:
    """Per leaf, the gap between the program's norm and the reference's,
    against the larger of the reference leaf's norm and the median leaf's."""
    keys = list(reference) if keys is None else list(keys)
    ref = {k: float(reference[k].norm()) for k in keys}
    median = float(np.median(list(ref.values())))
    return {k: abs(float(program[k].norm()) - ref[k]) / max(ref[k], median) for k in keys}


def reference_steps(ctx, kept: Kept, inputs: dict, precision: str = "float32", half_batch: bool = False):
    """The reference's steps on the kept batches from the benchmark's
    initial weights: (losses, first gradients, weights after the last)."""
    return ref_training.train_steps(inputs["params0"], inputs["vgg"], inputs["style"], kept.batches, ctx.config,
                                    ctx.device, precision, half_batch)


def reference_window_step(ctx, step: WindowStep, inputs: dict, precision: str = "float32", half_batch: bool = False):
    """The reference's loss and gradients at the kept window step, from the
    program's weights before it: (loss, gradients)."""
    return ref_training.loss_and_grads(step.params, inputs["vgg"], inputs["style"], step.batch, ctx.config,
                                       ctx.device, precision, half_batch)


def gaps(steps, reference, params0: dict) -> dict:
    """The step numbers of `steps` (losses, first gradients, weights after
    the last step) against the reference's: the first step's relative loss
    gap, and the gaps of norms of the first gradient and of the weights'
    change after the last step, of the median leaf and of the worst conv
    kernel. (Adam's steps turn round-off in near-zero gradients into whole
    updates of the other sign, so the later steps' losses and a small
    instance-norm leaf's change swing from seed to seed, and so does a
    small leaf's gradient, a sum with much cancelling; the first step's
    loss, the median leaf and the conv kernels, thousands of elements each,
    do not. A fault that stays inside the kernels' gradients, as one of
    conv_wgrad's would, moves at most 16 of the 48 leaves and not the
    median: the conv numbers see it.)"""
    losses, grad1, params_last = steps
    ref_losses, ref_grad1, ref_last = reference
    ref_change = {k: ref_last[k] - params0[k] for k in ref_last}
    change = {k: params_last[k] - params0[k] for k in ref_last}
    # leaves that no gradient moves in the reference move under Adam by round-off alone
    norms = {k: float(g.norm()) for k, g in ref_grad1.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    moved = [k for k, n in norms.items() if n >= floor]
    g = leaf_gaps(grad1, ref_grad1)
    u = leaf_gaps(change, ref_change, moved)
    return {
        "loss1_gap": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        "grad1_median_gap": float(np.median(list(g.values()))),
        "grad1_conv_worst_gap": max(g[k] for k in conv_leaves(g)),
        "update3_median_gap": float(np.median(list(u.values()))),
        "update3_conv_worst_gap": max(u[k] for k in conv_leaves(u)),
    }


def window_gaps(step: WindowStep, reference) -> dict:
    """The kept window step against the reference's loss and gradients at
    the same weights and batch: the relative loss gap, and the gradient's
    gaps of norms of the median leaf and of the worst conv kernel."""
    ref_loss, ref_grads = reference
    g = leaf_gaps(step.grad, ref_grads)
    return {
        "window_loss_gap": abs(step.loss - ref_loss) / abs(ref_loss),
        "window_grad_median_gap": float(np.median(list(g.values()))),
        "window_grad_conv_worst_gap": max(g[k] for k in conv_leaves(g)),
    }


def numbers(ctx, run: ProgramRun) -> dict:
    """Every number that decides `correct`."""
    out = batch_numbers(run, ctx.config["preprocess_size"], ctx.traffic["batch_size"])
    kept = run.kept
    out.update(gaps((kept.losses, kept.moment1, kept.params_last), reference_steps(ctx, kept, run.inputs),
                    kept.params0))
    out.update(window_gaps(run.window_step, reference_window_step(ctx, run.window_step, run.inputs)))
    return out


def run(ctx) -> Record:
    prog = program(ctx)
    limits = ctx.traffic["limits"]
    checks = numbers(ctx, prog)
    return Record(
        setup_s=prog.t0 - ctx.started,
        window_s=prog.seconds,
        attempted=prog.steps,
        failed=prog.bad,
        counters={"steps": prog.steps, "images": prog.steps * ctx.traffic["batch_size"]},
        checks={name: (value, limits[name]) for name, value in checks.items()},
        memory_peak_bytes=prog.peak,
        spans=ctx.spans,
        trace=ctx.tracer.data,
        setup_phases=ctx.phases,
    )
