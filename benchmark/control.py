"""The readings that the limits of `correct` are set from, on the card at a
cell's own size (not run by the benchmark's runs).

    python3 -m benchmark.control --workload stylize_4k_d4 --seeds 1-12 --control_seeds 1-3 --seconds 3

For each seed of `--seeds`, the program's numbers from a sound run (the
lower readings), each run over a short window at the cell's own load: the
stream cells with a sample as large as a run's, the training cell with its
checked steps, its sampled window batches and its kept window step. For
each seed of `--control_seeds`, the control's numbers: the reference put in
the program's place at the nearest precision below the configuration's
(for the bf16 stream: the whole net in float8 e4m3, and bf16 convolutions
with instance norm's statistics in bf16 below the configuration's float32;
for the float32 training: TF32), and the planted faults. For the stream
cells: a frame altered where it is produced (flipped). For the training
cell: half of the batch left out with the loss doubled over the rest; the
batch rows altered where they are produced (flipped); a step that leaves
its state unchanged; the Batcher without its shuffle; and every weight
gradient that the port's conv_wgrad kernel computes returned as zeros, in
a whole run of the program. One JSON line per reading, then a summary: per
number the largest sound reading and the smallest control or fault
reading.
"""

import time

_AT_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import corpus as corpus_lib  # noqa: E402
from benchmark.harness import Context, derive_seed  # noqa: E402
from benchmark.run import ROOT, _fix_cache_dirs  # noqa: E402
from benchmark.spec import Bench  # noqa: E402


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def stream_readings(ctx_for, seeds, control_seeds, seconds):
    import numpy as np

    from benchmark.reference import transform_net as reference

    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = ctx_for(seed)
        driver = ctx.bench.driver(ctx.config["driver"])
        frames, stylizer = driver.setup(ctx)
        tr = ctx.traffic
        sample = driver.Sample(tr["check_frames"], derive_seed(seed, "sample"), seconds, (tr["height"], tr["width"], 3))
        driver.stream(ctx, frames, stylizer, seconds, sample)
        del stylizer
        params = reference.load_npz(ctx.bench.path(ctx.config["weights"]), ctx.device)
        kept = sample.kept
        model = ctx.config["model"]
        if seed in seeds:
            yield seed, "program", driver.compare(kept, frames, params, model, ctx.device), len(kept)
        if seed in control_seeds:
            sources = sorted({src for src, _ in kept})
            control = [(src, reference.stylize_u8(params, frames[src], model, ctx.device, "float8")) for src in sources]
            yield seed, "control_float8", driver.compare(control, frames, params, model, ctx.device), len(control)
            control = [(src, reference.stylize_u8(params, frames[src], model, ctx.device, "bfloat16", "bfloat16"))
                       for src in sources]
            yield seed, "control_bf16_stats", driver.compare(control, frames, params, model, ctx.device), len(control)
            altered = [(src, np.ascontiguousarray(out[::-1])) for src, out in kept]
            yield seed, "fault_frame_altered", driver.compare(altered, frames, params, model, ctx.device), len(kept)


def look(driver, seed, run, reference) -> None:
    """The leaves behind the step numbers: the worst three leaves of each
    gap with their sizes and the reference's norms, and each step's loss
    gap (standard error)."""
    import numpy as np

    kept = run.kept
    losses, grad1, last = reference
    change = {k: last[k] - kept.params0[k] for k in last}
    prog_change = {k: kept.params_last[k] - kept.params0[k] for k in last}
    g = driver.leaf_gaps(kept.moment1, grad1)
    u = driver.leaf_gaps(prog_change, change)
    worst = lambda d, ref: [[".".join(k), ref[k].numel(), v, float(ref[k].norm())]  # noqa: E731
                            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:3]]
    conv = driver.conv_leaves(g)
    print(json.dumps({"seed": seed, "look": {
        "step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(kept.losses, losses)],
        "grad1_worst": worst(g, grad1), "update3_worst": worst(u, change),
        "grad1_conv": worst({k: g[k] for k in conv}, grad1), "update3_conv": worst({k: u[k] for k in conv}, change),
        "grad1_conv_median_gap": float(np.median([g[k] for k in conv])),
        "update3_conv_median_gap": float(np.median([u[k] for k in conv])),
        "window_step": run.window_step.index, "steps": run.steps}}), file=sys.stderr)


def _steps_look(seed, what, steps, reference) -> None:
    """Each step's loss gap of the control's or a fault's steps (standard error)."""
    print(json.dumps({"seed": seed, "what": what, "step_loss_gaps": [
        abs(p - r) / abs(r) for p, r in zip(steps[0], reference[0])]}), file=sys.stderr)


@contextlib.contextmanager
def wgrad_zeroed():
    """The fault planted in the program: every weight gradient that the
    port's conv_wgrad kernel computes comes back as zeros."""
    import torch

    from faststyle_tpu_torch.ops.cuda import conv_wgrad

    produce = conv_wgrad.conv_weight_grad
    conv_wgrad.conv_weight_grad = lambda *args, **kwargs: torch.zeros_like(produce(*args, **kwargs))
    try:
        yield
    finally:
        conv_wgrad.conv_weight_grad = produce


def unshuffled_rows(driver, ctx, run) -> dict:
    """The fault planted in the program's Batcher: no shuffle buffer (rows
    in the order the shards hold them), over the checked steps' rows."""
    from faststyle_tpu_torch.data import pipeline

    cfg, tr = ctx.config, ctx.traffic
    batcher = pipeline.Batcher(run.corpus.files, batch_size=tr["batch_size"], resize_shape=tuple(cfg["preprocess_size"]),
                               n_epochs=cfg["n_epochs"], min_after_dequeue=0, num_decode_threads=tr["decode_threads"],
                               seed=derive_seed(ctx.seed, "batcher"))
    rows, it = [], iter(batcher)
    for _ in range(tr["checked_steps"]):
        rows.append(next(it))
    it.close()
    index, _ = driver.match(run.corpus, corpus_lib.grid_means(np.concatenate(rows)))
    return {"rows_in_file_order": float(driver.rows_in_file_order(index))}


def train_readings(ctx_for, seeds, control_seeds, _seconds):
    import torch

    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = ctx_for(seed)
        driver = ctx.bench.driver(ctx.config["driver"])
        run = driver.program(ctx)
        kept, step, inputs = run.kept, run.window_step, run.inputs
        compared = len(kept.batches) + 1
        reference = driver.reference_steps(ctx, kept, inputs)
        ref_window = driver.reference_window_step(ctx, step, inputs)
        if seed in seeds:
            numbers = driver.batch_numbers(run, ctx.config["preprocess_size"], ctx.traffic["batch_size"])
            numbers.update(driver.gaps((kept.losses, kept.moment1, kept.params_last), reference, kept.params0))
            numbers.update(driver.window_gaps(step, ref_window))
            yield seed, "program", numbers, compared
            look(driver, seed, run, reference)
        if seed in control_seeds:
            for what, precision, half in (("control_tf32", "tf32", False), ("fault_half_batch", "float32", True)):
                steps = driver.reference_steps(ctx, kept, inputs, precision, half)
                _steps_look(seed, what, steps, reference)
                loss, grads = driver.reference_window_step(ctx, step, inputs, precision, half)
                numbers = driver.gaps(steps, reference, kept.params0)
                numbers.update(driver.window_gaps(dataclasses.replace(step, loss=loss, grad=grads), ref_window))
                yield seed, what, numbers, compared
            zeros = {k: torch.zeros_like(v) for k, v in kept.moment1.items()}
            numbers = driver.gaps((kept.losses, zeros, kept.params0), reference, kept.params0)
            numbers.update(driver.window_gaps(dataclasses.replace(step, grad=step.moment), ref_window))
            yield seed, "fault_state_unchanged", numbers, compared
            flipped = dataclasses.replace(run, kept=dataclasses.replace(kept, batches=[b.flip(2) for b in kept.batches]),
                                          window_step=dataclasses.replace(step, batch=step.batch.flip(2)),
                                          signatures=np.ascontiguousarray(run.signatures[:, :, :, ::-1]))
            numbers = driver.batch_numbers(flipped, ctx.config["preprocess_size"], ctx.traffic["batch_size"])
            yield seed, "fault_rows_altered", numbers, compared
            yield seed, "fault_unshuffled", unshuffled_rows(driver, ctx, run), len(kept.batches)
            del run, kept, step, inputs
            if ctx.device.type == "cuda":
                torch.cuda.empty_cache()
            with wgrad_zeroed():
                faulty_ctx = ctx_for(seed)
                faulty = driver.program(faulty_ctx)
            yield seed, "fault_wgrad_zeroed", driver.numbers(faulty_ctx, faulty), compared
            del faulty
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 1,5,9")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0, help="the stream cells' short window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _fix_cache_dirs(ROOT)
    import torch

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    device = torch.device(args.device)

    def ctx_for(seed):
        return Context(bench, cell, config, traffic, seed, args.seconds, False, device, _AT_START)

    readings = stream_readings if traffic["kind"] == "stream" else train_readings
    seeds = _seeds(args.seeds)
    control_seeds = _seeds(args.control_seeds) if args.control_seeds else []
    lower, upper = defaultdict(float), defaultdict(lambda: float("inf"))
    for seed, what, numbers, compared in readings(ctx_for, seeds, control_seeds, args.seconds):
        print(json.dumps({"seed": seed, "what": what, "compared": compared, "numbers": numbers}), flush=True)
        for name, value in numbers.items():
            if what == "program":
                lower[name] = max(lower[name], value)
            else:
                upper[name] = min(upper[name], value)
    summary = {name: {"lower": lower.get(name), "upper": upper.get(name)} for name in sorted(set(lower) | set(upper))}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
