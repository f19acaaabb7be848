#!/usr/bin/env python3
"""End-to-end training validation without VGG weights: teacher distillation
(the port of tools/distill_validation.py).

A fresh transform net (the reference's init distributions, seed 0) is
trained through the port's real machinery (the image-dir Batcher, device
prefetch, the transform net's forward and backward through
ops/conv_grad.py and the conv_wgrad kernel, the Gram kernel, Adam,
checkpoints) against a shipped, VGG-trained teacher such as
weights/starry_final.npz. If the gradients and the optimizer are right,
the student converges to the teacher's function; chicago is held out of
the corpus (`tools.make_training_images`), and the student-vs-teacher
SSIM on it at 256, 512 and native size is the end-to-end check.

The recipe (docs/TRAINED_MODEL.md section 1), on a card:

    python -m faststyle_tpu_torch.tools.make_training_images build/train_imgs --num 800
    python -m faststyle_tpu_torch.tools.distill_validation --image_dir build/train_imgs \\
        --out build/distill/starry_layerwise.npz --layerwise --steps 12000 --learn_rate 1e-3
    python -m faststyle_tpu_torch.tools.distill_validation --image_dir build/train_imgs \\
        --init_from build/distill/starry_layerwise.npz --out build/distill/starry_distilled.npz \\
        --steps 8000 --learn_rate 3e-4 --gram_w 1 --ema_decay 0.999

Two steps, each the JAX tool's: `make_teacher_forcing_step` regresses each
of the student's 13 layers onto the teacher's output of that layer given
the teacher's own input to it; `make_distill_step` matches the output
(pixel L2 over mean(target^2)), every tap (`feature_w`) and, with
`gram_w`, the taps' Gram matrices (the Gram kernel), with a Polyak average
(`ema_decay`) as the saved artifact. optax's adam with its cosine decay
(alpha 0.02) is torch.optim.Adam with the learning rate set from the same
schedule before every update. The student's init is the port's
`init_params` from seed 0 (not the JAX package's random numbers). Flags
and defaults are the JAX tool's, plus `--device`; `--out` defaults under
build/, since models/ holds the reference's distilled nets.
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from faststyle_tpu_torch import full_float32, losses, resolve_device
from faststyle_tpu_torch.data import pipeline
from faststyle_tpu_torch.inference import load_params, save_params
from faststyle_tpu_torch.models import transform_net
from faststyle_tpu_torch.ops import layers as L
from faststyle_tpu_torch.utils import image_io
from faststyle_tpu_torch.utils.metrics import ssim

REPO = Path(__file__).resolve().parents[2]
Params = transform_net.Params


class CosineAdam:
    """optax.adam(learn_rate), or optax.adam(optax.cosine_decay_schedule(
    learn_rate, decay_steps, alpha=0.02)) when decay_steps > 0, as a
    torch.optim.Adam whose learning rate is set from the schedule at the
    update count before each update (optax's order: the first update uses
    the schedule at 0)."""

    ALPHA = 0.02

    def __init__(self, learn_rate: float, decay_steps: int = 0):
        self.learn_rate, self.decay_steps = learn_rate, decay_steps

    def rate(self, count: int) -> float:
        if not self.decay_steps:
            return self.learn_rate
        frac = min(count, self.decay_steps) / self.decay_steps
        return self.learn_rate * ((1 - self.ALPHA) * 0.5 * (1 + math.cos(math.pi * frac)) + self.ALPHA)

    def init(self, net: torch.nn.Module) -> torch.optim.Adam:
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt
        opt = torch.optim.Adam(net.parameters(), lr=self.rate(0), betas=(0.9, 0.999), eps=1e-8)
        for group in opt.param_groups:
            group["count"] = 0
        return opt

    def step(self, opt: torch.optim.Adam) -> None:
        for group in opt.param_groups:
            group["lr"] = self.rate(group["count"])
            group["count"] += 1
        opt.step()


def _ms(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(x))


def _ema_update(ema: Params, net: transform_net.TransformNet, decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), leaf by leaf."""
    params = net.params()
    es = [ema[b][v] for b in ema for v in ema[b]]
    ps = [params[b][v].detach().to(ema[b][v].dtype) for b in ema for v in ema[b]]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, torch._foreach_mul(ps, 1.0 - decay))


def _make_step(loss_fn: Callable, opt: CosineAdam, ema_decay: float):
    def step(net, ema, opt_state, teacher, batch):
        opt_state.zero_grad(set_to_none=True)
        loss, aux = loss_fn(net.params(), teacher, batch)
        loss.backward()
        opt.step(opt_state)
        if ema_decay:
            _ema_update(ema, net, ema_decay)
        return net, ema, opt_state, (loss.detach(), aux.detach())

    return step


def make_distill_step(
    learn_rate: float,
    compute_dtype,
    decay_steps: int = 0,
    feature_w: float = 1.0,
    gram_w: float = 0.0,
    ema_decay: float = 0.0,
    upsample_method: str = "resize",
):
    """(step, opt): step(net, ema, opt_state, teacher, batch) -> (net, ema,
    opt_state, (loss, pixel_l2)), updating the TransformNet `net`, the
    Polyak average `ema` (a params dict) and the Adam `opt_state`
    (`opt.init(net)`) in place. The loss: pixel L2 to the teacher's output
    over mean(target^2); plus `feature_w` times the mean over the 11 taps of
    each tap's L2 over the teacher tap's second moment; plus `gram_w` times
    the mean over the taps of the Gram matrices' (of the relu'd taps, the
    Gram kernel on a card) L2 over the teacher Gram's second moment. The
    reported pixel L2 is the raw mean square."""
    opt = CosineAdam(learn_rate, decay_steps)

    def loss_fn(params, teacher, batch):
        with torch.no_grad():
            target, t_feats = transform_net.apply_with_features(teacher, batch, upsample_method,
                                                                compute_dtype=compute_dtype)
        y, s_feats = transform_net.apply_with_features(params, batch, upsample_method, compute_dtype=compute_dtype)
        pix_raw = _ms(y - target)
        loss = pix_raw / (_ms(target) + 1e-6)
        if feature_w:
            per_layer = [_ms(s_feats[k] - t_feats[k]) / (_ms(t_feats[k]) + 1e-6) for k in sorted(t_feats)]
            loss = loss + feature_w * sum(per_layer) / len(per_layer)
        if gram_w:
            # Grams in float32 on relu'd taps: texture statistics live in the
            # post-activation field, as the teachers' style loss saw VGG's
            per_gram = []
            for k in sorted(t_feats):
                gs = losses.gram_matrix(L.relu(s_feats[k]))
                gt = losses.gram_matrix(L.relu(t_feats[k]))
                per_gram.append(_ms(gs - gt) / (_ms(gt) + 1e-8))
            loss = loss + gram_w * sum(per_gram) / len(per_gram)
        return loss, pix_raw

    return _make_step(loss_fn, opt, ema_decay), opt


def make_teacher_forcing_step(
    learn_rate: float,
    compute_dtype,
    decay_steps: int = 0,
    ema_decay: float = 0.0,
    upsample_method: str = "resize",
):
    """(step, opt) of the per-layer teacher-forced regression: each of the
    student's 13 layers (conv + IN, plus the skip for a resblock) is
    regressed onto the teacher's tap of that layer, fed the teacher's own
    input to it: init_i reads relu(init_{i-1}), resblock_i reads res_{i-1}
    (relu(init_2) for the first), up_0 reads res_4, up_1 relu(up_0), the
    final 9x9 relu(up_1). The loss is the mean of the 13 normalized terms;
    the reported metric is the last (the pre-tanh output's). Both upsample
    variants run their exact phase forms (forward convolutions)."""
    opt = CosineAdam(learn_rate, decay_steps)
    deconv = upsample_method == "deconv"

    def loss_fn(p, teacher, batch):
        with torch.no_grad():
            _, t = transform_net.apply_with_features(teacher, batch, upsample_method, compute_dtype=compute_dtype)
        x0 = batch.to(compute_dtype or torch.float32)
        terms = []

        def add(out, key):
            terms.append(_ms(out - t[key]) / (_ms(t[key]) + 1e-6))

        padded = L.reflect_pad(x0, 40)
        for i, s in enumerate((1, 2, 2)):
            blk = p[f"initconv_{i}"]
            inp = padded if i == 0 else L.relu(t[f"init_{i - 1}"])
            add(L.instance_norm(L.conv2d(inp, blk["W"], stride=s), blk["INscale"], blk["INshift"]), f"init_{i}")
        for i in range(5):
            blk = p[f"resblock_{i}"]
            inp = L.relu(t["init_2"]) if i == 0 else t[f"res_{i - 1}"]
            r = L.conv2d(inp, blk["W1"], padding="VALID")
            r = L.relu(L.instance_norm(r, blk["INscale1"], blk["INshift1"]))
            r = L.conv2d(r, blk["W2"], padding="VALID")
            r = L.instance_norm(r, blk["INscale2"], blk["INshift2"])
            add(r + inp[:, 2:-2, 2:-2, :], f"res_{i}")
        for i in range(2):
            blk = p[f"upsample_{i}"]
            inp = t["res_4"] if i == 0 else L.relu(t["up_0"])
            u = L.deconv_upsample(inp, blk["W"]) if deconv else L.upsample_conv(inp, blk["W"])
            add(L.instance_norm(u, blk["INscale"], blk["INshift"]), f"up_{i}")
        blk = p["upsample_2"]
        inp = L.relu(t["up_1"])
        h = L.deconv_same_s1(inp, blk["W"]) if deconv else L.conv2d(inp, blk["W"])
        add(L.instance_norm(h, blk["INscale"], blk["INshift"]), "pre_tanh")
        return sum(terms) / len(terms), terms[-1]

    return _make_step(loss_fn, opt, ema_decay), opt


def setup_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Distil a fresh transform net from a trained teacher.")
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--teacher", default=str(REPO / "weights/starry_final.npz"))
    ap.add_argument("--out", default=str(REPO / "build/distill/starry_distilled.npz"))
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--learn_rate", type=float, default=1e-3)
    ap.add_argument("--log_csv", default="")
    ap.add_argument("--feature_w", type=float, default=1.0,
                    help="weight on layer-wise teacher feature matching (0 = pure pixel L2)")
    ap.add_argument("--gram_w", type=float, default=0.0,
                    help="weight on per-tap Gram (texture-statistics) matching vs the teacher")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="Polyak-average the student and save/evaluate the average (0 = off)")
    ap.add_argument("--layerwise", action="store_true",
                    help="teacher-forced per-layer regression phase (run first from scratch, then fine-tune "
                    "end-to-end with --init_from; the metric column reports the normalized final-layer term, "
                    "not raw pixel L2)")
    ap.add_argument("--init_from", default="", help="warm-start from a saved student (continue training)")
    ap.add_argument("--precision", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--upsample", default="resize", choices=["resize", "deconv"],
                    help="teacher/student upsample variant (must match the teacher's)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to train; cuda raises when no GPU is present")
    return ap


def held_out_ssim(student: Params, teacher: Params, compute_dtype=None, upsample_method: str = "resize", *,
                  device: str | torch.device = "cuda", out_dir: Optional[Path] = None) -> Dict[str, float]:
    """Student-vs-teacher SSIM on chicago at 256 (crop), 512 and native
    474x712, both nets at `compute_dtype`; the native pair is written to
    out_dir when given. Both run every norm in plain torch
    (`apply_with_features`), so the scores do not move with the serving
    path's kernels."""
    device = resolve_device(device)
    scores = {}
    for tag, name in (("256", "chicago_crop256.png"), ("512", "chicago_512.png"), ("native", "chicago.jpg")):
        x = torch.from_numpy(image_io.imread(REPO / "tests/assets" / name).astype(np.float32))[None].to(device)
        with torch.no_grad():
            t, s = (np.clip(transform_net.apply_with_features(p, x, upsample_method, compute_dtype=compute_dtype)[0][0]
                            .float().cpu().numpy(), 0, 255) for p in (teacher, student))
        scores[tag] = ssim(s, t)
        print(f"held-out chicago@{tag}: student-vs-teacher SSIM {scores[tag]:.4f}", flush=True)
        if tag == "native" and out_dir is not None:
            image_io.imwrite(out_dir / "distill_student_native.png", s.astype(np.uint8))
            image_io.imwrite(out_dir / "distill_teacher_native.png", t.astype(np.uint8))
    return scores


def main(argv=None) -> dict:
    """Train, save and validate; returns the saved path, the logged rows
    (step, loss, metric, seconds), steps/s and the held-out SSIMs."""
    full_float32()
    args = setup_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bfloat16" else None

    teacher = load_params(args.teacher, device=device)
    if args.init_from:
        params = load_params(args.init_from, device=device)
    else:
        params = transform_net.init_params(torch.Generator().manual_seed(0), args.upsample, device=device)
    net = transform_net.TransformNet(params, args.upsample).to(device)
    ema = {b: {v: t.detach().clone() for v, t in sub.items()} for b, sub in net.params().items()}
    if args.layerwise:
        step_fn, opt = make_teacher_forcing_step(args.learn_rate, dtype, decay_steps=args.steps,
                                                 ema_decay=args.ema_decay, upsample_method=args.upsample)
    else:
        step_fn, opt = make_distill_step(args.learn_rate, dtype, decay_steps=args.steps, feature_w=args.feature_w,
                                         gram_w=args.gram_w, ema_decay=args.ema_decay, upsample_method=args.upsample)
    opt_state = opt.init(net)

    batcher = pipeline.image_dir_batcher(args.image_dir, args.batch_size, resize_shape=(256, 256), seed=1,
                                         min_after_dequeue=1000)
    batches = pipeline.device_prefetch(iter(batcher), device=device)

    out = Path(args.out)
    if out.suffix != ".npz":
        out = Path(str(out) + ".npz")  # load_params probes .npz names only
    out.parent.mkdir(parents=True, exist_ok=True)

    def save(p: Params) -> None:
        tmp = out.with_suffix(".tmp.npz")
        save_params(tmp, p)  # write, then replace: a cut run keeps the last whole file
        tmp.replace(out)

    # with EMA on, the Polyak average is the artifact saved and evaluated
    final = lambda: ema if args.ema_decay else net.params()  # noqa: E731

    rows = []
    try:
        t0 = time.perf_counter()
        for i in range(1, args.steps + 1):
            net, ema, opt_state, (loss, pix) = step_fn(net, ema, opt_state, teacher, next(batches))
            if i % 100 == 0 or i == 1:
                loss_v, pix_v = float(loss), float(pix)
                rows.append((i, loss_v, pix_v, time.perf_counter() - t0))
                print(f"step {i:5d}  loss {loss_v:9.5f}  pixel-L2 {pix_v:10.3f}  ({rows[-1][3]:.1f}s)", flush=True)
            if i % 2000 == 0:
                save(final())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        batches.close()
    save(final())
    rate = args.steps / wall if wall > 0 else float("nan")
    print(f"saved student model to {out}; {args.steps} steps in {wall:.1f} s ({rate:.2f} steps/s)", flush=True)
    if args.log_csv:
        with open(args.log_csv, "w") as f:
            f.write("step,loss,pixel_l2,seconds\n")
            f.writelines(f"{s},{l},{p},{t:.2f}\n" for s, l, p, t in rows)
    scores = held_out_ssim(final(), teacher, dtype, args.upsample, device=device, out_dir=out.parent)
    return {"out": out, "rows": rows, "steps_per_sec": rate, "wall_s": wall, "ssim": scores}


if __name__ == "__main__":
    main()
