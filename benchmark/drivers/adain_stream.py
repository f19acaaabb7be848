"""Arbitrary-style video through the port's streaming path, AdaIN.

The entry the window drives is `cli.stylize_webcam.FramePipeline` over an
AdaIN `inference.Stylizer`, as the configuration states it (`precision`,
`norm_stats_precision`, `io`, refused as `stylize_stream.serving` refuses),
with the configuration's seeded weights (`reference.adain.init_params`).
Each submit carries a style handle: the frame's forward is enqueued with
that style. A closed loop, as `stylize_stream`'s: the oldest frame is
fetched once `in_flight` frames are in flight, each call inside the same
`bench.submit` and `bench.fetch` spans.

Set-up: the frames (`pool_frames` video-like frames of the traffic's size,
made on the device from the seed), the styles (the traffic's style images
with the shorter side resized to the configuration's `style_size`, and
`fields` seeded field_px x field_px fields), the Stylizer, every style
encoded through `Stylizer.encode_style`, its warm-up and a warm pass of the
loop over every ring slot. The window then submits frames in a seeded
cyclic order, the style switching every `switch_every` frames in a seeded
cyclic order of the styles, for `seconds` and drains. A sample of the
returned frames, spread over the window from a seeded offset, is kept with
the (source, style) pair of each and, after the window, compared with the
plain reference's float32 output for that pair.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.drivers.stylize_stream import Sample, serving
from benchmark.frames import smooth_fields
from benchmark.harness import Record, derive_seed
from benchmark.reference import adain as reference


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] uint8 with the shorter side resized to `size` (bilinear,
    antialiased, as torchvision's Resize on a PIL image), uint8."""
    import torch
    import torch.nn.functional as F

    h, w = img.shape[:2]
    scale = size / min(h, w)
    out = (max(1, round(h * scale)), max(1, round(w * scale)))
    x = torch.from_numpy(np.array(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=out, mode="bilinear", antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def load_image(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def make_styles(ctx) -> list[np.ndarray]:
    """The traffic's styles as [h, w, 3] uint8: each image resized, then
    `fields` fields, each with its own scales, texture and per-channel gain
    and offset drawn from the seed."""
    spec = ctx.traffic["styles"]
    styles = [resize_shorter(load_image(ctx.bench.path(p)), ctx.config["style_size"]) for p in spec["images"]]
    rng = np.random.default_rng(derive_seed(ctx.seed, "styles"))
    fc, px = spec["field_content"], spec["field_px"]
    for _ in range(spec["fields"]):
        content = {"coarse_px": int(rng.integers(fc["coarse_px"][0], fc["coarse_px"][1] + 1)),
                   "mid_px": int(rng.integers(fc["mid_px"][0], fc["mid_px"][1] + 1)),
                   "texture": float(rng.uniform(*fc["texture"]))}
        field = smooth_fields(1, px, px, content, int(rng.integers(2**62)), ctx.device)[0].float().cpu()
        gain, offset = rng.uniform(*fc["gain"], 3), rng.uniform(0.0, 1.0, 3)
        styles.append(np.clip(np.rint(field.numpy() * gain + 255.0 * (1.0 - gain) * offset), 0, 255).astype(np.uint8))
    return styles


def setup(ctx):
    """(frames on the host, styles on the host, the Stylizer, a style handle
    for each style)."""
    import torch

    from faststyle_tpu_torch import full_float32
    from faststyle_tpu_torch.inference import Stylizer

    tr, cfg = ctx.traffic, ctx.config
    kwargs = serving(cfg)
    ctx.phase("imports")
    full_float32()
    frames = smooth_fields(tr["pool_frames"], tr["height"], tr["width"], tr["content"],
                           derive_seed(ctx.seed, "frames"), ctx.device).cpu().numpy()
    styles = make_styles(ctx)
    params = reference.init_params(cfg)
    ctx.phase("frames")
    if ctx.device.type == "cuda":  # the peak from here on is the program's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    stylizer = Stylizer(params=params, device=ctx.device, model="adain", **kwargs)
    handles = [stylizer.encode_style(s) for s in styles]
    stylizer.warmup(tr["height"], tr["width"], dtypes=[np.uint8])
    ctx.phase("stylizer")
    return frames, styles, stylizer, handles


def schedule(ctx, frames: int, styles: int):
    """(source order, style order): seeded permutations, cycled."""
    rng = np.random.default_rng(derive_seed(ctx.seed, "order"))
    return rng.permutation(frames), np.random.default_rng(derive_seed(ctx.seed, "style_order")).permutation(styles)


def stream(ctx, frames: np.ndarray, stylizer, handles, seconds: float, sample: Sample):
    """The closed loop for `seconds`, then the drain: (frames submitted,
    latencies in s, the window's length in s, the window's start). The
    sample keeps ((source, style, previous style), frame): the previous
    style is the one the style order had before the frame's."""
    from faststyle_tpu_torch.cli.stylize_webcam import FramePipeline

    tr = ctx.traffic
    depth, in_flight, every = tr["pipeline_depth"], tr["in_flight"], tr["styles"]["switch_every"]
    pipe = FramePipeline(stylizer, tr["height"], tr["width"], depth)
    order, style_order = schedule(ctx, len(frames), len(handles))
    for i in range(2 * (depth + 1)):  # every ring slot once, twice over
        pipe.submit(frames[order[i % len(order)]], handles[style_order[i % len(style_order)]])
        if len(pipe) >= in_flight:
            pipe.fetch()
    pipe.clear()
    ctx.phase("pipeline")

    spans = ctx.spans
    latencies: list[float] = []
    keys: list[tuple[int, int, int]] = []
    submitted = fetched = 0
    ctx.prepare_trace()

    def fetch():
        nonlocal fetched
        with spans.span("bench.fetch"):
            t_submit, out = pipe.fetch()
        now = time.perf_counter()
        latencies.append(now - t_submit)
        sample.offer(now - t0, keys[fetched], out)
        fetched += 1

    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        ctx.tick(elapsed)
        if elapsed >= seconds:
            break
        src = int(order[submitted % len(order)])
        segment = submitted // every
        sty = int(style_order[segment % len(style_order)])
        with spans.span("bench.submit"):
            pipe.submit(frames[src], handles[sty])
        keys.append((src, sty, int(style_order[(segment - 1) % len(style_order)])))
        submitted += 1
        if len(pipe) >= in_flight:
            fetch()
    while len(pipe):
        fetch()
    window = time.perf_counter() - t0
    if ctx.tracer.active:
        ctx.tracer.stop()
    return submitted, latencies, window, t0


def compare(outputs, frames: np.ndarray, styles: list, params: dict, device, bad_counts: int = 8) -> dict[str, float]:
    """The numbers that decide `correct`, over ((source, style, ...), frame)
    pairs against the reference's float32 output of the pair: the worst
    frame's mean absolute difference in counts, and the worst frame's share
    of pixels off by more than `bad_counts` in any channel. Also
    `clip_share_max` (not checked): the largest share of a reference
    frame's pixels with a channel at 0 or 255."""
    refs = reference_frames([key for key, _ in outputs], frames, styles, params, device)
    mae = bad = clip = 0.0
    for key, out in outputs:
        ref = refs[key[:2]]
        diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
        mae = max(mae, float(diff.mean()))
        bad = max(bad, float((diff.max(axis=-1) > bad_counts).mean()))
        clip = max(clip, float(((ref == 0) | (ref == 255)).any(axis=-1).mean()))
    return {"frame_mae_max": mae, "frame_bad_share_max": bad, "clip_share_max": clip}


def reference_frames(keys, frames, styles, params, device, precision="float32", stats_precision="float32") -> dict:
    """{(source, style): the reference's uint8 frame} for the keys' pairs."""
    import torch

    params = reference.to_device(params, device)
    moments, refs = {}, {}
    for key in keys:
        src, sty = key[:2]
        if (src, sty) in refs:
            continue
        if sty not in moments:
            moments[sty] = reference.style_moments(params, styles[sty], device, precision, stats_precision)
        refs[(src, sty)] = reference.stylize_u8(params, frames[src], moments[sty], device, precision, stats_precision)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return refs


def run(ctx) -> Record:
    import torch

    frames, styles, stylizer, handles = setup(ctx)
    tr = ctx.traffic
    sample = Sample(tr["check_frames"], derive_seed(ctx.seed, "sample"), ctx.seconds, (tr["height"], tr["width"], 3))
    submitted, latencies, window, t0 = stream(ctx, frames, stylizer, handles, ctx.seconds, sample)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del stylizer, handles
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    limits = tr["limits"]
    numbers = compare(sample.kept, frames, styles, reference.init_params(ctx.config), ctx.device)
    return Record(
        setup_s=t0 - ctx.started,
        window_s=window,
        attempted=submitted,
        failed=submitted - len(latencies),
        counters={"frames": len(latencies)},
        checks={name: (numbers[name], limit) for name, limit in limits.items()},
        memory_peak_bytes=peak,
        spans=ctx.spans,
        trace=ctx.tracer.data,
        latencies_s=latencies,
        setup_phases=ctx.phases,
    )
