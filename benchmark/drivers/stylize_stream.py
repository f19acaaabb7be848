"""Stylized video through the port's streaming path.

The entry the window drives is `cli.stylize_webcam.FramePipeline` over
`inference.Stylizer` as the configuration states it (`precision`,
`norm_stats_precision`, `io`; `serving` refuses what the driver cannot
serve). With bfloat16 and packed_u8 that is `Stylizer(packed_input=True,
packed_output=True, compute_dtype=bfloat16)`, as `stylize_webcam
--packed_fetch` runs it: each submit packs a frame on the host into a
pinned slot and enqueues its upload, the forward and the download; each
fetch waits for the oldest frame and unpacks it on the host. A closed
loop: the oldest frame is fetched once `in_flight` frames are in flight.

Set-up: the frames (`pool_frames` video-like frames of the traffic's size,
made on the device from the seed), the Stylizer, its warm-up and a warm
pass of the loop over every ring slot. The window then submits frames in a
seeded cyclic order for `seconds` and drains. A sample of the returned
frames, spread over the whole window from a seeded offset, is kept and,
after the window, compared with the plain reference's float32 output of the
same source frame.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.frames import smooth_fields
from benchmark.harness import Record, derive_seed
from benchmark.reference import transform_net as reference


class Sample:
    """`size` returned frames spread over the whole window: the first frame
    fetched after each of `size` evenly spaced moments, the moments offset
    by a fraction drawn from the seed. Each is copied into a buffer made
    (and its pages touched) in set-up, so keeping it costs the window one
    memcpy."""

    def __init__(self, size: int, seed: int, seconds: float, shape: tuple):
        offset = (seed % 1_000_003) / 1_000_003
        self.moments = [(k + offset) * seconds / size for k in range(size)]
        self.buffers = [np.zeros(shape, np.uint8) for _ in range(size)]
        self.kept: list[tuple[int, np.ndarray]] = []

    def offer(self, elapsed: float, source: int, frame: np.ndarray) -> None:
        k = len(self.kept)
        if k < len(self.moments) and elapsed >= self.moments[k]:
            np.copyto(self.buffers[k], frame)
            self.kept.append((source, self.buffers[k]))


def compare(outputs: list[tuple[int, np.ndarray]], frames: np.ndarray, params: dict, model: dict, device,
            precision: str = "float32", bad_counts: int = 8) -> dict[str, float]:
    """The numbers that decide `correct`, over (source index, returned frame)
    pairs: the worst frame's mean absolute difference from the reference,
    in counts, and the worst frame's share of pixels off by more than
    `bad_counts` in any channel."""
    import torch

    refs: dict[int, np.ndarray] = {}
    mae, bad = 0.0, 0.0
    for source, out in outputs:
        if source not in refs:
            refs[source] = reference.stylize_u8(params, frames[source], model, device, precision)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        diff = np.abs(out.astype(np.int16) - refs[source].astype(np.int16))
        mae = max(mae, float(diff.mean()))
        bad = max(bad, float((diff.max(axis=-1) > bad_counts).mean()))
    return {"frame_mae_max": mae, "frame_bad_share_max": bad}


# What a configuration may state, and the Stylizer's arguments for it. The
# port computes instance norm's moments in float32 whatever the activations'
# dtype, so float32 statistics are the only ones it serves.
PRECISIONS = {"bfloat16": "bfloat16", "float32": None}
NORM_STATS_PRECISIONS = ("float32",)
IO = {"packed_u8": {"packed_input": True, "packed_output": True}, "u8": {"output_uint8": True}}


def serving(config: dict) -> dict:
    """The Stylizer's keyword arguments for the configuration's `precision`,
    `norm_stats_precision` and `io`; a value it cannot serve raises."""
    import torch

    precision, stats, io = config["precision"], config["norm_stats_precision"], config["io"]
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: this driver serves {sorted(PRECISIONS)}")
    if stats not in NORM_STATS_PRECISIONS:
        raise ValueError(f"norm_stats_precision {stats!r}: this driver serves {list(NORM_STATS_PRECISIONS)}")
    if io not in IO:
        raise ValueError(f"io {io!r}: this driver serves {sorted(IO)}")
    dtype = PRECISIONS[precision]
    return {"compute_dtype": dtype and getattr(torch, dtype), **IO[io]}


def setup(ctx):
    """(frames on the host, the pipeline's stylizer)."""
    import torch

    from faststyle_tpu_torch import full_float32
    from faststyle_tpu_torch.inference import Stylizer

    tr, cfg = ctx.traffic, ctx.config
    kwargs = serving(cfg)
    ctx.phase("imports")
    full_float32()
    frames = smooth_fields(tr["pool_frames"], tr["height"], tr["width"], tr["content"],
                           derive_seed(ctx.seed, "frames"), ctx.device).cpu().numpy()
    ctx.phase("frames")
    if ctx.device.type == "cuda":  # the peak from here on is the program's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    stylizer = Stylizer(model_path=ctx.bench.path(cfg["weights"]), upsample_method=cfg["model"]["upsample_method"],
                        device=ctx.device, **kwargs)
    stylizer.warmup(tr["height"], tr["width"], dtypes=[np.uint8])
    ctx.phase("stylizer")
    return frames, stylizer


def stream(ctx, frames: np.ndarray, stylizer, seconds: float, sample: Sample):
    """The closed loop for `seconds`, then the drain: (frames submitted,
    latencies in s, the window's length in s, the window's start)."""
    from faststyle_tpu_torch.cli.stylize_webcam import FramePipeline

    tr = ctx.traffic
    depth, in_flight = tr["pipeline_depth"], tr["in_flight"]
    pipe = FramePipeline(stylizer, tr["height"], tr["width"], depth)
    order = np.random.default_rng(derive_seed(ctx.seed, "order")).permutation(len(frames))
    sources: list[int] = []
    for i in range(2 * (depth + 1)):  # every ring slot once, twice over
        pipe.submit(frames[order[i % len(order)]])
        if len(pipe) >= in_flight:
            pipe.fetch()
    pipe.clear()
    ctx.phase("pipeline")

    spans, tracer = ctx.spans, ctx.tracer
    latencies: list[float] = []
    submitted = fetched = 0
    ctx.prepare_trace()

    def fetch():
        nonlocal fetched
        with spans.span("bench.fetch"):
            t_submit, out = pipe.fetch()
        now = time.perf_counter()
        latencies.append(now - t_submit)
        sample.offer(now - t0, sources[fetched], out)
        fetched += 1

    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        ctx.tick(elapsed)
        if elapsed >= seconds:
            break
        src = int(order[submitted % len(order)])
        with spans.span("bench.submit"):
            pipe.submit(frames[src])
        sources.append(src)
        submitted += 1
        if len(pipe) >= in_flight:
            fetch()
    while len(pipe):
        fetch()
    window = time.perf_counter() - t0
    if tracer.active:
        tracer.stop()
    return submitted, latencies, window, t0


def run(ctx) -> Record:
    import torch

    frames, stylizer = setup(ctx)
    tr = ctx.traffic
    sample = Sample(tr["check_frames"], derive_seed(ctx.seed, "sample"), ctx.seconds, (tr["height"], tr["width"], 3))
    submitted, latencies, window, t0 = stream(ctx, frames, stylizer, ctx.seconds, sample)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del stylizer
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    params = reference.load_npz(ctx.bench.path(ctx.config["weights"]), ctx.device)
    limits = tr["limits"]
    numbers = compare(sample.kept, frames, params, ctx.config["model"], ctx.device)
    return Record(
        setup_s=t0 - ctx.started,
        window_s=window,
        attempted=submitted,
        failed=submitted - len(latencies),
        counters={"frames": len(latencies)},
        checks={name: (value, limits[name]) for name, value in numbers.items()},
        memory_peak_bytes=peak,
        spans=ctx.spans,
        trace=ctx.tracer.data,
        latencies_s=latencies,
        setup_phases=ctx.phases,
    )
