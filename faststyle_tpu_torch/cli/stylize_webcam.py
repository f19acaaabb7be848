#!/usr/bin/env python3
"""Streaming stylization: webcam, video file, or synthetic frames.

    python -m faststyle_tpu_torch.cli.stylize_webcam --num_synthetic_frames 120 \\
        --resolution 1920 1080 --no_display --report_latency

The flags are faststyle_tpu's stylize_webcam CLI's, with its defaults
(bfloat16, pipeline depth 1), plus `--device {cuda,cpu}` (default cuda;
no silent CPU fallback) and `--style_image`, the style of an AdaIN model
(`models/adain.py`, known by its blocks). Frames are RGB into the net and
BGR out to the display and the writer. TF32 is off (`full_float32`).

Pipelining on one CUDA stream: frame N's upload, forward and download are
enqueued, then frame N-depth is fetched. For the host not to wait on frame
N as well, each frame is staged in a ring of `depth + 1` pinned host
buffers, copied both ways with `non_blocking`, and its download is followed
by a CUDA event that the fetch waits on; a slot is refilled only after its
event has fired. `--packed_fetch` packs frames on the host and unpacks the
results there (`inference.pack_u8_host` / `unpack_u8_host`).
"""

from __future__ import annotations

import argparse
import time
from collections import deque


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Use a trained fast style transfer model to filter a video stream.")
    parser.add_argument(
        "--model_path",
        default="./models/starry_final.ckpt",
        help="Path to .ckpt (TF1) or .npz (native) for the trained model.",
    )
    parser.add_argument("--upsample_method", choices=["resize", "deconv"], default="resize")
    parser.add_argument(
        "--resolution", nargs=2, type=int, default=None, help="Dimensions (width height) for webcam capture."
    )
    parser.add_argument("--video_path", default=None, help="Stylize a video file instead of the webcam.")
    parser.add_argument(
        "--num_synthetic_frames",
        type=int,
        default=0,
        help="Stylize N generated frames (no camera/file needed; prints fps).",
    )
    parser.add_argument("--output_path", default="output.avi")
    parser.add_argument("--no_display", action="store_true", help="Headless: skip cv2.imshow.")
    parser.add_argument("--precision", choices=["float32", "bfloat16"], default="bfloat16")
    parser.add_argument("--max_frames", type=int, default=-1)
    parser.add_argument(
        "--packed_fetch",
        action="store_true",
        help="Pack frames on the host and fetch results in the packed-u8 layout, "
        "unpacked on the host (C++ depth-to-space).",
    )
    parser.add_argument(
        "--pipeline_depth",
        type=int,
        default=1,
        help="Frames kept in flight on the device. 1 enqueues frame N then fetches "
        "N-1; higher depths trade about depth x the stage period of latency for "
        "throughput.",
    )
    parser.add_argument(
        "--report_latency",
        action="store_true",
        help="Print per-frame latency (capture -> emit, p50/p99) after the fps line.",
    )
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where to stylize; cuda raises when no GPU is present.",
    )
    parser.add_argument("--style_image", default=None, help="The style image of an AdaIN model (any style).")
    return parser


def _percentiles_ms(lat_s):
    lat = sorted(v * 1e3 for v in lat_s)
    return lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.99 * len(lat)))]


def _latency_line(lat_s) -> str:
    p50, p99 = _percentiles_ms(lat_s)
    return f"per-frame latency p50 {p50:.1f} ms / p99 {p99:.1f} ms"


def synthetic_frames(n, h, w):
    import numpy as np

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)  # cameras produce uint8
    for i in range(n):
        yield np.roll(base, i * 4, axis=1)


class FramePipeline:
    """Frames in flight between the host and the stylizer's device.

    `submit(frame, style=None)` stages an HxWx3 uint8 RGB frame in the next
    slot of a ring of `depth + 1` (pinned on CUDA), enqueues its upload, the
    forward and the download into the slot's output buffer, and records the
    slot's event. An AdaIN stylizer's frame is bound to the style handle it
    is submitted with (`Stylizer.encode_style`): its forward is enqueued
    with that style, whatever later frames carry. The packed input's border
    and the output's extent are the stylizer's (`pad`, `output_shape`).
    `fetch()` waits for the oldest frame's event and returns (submit time,
    HxWx3 uint8 RGB). A returned array may be a view of the
    slot's buffer: it stays valid until that slot is submitted again, at
    the earliest `depth + 1` submits later; copy it to keep it.

    Under a torch profiler each frame records `stream.submit` (children
    `stream.slot_wait`, `stream.pack`, `stream.launch`) and `stream.fetch`
    (`stream.result_wait`, `stream.unpack`), all with the frame's sequence
    number as id (`utils.profiling.span`)."""

    def __init__(self, stylizer, height: int, width: int, depth: int):
        import torch

        from faststyle_tpu_torch.inference import packed_shape

        self._stylizer = stylizer
        self._hw = (height, width)
        self._out_hw = stylizer.output_shape(height, width)
        dev = stylizer.device
        pin = dev.type == "cuda"
        in_shape = packed_shape(1, height, width, stylizer.pad) if stylizer.packed_input else (1, height, width, 3)
        oh, ow = self._out_hw
        out_shape = (1, -(-oh // 4), -(-ow // 4), 48) if stylizer.packed_output else (1, oh, ow, 3)
        self._slots = [
            (
                torch.empty(in_shape, dtype=torch.uint8, pin_memory=pin),
                torch.empty(out_shape, dtype=torch.uint8, pin_memory=pin),
                torch.cuda.Event() if pin else None,
            )
            for _ in range(max(depth, 1) + 1)
        ]
        self._next = 0
        self._seq = 0  # the next frame's sequence number: its spans' id
        self._inflight: deque = deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def submit(self, frame, style=None) -> None:
        from faststyle_tpu_torch.inference import pack_u8_host, style_args
        from faststyle_tpu_torch.utils.profiling import span

        t_submit = time.perf_counter()
        seq = self._seq
        self._seq += 1
        with span("stream.submit", seq):
            host_in, host_out, event = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            with span("stream.slot_wait"):
                if event is not None:
                    event.synchronize()  # the slot's last frame has left both buffers
            with span("stream.pack"):
                if self._stylizer.packed_input:
                    pack_u8_host(frame[None], self._stylizer.pad, out=host_in.numpy())
                else:
                    host_in.numpy()[0] = frame
            with span("stream.launch"):
                x = host_in.to(self._stylizer.device, non_blocking=True)
                hw = self._hw if self._stylizer.packed_input else None
                y = self._stylizer.stylize_device(x, hw, *style_args(style))
                host_out.copy_(y, non_blocking=True)
                if event is not None:
                    event.record()
            self._inflight.append((t_submit, seq, host_out, event))

    def fetch(self):
        from faststyle_tpu_torch.inference import unpack_u8_host
        from faststyle_tpu_torch.utils.profiling import span

        t_submit, seq, host_out, event = self._inflight.popleft()
        with span("stream.fetch", seq):
            with span("stream.result_wait"):
                if event is not None:
                    event.synchronize()
            with span("stream.unpack"):
                h, w = self._hw
                out = host_out.numpy()
                if self._stylizer.packed_output:
                    # the net's shape law can exceed (h, w) by up to 3 px: crop
                    return t_submit, unpack_u8_host(out, *self._out_hw)[0, :h, :w]
                return t_submit, out[0, :h, :w]

    def clear(self) -> None:
        while self._inflight:
            self.fetch()


def main(argv=None, on_frame=None) -> dict:
    """Run the stream; returns {"frames", "seconds", "fps", "p50_ms",
    "p99_ms"}. `on_frame(rgb)` (for embedding and tests) sees every emitted
    frame in order; the array is valid during the call."""
    from faststyle_tpu_torch import full_float32

    full_float32()
    args = setup_parser().parse_args(argv)

    import numpy as np
    import torch

    from faststyle_tpu_torch.inference import Stylizer

    stylizer = Stylizer(
        model_path=args.model_path,
        upsample_method=args.upsample_method,
        compute_dtype=torch.bfloat16 if args.precision == "bfloat16" else None,
        output_uint8=True,  # clip + cast on the device: 4x smaller downloads
        packed_output=args.packed_fetch,
        packed_input=args.packed_fetch,
        device=args.device,
    )
    from faststyle_tpu_torch.cli.stylize_image import style_for

    style = style_for(stylizer, args.style_image)
    depth = max(args.pipeline_depth, 1)
    lat = []
    result = {"frames": 0, "seconds": 0.0, "fps": 0.0, "p50_ms": None, "p99_ms": None}

    def finish(count, dt, suffix=""):
        result.update(frames=count, seconds=dt, fps=count / dt if dt > 0 else float("nan"))
        print(f"{count} frames in {dt:.3f}s = {result['fps']:.2f} fps{suffix}")
        if lat:
            result["p50_ms"], result["p99_ms"] = _percentiles_ms(lat)
            if args.report_latency:
                print(_latency_line(lat))

    if args.num_synthetic_frames > 0:
        w, h = args.resolution if args.resolution else (800, 600)
        print(f"Synthetic stream at {w}x{h}; warming up...")
        stylizer.warmup(h, w, dtypes=[np.uint8])  # frames are uint8-only here
        pipe = FramePipeline(stylizer, h, w, depth)
        count = 0
        t0 = time.perf_counter()

        def emit():
            ts, img = pipe.fetch()
            lat.append(time.perf_counter() - ts)
            if on_frame is not None:
                on_frame(img)

        for frame in synthetic_frames(args.num_synthetic_frames, h, w):
            pipe.submit(frame, style)
            count += 1
            if len(pipe) > depth:
                emit()  # fetch the oldest while newer frames compute
        while len(pipe):
            emit()
        finish(count, time.perf_counter() - t0)
        return result

    import cv2

    if args.video_path:
        cap = cv2.VideoCapture(args.video_path)
    else:
        cap = cv2.VideoCapture(0)
        if args.resolution is not None:
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, args.resolution[0])
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, args.resolution[1])
    if not cap.isOpened():
        raise SystemExit("could not open video source")
    x_new = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    y_new = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 15.0
    print(f"Resolution is: {x_new} by {y_new}")
    stylizer.warmup(y_new, x_new, dtypes=[np.uint8])  # cameras produce uint8
    pipe = FramePipeline(stylizer, y_new, x_new, depth)
    out_writer = cv2.VideoWriter(args.output_path, cv2.VideoWriter_fourcc(*"XVID"), src_fps, (x_new, y_new))

    count = 0
    t0 = time.perf_counter()

    def emit() -> bool:
        """Fetch a finished frame, write / display it; True to keep going."""
        ts, img_out = pipe.fetch()
        lat.append(time.perf_counter() - ts)
        if on_frame is not None:
            on_frame(img_out)
        bgr = cv2.cvtColor(img_out, cv2.COLOR_RGB2BGR)
        out_writer.write(bgr)
        if not args.no_display:
            cv2.imshow("frame", bgr)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                return False
        return True

    try:
        while True:
            # bound check before staging: --max_frames 0 processes no frame
            if 0 <= args.max_frames <= count + len(pipe):
                break
            ret, frame = cap.read()
            if not ret:
                break
            pipe.submit(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), style)  # uint8 end to end
            if len(pipe) > depth:
                count += 1
                if not emit():
                    pipe.clear()
                    break
        while len(pipe):
            count += 1
            if not emit():
                pipe.clear()
                break
    finally:
        if count:
            finish(count, time.perf_counter() - t0, f" -> {args.output_path}")
        cap.release()
        out_writer.release()
        if not args.no_display:
            cv2.destroyAllWindows()
    return result


if __name__ == "__main__":
    main()
