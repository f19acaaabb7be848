"""Host-side training input pipeline (counterpart of
faststyle_tpu/data/pipeline.py):

  record reader (TFRecord shards through the C++ scanner, or image files)
    -> decode pool (cv2 decode + bicubic resize; cv2 releases the GIL)
    -> shuffle buffer (min_after_dequeue-style uniform sampling)
    -> batcher
    -> device_prefetch (pinned host memory, non_blocking copies on a side
       stream, `depth` batches ahead so the card never waits)

Kept from the reference: bicubic resize to `resize_shape`, a shuffle
buffer of `min_after_dequeue` images, epoch-bounded iteration with the
shard (or file) order reshuffled every epoch. The random draws are the JAX
package's, one seeded numpy Generator in the same order, so both packages
yield the same batches from the same shards and seed.
"""

from __future__ import annotations

import collections
import io
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, TypeVar

import numpy as np
import torch

from faststyle_tpu_torch import resolve_device
from faststyle_tpu_torch.data import tfrecord
from faststyle_tpu_torch.utils.profiling import span

try:
    import cv2

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAVE_CV2 = False

_T = TypeVar("_T")
_R = TypeVar("_R")


def _bounded_map(
    pool: ThreadPoolExecutor, fn: Callable[[_T], _R], items: Iterable[_T], depth: int
) -> Iterator[_R]:
    """Executor.map with at most `depth` futures in flight, results in order
    (Executor.map submits the whole iterable first, which never ends on an
    endless stream and holds every decoded image of a finite one)."""
    it = iter(items)
    window: collections.deque = collections.deque()
    try:
        while True:
            while len(window) < depth:
                try:
                    window.append(pool.submit(fn, next(it)))
                except StopIteration:
                    break
            if not window:
                return
            yield window.popleft().result()
    finally:
        for fut in window:
            fut.cancel()


def _decode_resize(data: bytes, resize_shape: Optional[Sequence[int]]) -> Optional[np.ndarray]:
    """Encoded image bytes -> float32 RGB HWC, bicubic-resized to
    `resize_shape`; None for bytes that do not decode."""
    if _HAVE_CV2:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            return None
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if resize_shape is not None:
            img = cv2.resize(img, (resize_shape[1], resize_shape[0]), interpolation=cv2.INTER_CUBIC)
        return img.astype(np.float32)
    from PIL import Image, UnidentifiedImageError

    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
    except (UnidentifiedImageError, OSError):
        return None
    if resize_shape is not None:
        img = img.resize((resize_shape[1], resize_shape[0]), Image.BICUBIC)
    return np.asarray(img, dtype=np.float32)


class Batcher:
    """TFRecord shards -> shuffled float32 NHWC batches (an iterable).

    Mirrors the reference's `datapipe.batcher(files, batch_size,
    resize_shape, n_epochs, min_after_dequeue)`. Each record is a
    `tf.train.Example` whose `image/encoded` is decoded and resized on
    `num_decode_threads` threads. A last partial batch is dropped unless
    `drop_remainder=False`. `verify_crc` checks every record's data CRC in
    the same C++ pass that finds the record boundaries, as TF's
    RecordReader does, so a bit-rotted shard raises.
    """

    def __init__(
        self,
        files: Sequence[str | Path],
        batch_size: int,
        resize_shape: Optional[Sequence[int]] = (256, 256),
        n_epochs: Optional[int] = None,
        min_after_dequeue: int = 4000,
        num_decode_threads: int = 8,
        seed: int = 0,
        drop_remainder: bool = True,
        verify_crc: bool = True,
    ):
        if not files:
            raise ValueError("no input files")
        self._files = [Path(f) for f in files]
        self._batch = batch_size
        self._resize = tuple(resize_shape) if resize_shape is not None else None
        self._epochs = n_epochs
        self._buffer_size = min_after_dequeue
        self._threads = num_decode_threads
        self._rng = np.random.default_rng(seed)
        self._drop_remainder = drop_remainder
        self._verify_crc = verify_crc

    def _record_stream(self) -> Iterator[bytes]:
        epoch = 0
        while self._epochs is None or epoch < self._epochs:
            for fi in self._rng.permutation(len(self._files)):
                yield from tfrecord.iter_records(self._files[fi], verify=self._verify_crc)
            epoch += 1

    def _decode(self, rec: bytes) -> Optional[np.ndarray]:
        with span("data.decode"):
            enc = tfrecord.decode_example(rec).get("image/encoded")
            if enc is None:
                return None
            return _decode_resize(enc, self._resize)

    def __iter__(self) -> Iterator[np.ndarray]:
        buffer: List[np.ndarray] = []
        pending: List[np.ndarray] = []
        pool = ThreadPoolExecutor(max_workers=self._threads)
        try:
            stream = _bounded_map(pool, self._decode, self._record_stream(), depth=4 * self._threads)
            for img in stream:
                if img is None:
                    continue
                buffer.append(img)
                if len(buffer) <= self._buffer_size:
                    continue
                # uniform sample from the shuffle buffer (shuffle_batch behaviour)
                idx = self._rng.integers(len(buffer))
                buffer[idx], sample = buffer[-1], buffer[idx]
                buffer.pop()
                pending.append(sample)
                if len(pending) == self._batch:
                    yield np.stack(pending)
                    pending = []
            # input exhausted: flush the buffer
            self._rng.shuffle(buffer)
            for sample in buffer:
                pending.append(sample)
                if len(pending) == self._batch:
                    yield np.stack(pending)
                    pending = []
            if pending and not self._drop_remainder:
                yield np.stack(pending)
        except GeneratorExit:
            # the consumer abandoned the iterator: cancel, don't join workers
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        else:
            pool.shutdown(wait=True)


class _DirBatcher(Batcher):
    """A Batcher over image files: each file's bytes become one in-memory
    Example record, so decoding and every random draw stay the Batcher's."""

    def _record_stream(self) -> Iterator[bytes]:
        epoch = 0
        while self._epochs is None or epoch < self._epochs:
            for fi in self._rng.permutation(len(self._files)):
                path = self._files[fi]
                yield tfrecord.encode_image_example(path.read_bytes(), 0, 0, path.name)
            epoch += 1


def image_dir_batcher(
    directory: str | Path,
    batch_size: int,
    resize_shape: Optional[Sequence[int]] = (256, 256),
    **kwargs,
) -> Batcher:
    """Train straight from a directory of .jpg / .jpeg / .png files,
    skipping the TFRecord conversion."""
    exts = {".jpg", ".jpeg", ".png"}
    files = sorted(p for p in Path(directory).iterdir() if p.suffix.lower() in exts)
    return _DirBatcher(files, batch_size=batch_size, resize_shape=resize_shape, **kwargs)


def device_prefetch(
    batches: Iterator[np.ndarray], *, depth: int = 2, device: str | torch.device = "cuda"
) -> Iterator[torch.Tensor]:
    """Move batches to `device` `depth` ahead of consumption on a host thread.

    On CUDA each batch is copied from pinned host memory with a non_blocking
    copy on a side stream; the consumer's stream waits on that copy's event
    before it sees the tensor, so the copy overlaps the previous step. A
    failure in the source re-raises in the consumer; abandoning the
    generator stops the feeder and closes the source on the feeder thread.
    """
    device = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        """Bounded put that gives up once the consumer is gone, so the
        feeder thread (and the source's buffers) never hang on a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch):
        with span("data.to_device"):
            t = torch.as_tensor(np.asarray(batch, np.float32))
            if copy_stream is None:
                return t.to(device), None
            with torch.cuda.stream(copy_stream):
                out = t.pin_memory().to(device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return out, ready

    def feeder():
        try:
            try:
                for batch in batches:
                    if not put(to_device(batch)):
                        return
            except BaseException as e:  # surface pipeline failures in the consumer
                put(e)
            else:
                put(sentinel)
        finally:
            # the feeder iterates `batches`, so closing here runs the source's
            # own teardown (decode pool, shuffle buffer) on the same thread
            close = getattr(batches, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            out, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                out.record_stream(consumer)
            yield out
    finally:
        stop.set()
        try:  # drain so a feeder mid-put wakes at once
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
