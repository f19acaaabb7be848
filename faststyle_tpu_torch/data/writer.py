"""Offline dataset converter: a directory of JPEG/PNG files -> sharded
TFRecords (counterpart of faststyle_tpu/data/writer.py).

The reference converter's contract:
  * a flat input directory of *.jpg / *.jpeg / *.png;
  * a deterministic shuffle with seed 12345 (`random.Random`);
  * `num_shards % num_threads == 0`;
  * PNGs and non-3-channel sources re-encoded to JPEG;
  * shard names `<name>-XXXXX-of-NNNNN`;
  * the Example schema of `data.tfrecord.encode_image_example`.

Host threads each write a contiguous range of shards; a thread's failure
(an unwritable shard) fails the conversion.
"""

from __future__ import annotations

import random
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

from faststyle_tpu_torch.data import tfrecord
from faststyle_tpu_torch.utils import image_io

_EXTS = {".jpg", ".jpeg", ".png"}


def find_image_files(directory: str | Path, seed: int = 12345) -> List[Path]:
    """The directory's image files, sorted, then shuffled from `seed`."""
    files = sorted(p for p in Path(directory).iterdir() if p.suffix.lower() in _EXTS)
    random.Random(seed).shuffle(files)
    return files


def _encode_jpeg(img: np.ndarray) -> bytes:
    try:
        import cv2
    except ImportError:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        return buf.getvalue()
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    if not ok:
        raise ValueError("jpeg encode failed")
    return enc.tobytes()


def _native_channels(data: bytes) -> int:
    """Channel count of the encoded image as stored (imdecode forces RGB,
    so its output cannot show a grayscale or CMYK source)."""
    try:
        import cv2
    except ImportError:
        import io

        from PIL import Image

        return len(Image.open(io.BytesIO(data)).getbands())
    raw = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise ValueError("undecodable")
    return 1 if raw.ndim == 2 else raw.shape[2]


def _process_file(path: Path) -> tuple[bytes, int, int]:
    """(jpeg_bytes, height, width) of one file. The schema says channels=3
    and RGB, so PNGs and non-RGB sources are re-encoded to JPEG from their
    RGB decode; RGB JPEGs are stored as they are."""
    data = path.read_bytes()
    img = image_io.imdecode(data)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: expected 3-channel RGB, got {img.shape}")
    if path.suffix.lower() == ".png" or _native_channels(data) != 3:
        data = _encode_jpeg(img.astype(np.uint8))
    return data, img.shape[0], img.shape[1]


def write_dataset(
    directory: str | Path,
    output_dir: str | Path,
    name: str = "train",
    num_shards: int = 8,
    num_threads: int = 4,
    seed: int = 12345,
    log_every: int = 1000,
) -> List[Path]:
    """Convert `directory` into `num_shards` TFRecord files; returns their paths."""
    if num_shards % num_threads:
        raise ValueError("num_shards must be divisible by num_threads")
    files = find_image_files(directory, seed)
    if not files:
        raise ValueError(f"no images found in {directory}")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    # files split across shards as evenly as possible
    spacing = np.linspace(0, len(files), num_shards + 1).astype(int)
    shard_paths = [output_dir / f"{name}-{i:05d}-of-{num_shards:05d}" for i in range(num_shards)]
    lock = threading.Lock()
    errors: List[str] = []
    fatal: List[BaseException] = []
    processed = 0

    def worker(shard_ids: Sequence[int]):
        nonlocal processed
        try:
            for si in shard_ids:
                with tfrecord.RecordWriter(shard_paths[si]) as w:
                    for path in files[spacing[si] : spacing[si + 1]]:
                        try:
                            jpeg, h, width = _process_file(path)
                        except Exception as e:  # an unreadable file is skipped and counted
                            with lock:
                                errors.append(f"{path}: {e}")
                            continue
                        w.write(tfrecord.encode_image_example(jpeg, h, width, path.name))
                        with lock:
                            processed += 1
                            if processed % log_every == 0:
                                print(f"[writer] {processed}/{len(files)} images")
        except BaseException as e:
            # a shard-level failure (a full disk, an unopenable output path)
            # must fail the conversion: missing shards would train on part
            # of the data
            with lock:
                fatal.append(e)

    per_thread = num_shards // num_threads
    threads = [
        threading.Thread(target=worker, args=(range(t * per_thread, (t + 1) * per_thread),))
        for t in range(num_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if fatal:
        raise RuntimeError(f"{len(fatal)} writer thread(s) failed; dataset is incomplete") from fatal[0]
    if errors:
        print(f"[writer] skipped {len(errors)} unreadable files")
    print(f"[writer] wrote {processed} images into {num_shards} shards")
    return shard_paths
