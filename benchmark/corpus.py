"""The training corpus: synthetic JPEGs in TFRecord shards, written by the
benchmark's own frozen writer (not the program's), once per checkout.

The corpus stands for MS-COCO: `count` images of `height` x `width`, made
from the traffic's corpus seed (the same corpus in every run, as a dataset
is; the run's seed picks the Batcher's order and the net's weights), JPEG
at `quality`, as tf.train.Example records (`image/encoded` and the
reference converter's other keys) with TFRecord's masked CRC32C framing.
It is cached at a fixed path inside the checkout, keyed by its parameters:
`build/benchmark/corpus-<key>/` with `index.json` (each image's shard,
JPEG offset and length) and `signatures.npy` (each image's 4x4 grid of mean
colours, which finds an image again in a resized batch row).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from benchmark.frames import smooth_fields
from benchmark.harness import derive_seed

WRITER_VERSION = 1
GRID = 4

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), as TFRecord frames it
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78
_LANE = 256  # bytes per lane of the vectorised pass


def _byte_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table[i] = c
    return table


_TABLE = _byte_table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _advance_tables(nbytes: int) -> list[list[int]]:
    """The CRC register's linear map over `nbytes` zero bytes, as four
    byte-indexed tables: advance(x) = T0[x & 255] ^ T1[x >> 8 & 255] ^ ..."""
    basis = np.array([1 << b for b in range(32)], np.uint32)
    for _ in range(nbytes):
        basis = _TABLE[basis & 0xFF] ^ (basis >> 8)
    values = np.arange(256)
    tables = []
    for k in range(4):
        t = np.zeros(256, np.uint32)
        for j in range(8):
            t[(values >> j) & 1 == 1] ^= basis[8 * k + j]
        tables.append([int(v) for v in t])
    return tables


_ADVANCE = _advance_tables(_LANE)


def crc32c(data: bytes) -> int:
    """CRC32C of `data`: a head of len % 256 bytes byte by byte, then 256-byte
    lanes in parallel (numpy), combined by the register's advance over a
    lane. The CRC is linear, so the lanes' registers add up (xor) once each
    is advanced over the lanes after it."""
    n = len(data)
    head = n % _LANE
    crc = 0xFFFFFFFF
    for b in data[:head]:
        crc = _TABLE_LIST[(crc ^ b) & 0xFF] ^ (crc >> 8)
    lanes = (n - head) // _LANE
    if lanes:
        cols = np.frombuffer(data, np.uint8, offset=head).reshape(lanes, _LANE).T.copy()
        state = np.zeros(lanes, np.uint32)
        state[0] = crc
        for j in range(_LANE):
            state = _TABLE[(state ^ cols[j]) & 0xFF] ^ (state >> 8)
        t0, t1, t2, t3 = _ADVANCE
        crc = 0
        for s in state.tolist():
            crc = t0[crc & 0xFF] ^ t1[(crc >> 8) & 0xFF] ^ t2[(crc >> 16) & 0xFF] ^ t3[crc >> 24] ^ s
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, the data's masked CRC."""
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", masked_crc32c(length)) + data + struct.pack("<I", masked_crc32c(data))


# ---------------------------------------------------------------------------
# tf.train.Example, by hand
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    return _varint((number << 3) | 2) + _varint(len(payload)) + payload


def _bytes_feature(value: bytes) -> bytes:
    return _field(1, _field(1, value))  # Feature.bytes_list.value


def _int64_feature(value: int) -> bytes:
    return _field(3, _field(1, _varint(value)))  # Feature.int64_list, packed


def image_example(jpeg: bytes, height: int, width: int, name: str) -> tuple[bytes, int]:
    """The serialized Example and the offset of the JPEG's bytes inside it."""
    feats = [
        ("image/encoded", _bytes_feature(jpeg)),
        ("image/height", _int64_feature(height)),
        ("image/width", _int64_feature(width)),
        ("image/channels", _int64_feature(3)),
        ("image/colorspace", _bytes_feature(b"RGB")),
        ("image/format", _bytes_feature(b"JPEG")),
        ("image/filename", _bytes_feature(name.encode())),
    ]
    entries = b"".join(_field(1, _field(1, key.encode()) + _field(2, value)) for key, value in feats)
    example = _field(1, entries)
    return example, example.index(jpeg)


# ---------------------------------------------------------------------------
# The corpus
# ---------------------------------------------------------------------------


@dataclass
class Corpus:
    dir: Path
    files: list[Path]
    images: list[tuple[int, int, int]]  # (shard, JPEG offset, JPEG length)
    signatures: np.ndarray  # [count, GRID, GRID, 3] float32

    def jpeg(self, i: int) -> bytes:
        shard, offset, length = self.images[i]
        with open(self.files[shard], "rb") as f:
            f.seek(offset)
            return f.read(length)


def grid_means(imgs: np.ndarray) -> np.ndarray:
    """[n, h, w, 3] -> [n, GRID, GRID, 3] float32 mean colours (h and w
    divisible by GRID)."""
    n, h, w, c = imgs.shape
    return imgs.reshape(n, GRID, h // GRID, GRID, w // GRID, c).astype(np.float32).mean(axis=(2, 4))


def _encode(img: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def ensure(root: Path, spec: dict, count: int, device) -> Corpus:
    """The corpus for `spec` (the traffic's `corpus`) and `count` images,
    written under `root/build/benchmark/` unless it is there already."""
    key_src = json.dumps({"spec": spec, "count": count, "version": WRITER_VERSION}, sort_keys=True)
    key = hashlib.sha256(key_src.encode()).hexdigest()[:16]
    out = Path(root) / "build" / "benchmark" / f"corpus-{key}"
    if not (out / "index.json").is_file():
        _write(out, spec, count, device)
    index = json.loads((out / "index.json").read_text())
    return Corpus(out, [out / f for f in index["files"]], [tuple(i) for i in index["images"]],
                  np.load(out / "signatures.npy"))


def _write(out: Path, spec: dict, count: int, device) -> None:
    shards = spec["shards"]
    if count % shards:
        raise ValueError(f"{count} images do not split into {shards} shards")
    per = count // shards
    h, w = spec["height"], spec["width"]
    staging = out.with_name(out.name + ".partial")
    shutil.rmtree(staging, ignore_errors=True)
    staging.mkdir(parents=True)
    files, images, sigs = [], [], []
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for s in range(shards):
            imgs = smooth_fields(per, h, w, spec["content"], derive_seed(spec["seed"], f"shard{s}"), device)
            imgs = imgs.cpu().numpy()
            sigs.append(grid_means(imgs))
            jpegs = list(pool.map(lambda im: _encode(im, spec["quality"]), imgs))
            name = f"train-{s:05d}-of-{shards:05d}"
            pos = 0
            with open(staging / name, "wb") as f:
                for j, jpeg in enumerate(jpegs):
                    example, at = image_example(jpeg, h, w, f"{s:05d}_{j:05d}.jpg")
                    record = frame_record(example)
                    f.write(record)
                    images.append((s, pos + 12 + at, len(jpeg)))  # 12: the length and its CRC
                    pos += len(record)
            files.append(name)
    np.save(staging / "signatures.npy", np.concatenate(sigs))
    (staging / "index.json").write_text(json.dumps({"files": files, "images": images}))
    shutil.rmtree(out, ignore_errors=True)
    os.rename(staging, out)
