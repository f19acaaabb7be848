"""TFRecord container codec and the image Example schema (counterpart of
faststyle_tpu/data/tfrecord.py).

Record framing and CRCs run in host C++ (`csrc/tfrecord_io.cc`, built at
first use by the host compiler and called through ctypes); a failed build
raises. The pure-Python CRC, framing and scan are kept as the plain
versions the C++ is held to (`plain=True`, and the tests). The subset of the
protobuf wire format that `tf.train.Example` needs is written out here.

Example schema (the reference writer's):
  image/encoded    bytes   JPEG bytes
  image/height     int64
  image/width      int64
  image/channels   int64   (always 3)
  image/colorspace bytes   'RGB'
  image/format     bytes   'JPEG'
  image/filename   bytes
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Tuple, Union

from faststyle_tpu_torch.ops.cuda import build

_MASK_DELTA = 0xA282EAD8
# (offset, length) slots per C++ scan call: a fixed window, not one
# proportional to the buffer
_SCAN_WINDOW = 65536


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/tfrecord_io.cc, built on first use; raises if it cannot be."""
    lib = build.load("tfrecord_io")
    lib.fs_masked_crc32c.restype = ctypes.c_uint32
    lib.fs_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.fs_scan_records.restype = ctypes.c_long
    lib.fs_scan_records.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.fs_frame_record.restype = None
    lib.fs_frame_record.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    return lib


# ---------------------------------------------------------------------------
# crc32c: the plain (table-driven Python) version
# ---------------------------------------------------------------------------


def _crc_table() -> Tuple[int, ...]:
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return tuple(table)


_CRC_TABLE = _crc_table()


def _masked_crc_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """crc32c of `data`, masked as TFRecords and LevelDB store it."""
    return _lib().fs_masked_crc32c(data, len(data))


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------


def _frame_record_py(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc_py(header))
        + data
        + struct.pack("<I", _masked_crc_py(data))
    )


def frame_record(data: bytes) -> bytes:
    """data -> length | crc(length) | data | crc(data)."""
    out = ctypes.create_string_buffer(len(data) + 16)
    _lib().fs_frame_record(data, len(data), out)
    return out.raw


def _scan_buffer(buf: bytes, verify: bool, path) -> Tuple[List[bytes], int]:
    """Scan the complete records in `buf` in C++; return (payloads, bytes
    consumed). A trailing partial record is left for the caller to carry."""
    lib = _lib()
    out: List[bytes] = []
    total = len(buf)
    offsets = (ctypes.c_long * _SCAN_WINDOW)()
    lengths = (ctypes.c_long * _SCAN_WINDOW)()
    base = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value  # `buf` stays referenced
    pos = 0
    while pos + 16 <= total:
        n = lib.fs_scan_records(
            ctypes.c_void_p(base + pos), total - pos, offsets, lengths, _SCAN_WINDOW, int(verify)
        )
        if n < 0:
            raise ValueError(f"{path}: corrupt TFRecord (crc mismatch)")
        if n == 0:
            break
        for i in range(n):
            start = pos + offsets[i]
            out.append(buf[start : start + lengths[i]])
        pos += offsets[n - 1] + lengths[n - 1] + 4
    return out, pos


def _scan_buffer_py(buf: bytes, verify: bool, path) -> Tuple[List[bytes], int]:
    """The plain version of `_scan_buffer`, in Python."""
    out: List[bytes] = []
    total = len(buf)
    pos = 0
    while pos + 12 <= total:
        (length,) = struct.unpack_from("<Q", buf, pos)
        (len_crc,) = struct.unpack_from("<I", buf, pos + 8)
        if _masked_crc_py(buf[pos : pos + 8]) != len_crc:
            raise ValueError(f"{path}: corrupt TFRecord (length crc)")
        start = pos + 12
        if start + length + 4 > total:
            break
        data = buf[start : start + length]
        if verify:
            (data_crc,) = struct.unpack_from("<I", buf, start + length)
            if _masked_crc_py(data) != data_crc:
                raise ValueError(f"{path}: corrupt TFRecord (data crc)")
        out.append(data)
        pos = start + length + 4
    return out, pos


def iter_records(
    path: Union[str, Path],
    *,
    verify: bool = False,
    chunk_bytes: int = 64 << 20,
    plain: bool = False,
) -> Iterator[bytes]:
    """Yield the payload of every record in a TFRecord file.

    Streams the file in `chunk_bytes` reads, so a multi-GB shard never sits
    whole in host RAM: peak memory is one chunk plus the largest record
    straddling a chunk boundary. A truncated final record ends the stream
    silently (as TF's RecordReader does); a CRC mismatch raises ValueError.
    `plain=True` scans with the Python version instead of the C++ one.
    """
    scan = _scan_buffer_py if plain else _scan_buffer
    with open(path, "rb") as f:
        buf = b""
        while True:
            data = f.read(chunk_bytes)
            buf = buf + data if buf else data
            records, consumed = scan(buf, verify, path)
            yield from records
            if not data:
                return  # EOF: anything unconsumed is a truncated tail
            if consumed:
                buf = buf[consumed:]
            # consumed == 0 with more data: a record straddles the chunk
            # boundary (or exceeds chunk_bytes), so keep reading


class RecordWriter:
    """Append framed records to a file."""

    def __init__(self, path: Union[str, Path]):
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        self._f.write(frame_record(data))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# minimal tf.train.Example wire codec
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _feature_bytes(value: bytes) -> bytes:
    # Feature{ bytes_list(1) { value(1): bytes } }
    return _len_delim(1, _len_delim(1, value))


def _feature_int64(value: int) -> bytes:
    # Feature{ int64_list(3) { value(1): varint } }  (float_list is field 2)
    return _len_delim(3, _varint(1 << 3) + _varint(value))


def encode_image_example(
    encoded: bytes,
    height: int,
    width: int,
    filename: str = "",
    *,
    channels: int = 3,
    colorspace: bytes = b"RGB",
    image_format: bytes = b"JPEG",
) -> bytes:
    """Serialize a tf.train.Example with the reference writer's schema."""
    feats = {
        "image/encoded": _feature_bytes(encoded),
        "image/height": _feature_int64(height),
        "image/width": _feature_int64(width),
        "image/channels": _feature_int64(channels),
        "image/colorspace": _feature_bytes(colorspace),
        "image/format": _feature_bytes(image_format),
        "image/filename": _feature_bytes(filename.encode()),
    }
    body = b""
    for key, feat in feats.items():
        # Features.feature map entry: key(1), value(2)=Feature
        entry = _len_delim(1, key.encode()) + _len_delim(2, feat)
        body += _len_delim(1, entry)  # Features.feature (map field 1)
    return _len_delim(1, body)  # Example.features (field 1)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def decode_example(buf: bytes) -> Dict[str, Union[bytes, int]]:
    """Parse an Example into {feature_name: last value} (bytes or int)."""
    out: Dict[str, Union[bytes, int]] = {}
    for f, _w, features in _iter_fields(buf):
        if f != 1:
            continue
        for f2, _w2, entry in _iter_fields(features):
            if f2 != 1:
                continue
            key = None
            feature = b""
            for f3, _w3, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    feature = v3
            if key is None:
                continue
            for f4, _w4, v4 in _iter_fields(feature):
                if f4 == 1:  # bytes_list
                    for f5, _w5, v5 in _iter_fields(v4):
                        if f5 == 1:
                            out[key] = v5
                elif f4 == 3:  # int64_list, packed or not
                    for f5, w5, v5 in _iter_fields(v4):
                        if f5 != 1:
                            continue
                        if w5 == 0:
                            out[key] = v5
                        else:  # packed: varints inside a length-delimited blob
                            pos = 0
                            while pos < len(v5):
                                out[key], pos = _read_varint(v5, pos)
                elif f4 == 2:  # float_list: not in the schema, kept raw
                    out[key] = v4
    return out
