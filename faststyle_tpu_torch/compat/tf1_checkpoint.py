"""TF1 tensor_bundle checkpoints without TensorFlow (the port's own copy of
faststyle_tpu/compat/tf1_checkpoint.py).

The reference ships its transform nets as TF1 `Saver` V2 checkpoints: a
`<prefix>.index` file, a LevelDB-format SSTable that maps variable names to
serialized `BundleEntryProto`s (plus an empty-key `BundleHeaderProto`), and
`<prefix>.data-NNNNN-of-NNNNN` shards with the raw little-endian tensor
bytes at the (offset, size) of each entry. This module reads that format
(footer, block handles, prefix-compressed keys, optional snappy blocks, the
few protobuf fields needed) and writes it (sorted names, masked-crc32c
checksums, as TF's tensor_bundle writer does).

Everything is numpy; nothing here needs torch. bfloat16 entries (DT_BFLOAT16)
decode without a bfloat16 numpy type: each 16-bit value is the top half of
a float32, so they come back as float32 with the same values.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np

_SSTABLE_MAGIC = 0xDB4775248B80FB57
_DT_BFLOAT16 = 14

# TF DataType enum -> numpy dtype (the subset a faststyle checkpoint can
# hold); DT_BFLOAT16 is read as its raw 16 bits and widened to float32
_TF_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    7: np.bytes_,
    9: np.int64,
    10: np.bool_,
    _DT_BFLOAT16: np.uint16,
    19: np.float16,
}


# ---------------------------------------------------------------------------
# varint / crc32c / protobuf-lite helpers
# ---------------------------------------------------------------------------


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


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


_CRC_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_MASK_DELTA = 0xA282EAD8


def _crc_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
        table.append(crc)
    return tuple(table)


_CRC_TABLE = _crc_table()


def masked_crc32c(data: bytes) -> int:
    """crc32c of `data`, masked as LevelDB and TFRecords store it."""
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def _iter_proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated field 2 = Dim{1: size}."""
    dims = []
    for field, _wire, val in _iter_proto_fields(buf):
        if field == 2:
            size = 0
            for f2, _w2, v2 in _iter_proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


class BundleEntry:
    __slots__ = ("tf_dtype", "dtype", "shape", "shard_id", "offset", "size", "crc32c")

    def __init__(self, buf: bytes):
        self.tf_dtype = 1
        self.dtype = np.float32
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = 0
        for field, _wire, val in _iter_proto_fields(buf):
            if field == 1:
                self.tf_dtype = val
                self.dtype = _TF_DTYPES[val]
            elif field == 2:
                self.shape = _parse_shape(val)
            elif field == 3:
                self.shard_id = val
            elif field == 4:
                self.offset = val
            elif field == 5:
                self.size = val
            elif field == 6:
                self.crc32c = val


# ---------------------------------------------------------------------------
# snappy (block format): a minimal decompressor for compressed SSTable blocks
# ---------------------------------------------------------------------------


def _snappy_decompress(data: bytes) -> bytes:
    out_len, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                ln = int.from_bytes(data[pos : pos + nbytes], "little")
                pos += nbytes
            ln += 1
            out += data[pos : pos + ln]
            pos += ln
        else:
            if kind == 1:  # copy, 1-byte offset
                ln = ((tag >> 2) & 0x7) + 4
                off = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:  # copy, 2-byte offset
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:  # copy, 4-byte offset
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            start = len(out) - off
            if off == 0 or start < 0:
                # only corrupt input has a zero or overlong back-reference
                raise ValueError(
                    f"corrupt snappy block: copy offset {off} at output position {len(out)}"
                )
            for i in range(ln):  # may overlap itself; byte by byte is correct
                out.append(out[start + i])
    # a raise, not an assert: this guards file integrity under `python -O` too
    if len(out) != out_len:
        raise ValueError(
            f"corrupt snappy block: decompressed {len(out)} bytes, header promised {out_len}"
        )
    return bytes(out)


# ---------------------------------------------------------------------------
# SSTable reader
# ---------------------------------------------------------------------------


def _read_block(raw: bytes, offset: int, size: int) -> bytes:
    """Fetch a block given its handle; handles the 1-byte compression tag."""
    block = raw[offset : offset + size]
    ctype = raw[offset + size]  # trailer: compression byte + crc32
    if ctype == 0:
        return block
    if ctype == 1:
        return _snappy_decompress(block)
    raise ValueError(f"unsupported block compression {ctype}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) from a prefix-compressed LevelDB block."""
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _read_handle(buf: bytes, pos: int) -> Tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def read_index(index_path: str | Path) -> Dict[str, BundleEntry]:
    """Parse a `.index` file into {variable_name: BundleEntry}."""
    raw = Path(index_path).read_bytes()
    magic = struct.unpack_from("<Q", raw, len(raw) - 8)[0]
    if magic != _SSTABLE_MAGIC:
        raise ValueError(f"{index_path}: not an SSTable (bad magic)")
    footer = raw[len(raw) - 48 :]
    _mi_off, _mi_sz, pos = _read_handle(footer, 0)  # metaindex (unused)
    idx_off, idx_sz, _ = _read_handle(footer, pos)

    entries: Dict[str, BundleEntry] = {}
    index_block = _read_block(raw, idx_off, idx_sz)
    for _key, handle in _iter_block_entries(index_block):
        off, sz, _ = _read_handle(handle, 0)
        for key, value in _iter_block_entries(_read_block(raw, off, sz)):
            if key == b"":  # BundleHeaderProto
                continue
            entries[key.decode()] = BundleEntry(value)
    return entries


def load_checkpoint(prefix: str | Path) -> Dict[str, np.ndarray]:
    """Load every tensor of a TF1 V2 checkpoint given its path prefix, e.g.
    `models/starry_final.ckpt` for the files `<prefix>.index` and
    `<prefix>.data-XXXXX-of-NNNNN`. bfloat16 tensors come back as float32."""
    prefix = Path(prefix)
    entries = read_index(prefix.with_name(prefix.name + ".index"))
    num_shards = 1 + max(e.shard_id for e in entries.values())
    shards = [
        prefix.with_name(f"{prefix.name}.data-{i:05d}-of-{num_shards:05d}").read_bytes()
        for i in range(num_shards)
    ]
    out: Dict[str, np.ndarray] = {}
    for name, e in entries.items():
        raw = shards[e.shard_id][e.offset : e.offset + e.size]
        arr = np.frombuffer(raw, dtype=e.dtype).reshape(e.shape)
        if e.tf_dtype == _DT_BFLOAT16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


# ---------------------------------------------------------------------------
# faststyle-specific conversion
# ---------------------------------------------------------------------------


def load_transform_net_params(prefix: str | Path, scope: str = "img_t_net") -> Dict[str, Dict[str, np.ndarray]]:
    """A reference transform-net checkpoint as `{block: {var: array}}`: the
    variables `img_t_net/{initconv_k,resblock_k,upsample_k}/{W,W1,W2,
    INscale*,INshift*}`, in the file layouts (HWIO, as the `.npz` keeps them)."""
    tensors = load_checkpoint(prefix)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in tensors.items():
        parts = name.split("/")
        if parts[0] != scope or len(parts) != 3:
            continue
        params.setdefault(parts[1], {})[parts[2]] = arr
    if not params:
        raise ValueError(f"no '{scope}/*' variables found in {prefix}")
    return params


# ---------------------------------------------------------------------------
# Writer: models trained with the port export to the reference's format, so
# its TF1 stack (Saver.restore) loads them unchanged
# ---------------------------------------------------------------------------

_NP_TO_TF = {np.dtype(k): v for v, k in _TF_DTYPES.items() if k not in (np.bytes_, np.uint16)}


def _encode_handle(offset: int, size: int) -> bytes:
    return _write_varint(offset) + _write_varint(size)


def _build_block(items) -> bytes:
    """LevelDB block: no prefix compression (shared=0 is always valid), one
    restart point. `items` = sorted (key, value) byte pairs."""
    body = bytearray()
    for key, value in items:
        body += _write_varint(0) + _write_varint(len(key)) + _write_varint(len(value))
        body += key + value
    body += struct.pack("<I", 0)  # restart[0]
    body += struct.pack("<I", 1)  # num_restarts
    return bytes(body)


def _append_block(out: bytearray, block: bytes) -> Tuple[int, int]:
    """Append block + trailer (type 0, masked crc32c of data+type); return
    its BlockHandle (offset, size), as leveldb's table builder does."""
    offset, size = len(out), len(block)
    out += block
    out += b"\x00"
    out += struct.pack("<I", masked_crc32c(block + b"\x00"))
    return offset, size


def _shape_proto(shape) -> bytes:
    out = b""
    for d in shape:
        dim = b"\x08" + _write_varint(int(d))  # Dim.size = field 1 varint
        out += b"\x12" + _write_varint(len(dim)) + dim  # shape.dim = field 2
    return out


def _entry_proto(arr: np.ndarray, offset: int, crc: int) -> bytes:
    shp = _shape_proto(arr.shape)
    out = b"\x08" + _write_varint(_NP_TO_TF[arr.dtype])  # dtype = field 1
    out += b"\x12" + _write_varint(len(shp)) + shp  # shape = field 2
    # shard_id (field 3) omitted == 0
    if offset:
        out += b"\x20" + _write_varint(offset)  # offset = field 4
    out += b"\x28" + _write_varint(arr.nbytes)  # size = field 5
    out += b"\x35" + struct.pack("<I", crc)  # crc32c = field 6, fixed32
    return out


def _header_proto(num_shards: int = 1) -> bytes:
    version = b"\x08\x01"  # VersionDef.producer = 1
    return (
        b"\x08" + _write_varint(num_shards)  # num_shards = field 1
        # endianness (field 2) omitted == LITTLE
        + b"\x1a" + _write_varint(len(version)) + version  # version = field 3
    )


def save_checkpoint(prefix: str | Path, tensors: Dict[str, np.ndarray]) -> None:
    """Write a TF1 V2 checkpoint (`<prefix>.index` +
    `<prefix>.data-00000-of-00001`) that `tf.train.Saver.restore`,
    `tf.train.load_checkpoint` and `load_checkpoint` above read. Tensors lie
    in sorted-name order with masked-crc32c entry checksums, as TF's
    tensor_bundle writer lays them."""
    prefix = Path(prefix)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    data = bytearray()
    items = [(b"", _header_proto())]
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _NP_TO_TF:
            raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
        raw = arr.tobytes()
        items.append((name.encode(), _entry_proto(arr, len(data), masked_crc32c(raw))))
        data += raw
    prefix.with_name(prefix.name + ".data-00000-of-00001").write_bytes(bytes(data))

    out = bytearray()
    d_off, d_sz = _append_block(out, _build_block(items))
    m_off, m_sz = _append_block(out, _build_block([]))  # empty metaindex
    idx_items = [(items[-1][0], _encode_handle(d_off, d_sz))]
    i_off, i_sz = _append_block(out, _build_block(idx_items))
    footer = _encode_handle(m_off, m_sz) + _encode_handle(i_off, i_sz)
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _SSTABLE_MAGIC)
    out += footer
    prefix.with_name(prefix.name + ".index").write_bytes(bytes(out))


def save_transform_net_params(params, prefix: str | Path, scope: str = "img_t_net") -> None:
    """Export `{block: {var: array}}` (file layouts) as a reference-named
    checkpoint, `img_t_net/<block>/<var>`: the inverse of
    load_transform_net_params."""
    tensors = {
        f"{scope}/{blk}/{var}": np.asarray(arr, np.float32)
        for blk, sub in params.items()
        for var, arr in sub.items()
    }
    save_checkpoint(prefix, tensors)
