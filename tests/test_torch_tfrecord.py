"""The port's TFRecord codec, dataset writer and writer CLI against the JAX
package's, on the CPU: CRCs, framing, shards and Examples byte for byte,
the writer's shard names, file order and records on the same directory."""

import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu.data import tfrecord as jrecord  # noqa: E402
from faststyle_tpu.data import writer as jwriter  # noqa: E402
from faststyle_tpu_torch.cli import tfrecords_writer as cli  # noqa: E402
from faststyle_tpu_torch.data import tfrecord, writer  # noqa: E402
from faststyle_tpu_torch.utils import image_io  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _payloads(seed=7, sizes=(1, 4000, 70000, 3, 150000, 0, 9000)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


def test_crc_known_vector():
    """RFC 3720: crc32c of 32 zero bytes is 0x8a9136aa, stored masked."""
    crc = 0x8A9136AA
    masked = (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    data = b"\x00" * 32
    assert tfrecord.masked_crc32c(data) == tfrecord._masked_crc_py(data) == masked
    assert jrecord._masked_crc_py(data) == masked


def test_crc_matches_jax_on_random_lengths():
    """The C++ and the plain CRC equal the JAX package's plain CRC on
    lengths 0-10000 (every slice-by-8 tail from 0 to 7 included)."""
    rng = np.random.default_rng(0)
    lengths = list(range(17)) + rng.integers(0, 10001, 40).tolist() + [10000]
    for n in lengths:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = jrecord._masked_crc_py(data)
        assert tfrecord.masked_crc32c(data) == want, n
        assert tfrecord._masked_crc_py(data) == want, n


@pytest.mark.parametrize("payload", [b"", b"hello", b"x" * 1000, bytes(range(256)) * 40])
def test_frame_record_matches_jax(payload):
    framed = tfrecord.frame_record(payload)
    assert framed == jrecord.frame_record(payload) == tfrecord._frame_record_py(payload)
    assert struct.unpack_from("<Q", framed)[0] == len(payload)


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
@pytest.mark.parametrize("plain", [False, True])
def test_shards_cross_read(tmp_path, writer_pkg, plain):
    """A shard written by either package reads back identically through
    the other's reader and through the port's C++ and plain scanners."""
    payloads = _payloads()
    path = tmp_path / "shard.tfrecord"
    with (tfrecord if writer_pkg == "port" else jrecord).RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    assert list(tfrecord.iter_records(path, verify=True, plain=plain)) == payloads
    assert list(jrecord.iter_records(path, verify=True)) == payloads


@pytest.mark.parametrize("plain", [False, True])
def test_streaming_keeps_straddling_records_and_drops_a_truncated_tail(tmp_path, plain):
    """64 KiB chunks: the 70K and 150K records exceed a chunk, the others
    straddle chunk boundaries; all come back intact. A truncated final
    record is dropped silently."""
    payloads = _payloads()
    path = tmp_path / "big.tfrecord"
    with tfrecord.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    assert list(tfrecord.iter_records(path, verify=True, chunk_bytes=64 * 1024, plain=plain)) == payloads
    path.write_bytes(path.read_bytes()[:-5])
    got = list(tfrecord.iter_records(path, verify=True, chunk_bytes=64 * 1024, plain=plain))
    assert got == payloads[:-1]


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("where", [3, 20])  # the length's CRC, a payload byte
def test_corrupt_shard_raises(tmp_path, plain, where):
    path = tmp_path / "bad.tfrecord"
    with tfrecord.RecordWriter(path) as w:
        w.write(b"data" * 100)
    raw = bytearray(path.read_bytes())
    raw[where] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        list(tfrecord.iter_records(path, verify=True, plain=plain))


def test_example_codec_matches_jax():
    args = (b"\xff\xd8jpegdata" * 50, 480, 640, "a.jpg")
    ours = tfrecord.encode_image_example(*args)
    assert ours == jrecord.encode_image_example(*args)
    dec = tfrecord.decode_example(ours)
    assert dec == jrecord.decode_example(ours)
    assert dec == {
        "image/encoded": args[0], "image/height": 480, "image/width": 640, "image/channels": 3,
        "image/colorspace": b"RGB", "image/format": b"JPEG", "image/filename": b"a.jpg",
    }


def _image_dir(tmp_path, n=10):
    """JPEGs of two sizes, one PNG and one grayscale JPEG."""
    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(n):
        image_io.imwrite(d / f"img_{i:03d}.jpg", rng.integers(0, 255, (40 + i % 2 * 8, 30, 3), dtype=np.uint8))
    image_io.imwrite(d / "p.png", rng.integers(0, 255, (33, 21, 3), dtype=np.uint8))
    import cv2

    cv2.imwrite(str(d / "gray.jpg"), rng.integers(0, 255, (24, 20), dtype=np.uint8))
    (d / "notes.txt").write_text("not an image")
    return d


def test_write_dataset_matches_jax(tmp_path):
    """The same shard names, file order and records, byte for byte; the
    PNG and the grayscale JPEG are re-encoded 3-channel JPEGs."""
    d = _image_dir(tmp_path)
    assert [p.name for p in writer.find_image_files(d)] == [p.name for p in jwriter.find_image_files(d)]
    ours = writer.write_dataset(d, tmp_path / "port", num_shards=4, num_threads=2)
    theirs = jwriter.write_dataset(d, tmp_path / "jax", num_shards=4, num_threads=2)
    assert [p.name for p in ours] == [p.name for p in theirs] == [f"train-{i:05d}-of-00004" for i in range(4)]
    names = []
    for a, b in zip(ours, theirs):
        recs = list(tfrecord.iter_records(a, verify=True))
        assert recs == list(jrecord.iter_records(b, verify=True))
        for rec in recs:
            ex = tfrecord.decode_example(rec)
            img = image_io.imdecode(ex["image/encoded"])
            assert img.shape == (ex["image/height"], ex["image/width"], 3)
            assert ex["image/encoded"][:2] == b"\xff\xd8"  # JPEG
            names.append(ex["image/filename"].decode())
    assert names == [p.name for p in writer.find_image_files(d)]
    assert {"p.png", "gray.jpg"} <= set(names)


def test_write_dataset_checks_the_shard_split(tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        writer.write_dataset(_image_dir(tmp_path), tmp_path / "o", num_shards=3, num_threads=2)


def test_writer_thread_failure_raises(tmp_path, monkeypatch):
    class Boom(tfrecord.RecordWriter):
        def write(self, data):
            raise OSError("disk full")

    monkeypatch.setattr(tfrecord, "RecordWriter", Boom)
    with pytest.raises(RuntimeError, match="writer thread"):
        writer.write_dataset(_image_dir(tmp_path), tmp_path / "o", num_shards=2, num_threads=2)


def test_imdecode_matches_jax():
    from faststyle_tpu.utils import image_io as jimage_io

    data = (ROOT / "tests" / "assets" / "chicago.jpg").read_bytes()
    np.testing.assert_array_equal(image_io.imdecode(data), jimage_io.imdecode(data))
    with pytest.raises(ValueError):
        image_io.imdecode(b"not an image")


def test_cli_defaults_match_jax_and_write_shards(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_tfrecords_writer", ROOT / "cli" / "tfrecords_writer.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    assert vars(cli.setup_parser().parse_args([])) == vars(jcli.setup_parser().parse_args([]))
    paths = cli.main(["--train_directory", str(_image_dir(tmp_path)), "--output_directory", str(tmp_path / "r"),
                      "--train_shards", "2", "--num_threads", "1"])
    assert [p.name for p in paths] == ["train-00000-of-00002", "train-00001-of-00002"]
    assert sum(len(list(tfrecord.iter_records(p, verify=True))) for p in paths) == 12
