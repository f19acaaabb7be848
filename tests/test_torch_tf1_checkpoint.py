"""The port's TF1 checkpoint reader and writer against the JAX package's,
bit-exact: the same bytes on disk, the same arrays read back."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402  (the JAX package's bfloat16; the port decodes without it)

from faststyle_tpu.compat import tf1_checkpoint as J  # noqa: E402
from faststyle_tpu.data import tfrecord as jrecord  # noqa: E402
from faststyle_tpu.inference import load_params as jax_load_params  # noqa: E402
from faststyle_tpu_torch.compat import tf1_checkpoint as P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def starry():
    return jax_load_params(ROOT / "weights" / "starry_final.npz")


def _assert_params_equal(got, want):
    assert got.keys() == want.keys()
    for blk in want:
        assert got[blk].keys() == want[blk].keys()
        for var in want[blk]:
            assert got[blk][var].dtype == np.float32
            np.testing.assert_array_equal(got[blk][var], np.asarray(want[blk][var]))


def test_port_reads_jax_written_checkpoint(tmp_path, starry):
    J.save_transform_net_params(starry, tmp_path / "starry_final.ckpt")
    _assert_params_equal(P.load_transform_net_params(tmp_path / "starry_final.ckpt"), starry)


def test_jax_reads_port_written_checkpoint(tmp_path, starry):
    """The port's writer gives the JAX writer's bytes, and the JAX reader
    reads them back exactly."""
    P.save_transform_net_params(starry, tmp_path / "port.ckpt")
    J.save_transform_net_params(starry, tmp_path / "jax.ckpt")
    for suffix in (".index", ".data-00000-of-00001"):
        assert (tmp_path / f"port.ckpt{suffix}").read_bytes() == (tmp_path / f"jax.ckpt{suffix}").read_bytes()
    _assert_params_equal(J.load_transform_net_params(tmp_path / "port.ckpt"), starry)


def test_writer_roundtrip_mixed_dtypes(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "a/W": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
        "z/scalar": np.float32(3.25).reshape(()),
        "m/ints": rng.integers(-5, 5, (7, 2)).astype(np.int32),
        "h/half": rng.standard_normal(5).astype(np.float16),
    }
    P.save_checkpoint(tmp_path / "rt.ckpt", tensors)
    for back in (P.load_checkpoint(tmp_path / "rt.ckpt"), J.load_checkpoint(tmp_path / "rt.ckpt")):
        assert sorted(back) == sorted(tensors)
        for k in tensors:
            assert back[k].dtype == tensors[k].dtype
            np.testing.assert_array_equal(back[k], tensors[k])


def test_bfloat16_entry_decodes_like_jax(tmp_path):
    """A DT_BFLOAT16 entry (written by the JAX writer through ml_dtypes)
    reads as float32 holding exactly the JAX reader's bfloat16 values,
    including signs, zeros, infinities and the largest finite value."""
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.standard_normal(61) * 100, [0.0, -0.0, np.inf, -np.inf, 3.3895e38]])
    bf = vals.astype(ml_dtypes.bfloat16).reshape(6, 11)
    J.save_checkpoint(tmp_path / "bf.ckpt", {"x/bf": bf, "x/f": np.arange(4, dtype=np.float32)})
    got = P.load_checkpoint(tmp_path / "bf.ckpt")
    want = J.load_checkpoint(tmp_path / "bf.ckpt")
    assert got["x/bf"].dtype == np.float32 and got["x/bf"].shape == (6, 11)
    np.testing.assert_array_equal(got["x/bf"], want["x/bf"].astype(np.float32))
    np.testing.assert_array_equal(np.signbit(got["x/bf"]), np.signbit(want["x/bf"].astype(np.float32)))
    np.testing.assert_array_equal(got["x/f"], want["x/f"])


def test_snappy_hand_built_block():
    """literal 'abcd' + copy(offset=4, len=8) -> 'abcdabcdabcd', as the JAX
    package's test builds it; both decompressors agree."""
    data = bytes([12]) + bytes([(4 - 1) << 2]) + b"abcd" + bytes([((8 - 4) << 2) | 1, 4])
    assert P._snappy_decompress(data) == J._snappy_decompress(data) == b"abcdabcdabcd"


@pytest.mark.parametrize(
    "data,match",
    [
        (bytes([5, (2 << 2)]) + b"abc", "corrupt snappy"),  # header promises 5 bytes, gives 3
        (bytes([4, 0]) + b"a" + bytes([1, 0]), "copy offset"),  # copy with offset 0
    ],
)
def test_snappy_corrupt_blocks_raise(data, match):
    with pytest.raises(ValueError, match=match):
        P._snappy_decompress(data)


def test_masked_crc32c_matches_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert P.masked_crc32c(data) == jrecord._masked_crc_py(data)


def test_missing_scope_raises(tmp_path):
    P.save_checkpoint(tmp_path / "other.ckpt", {"net/a/W": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="img_t_net"):
        P.load_transform_net_params(tmp_path / "other.ckpt")
