"""The port's serving path against the JAX package's, on the CPU: params
resolution, the Stylizer (float32, uint8, packed-u8 I/O), the host pack and
unpack, SSIM against the TF oracles, the quantize warning and warmup.

Tolerances: float32 output within 1e-2 (of 255) of a float64 run of the
port's walk, for the port and for the JAX Stylizer's naive walk alike
(both measure 5e-3 at crop256: float32 rounding through 16 convs and 16
instance norms over 65536 pixels). The 2e-3 that `tests/test_torch_models.py`
holds the two walks to at 64x64 does not hold here: the port's own CPU
float32 forward differs between two processes by up to 6.4e-3 at crop256
(oneDNN's summation order), so agreement with JAX at 2e-3 is chance. The
JAX Stylizer picks its packed TPU layout on its own; the float32 check
forces its naive walk, the function the port computes. uint8 output
within one count of the JAX Stylizer as it is (packed walk), where a value
near a rounding boundary may round either way. Packed-u8 I/O and host
pack/unpack: bit-exact."""

import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu import inference as jinf  # noqa: E402
from faststyle_tpu.models import transform_net as JT  # noqa: E402
from faststyle_tpu.utils import image_io as jimage_io  # noqa: E402
from faststyle_tpu.utils import metrics as jmetrics  # noqa: E402
from faststyle_tpu_torch import inference as tinf  # noqa: E402
from faststyle_tpu_torch.compat import tf1_checkpoint  # noqa: E402
from faststyle_tpu_torch.models import transform_net as TT  # noqa: E402
from faststyle_tpu_torch.utils import metrics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ASSETS = ROOT / "tests" / "assets"
STARRY = ROOT / "weights" / "starry_final.npz"
DECONV = ASSETS / "deconv_oracle_net.npz"
# (model, upsample method, crop of chicago_crop256 or None, TF oracle)
CASES = [
    (STARRY, "resize", None, "starry_crop256_tf_oracle.png"),
    (DECONV, "deconv", (250, 243), "deconv_ragged_tf_oracle.png"),
]
IDS = ["starry-crop256", "deconv-250x243"]


def _image(crop):
    img = jimage_io.imread(ASSETS / "chicago_crop256.png")
    return img if crop is None else np.ascontiguousarray(img[: crop[0], : crop[1]])


@pytest.fixture
def jax_naive(monkeypatch):
    """The JAX Stylizer with its layout choice forced to the naive walk."""
    monkeypatch.setattr(JT, "packed_layout_supported", lambda *a, **k: False)


# ---------------------------------------------------------------------------
# load_params
# ---------------------------------------------------------------------------


def test_load_params_reads_tf1_prefix_first(tmp_path):
    """A TF1 prefix wins over a `.npz` of the same stem; the params equal
    the checkpoint's on the requested device."""
    ref = jinf.load_params(STARRY)
    tf1_checkpoint.save_transform_net_params(ref, tmp_path / "m.ckpt")
    np.savez(tmp_path / "m.npz", **{"initconv_0/W": np.zeros((9, 9, 3, 16), np.float32)})
    got = tinf.load_params_numpy(tmp_path / "m.ckpt")
    for blk in ref:
        for var in ref[blk]:
            np.testing.assert_array_equal(got[blk][var], ref[blk][var])
    params = tinf.load_params(tmp_path / "m.ckpt", device="cpu")
    assert params["initconv_0"]["W"].device.type == "cpu"
    assert tuple(params["initconv_0"]["W"].shape) == (16, 3, 9, 9)  # OIHW


@pytest.mark.parametrize("name", ["m.ckpt", "m"])
def test_load_params_resolves_to_npz(tmp_path, name):
    ref = jinf.load_params(STARRY)
    jinf.save_params(tmp_path / "m.npz", ref)
    got = tinf.load_params_numpy(tmp_path / name)
    np.testing.assert_array_equal(got["resblock_2"]["W1"], ref["resblock_2"]["W1"])


def test_load_params_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tinf.load_params(tmp_path / "nothing.ckpt", device="cpu")


# ---------------------------------------------------------------------------
# Stylizer against the JAX Stylizer and the TF oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,method,crop,_oracle", CASES, ids=IDS)
def test_stylizer_float32_matches_jax(jax_naive, model, method, crop, _oracle):
    x = _image(crop)[None].astype(np.float32)
    want = np.asarray(jinf.Stylizer(model, upsample_method=method).stylize_batch(x))
    got = tinf.Stylizer(model, upsample_method=method, device="cpu").stylize_batch(x)
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, *TT.output_shape(*x.shape[1:3]), 3)
    params64 = {b: {v: t.double() for v, t in sub.items()} for b, sub in tinf.load_params(model, device="cpu").items()}
    ref = TT.apply(params64, torch.from_numpy(x).double(), method).numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-2)
    np.testing.assert_allclose(want, ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("model,method,crop,_oracle", CASES, ids=IDS)
def test_stylizer_uint8_within_one_count_of_jax(model, method, crop, _oracle):
    x = _image(crop)[None]
    want = np.asarray(jinf.Stylizer(model, upsample_method=method, output_uint8=True).stylize_batch(x))
    got = tinf.Stylizer(model, upsample_method=method, output_uint8=True, device="cpu").stylize_batch(x)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("model,method,crop,oracle", CASES, ids=IDS)
def test_ssim_against_tf_oracle(model, method, crop, oracle):
    """SSIM >= 0.99 against the TF oracle PNG, and the port's ssim equals
    the JAX package's on the same arrays within 1e-12."""
    golden = jimage_io.imread(ASSETS / oracle)
    out = tinf.Stylizer(model, upsample_method=method, device="cpu")(_image(crop))
    assert out.dtype == np.uint8 and out.shape == golden.shape
    score = metrics.ssim(out, golden)
    assert score >= 0.99, score
    assert abs(score - jmetrics.ssim(out, golden)) <= 1e-12
    assert abs(metrics.psnr(out, golden) - jmetrics.psnr(out, golden)) <= 1e-12


# ---------------------------------------------------------------------------
# packed-u8 I/O
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed_input,packed_output", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("hw", [(256, 256), (250, 243), (59, 83)])
@pytest.mark.parametrize("model,method", [(STARRY, "resize"), (DECONV, "deconv")], ids=["resize", "deconv"])
def test_packed_io_equals_plain_uint8(model, method, hw, packed_input, packed_output):
    x = _image(hw)[None] if hw != (59, 83) else np.random.default_rng(3).integers(0, 256, (2, 59, 83, 3), np.uint8)
    params = tinf.load_params(model, device="cpu")
    want = tinf.Stylizer(params=params, upsample_method=method, output_uint8=True, device="cpu").stylize_batch(x)
    s = tinf.Stylizer(
        params=params, upsample_method=method, packed_input=packed_input, packed_output=packed_output, device="cpu"
    )
    raw = s.stylize_batch(x)
    oh, ow = TT.output_shape(*hw)
    assert raw.dtype == torch.uint8
    if packed_output:
        assert tuple(raw.shape) == (x.shape[0], -(-oh // 4), -(-ow // 4), 48)
        got = tinf.unpack_u8_host(raw.numpy(), oh, ow)
    else:
        got = raw.numpy()
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(s(x[0]), want[0].numpy())  # __call__ unpacks itself


def test_packed_output_matches_jax_packed_output_within_one_count():
    """The packed tensor has the JAX package's shape and cell order."""
    x = _image((250, 243))[None]
    want = np.asarray(jinf.Stylizer(STARRY, packed_output=True).stylize_batch(x))
    got = tinf.Stylizer(STARRY, packed_output=True, device="cpu").stylize_batch(x).numpy()
    assert got.shape == want.shape == (1, 63, 61, 48)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_apply_packed_checks_its_arguments():
    params = tinf.load_params(STARRY, device="cpu")
    x8 = torch.zeros(1, 48, 48, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="input_hw"):
        TT.apply_packed(params, torch.zeros(1, 32, 32, 48, dtype=torch.uint8), input_layout="packed_u8")
    with pytest.raises(ValueError, match="implies uint8"):
        TT.apply_packed(params, x8.float(), output_layout="packed_u8")
    with pytest.raises(ValueError, match="layouts"):
        TT.apply_packed(params, x8, output_layout="nchw")
    assert TT.apply_packed(params, x8.float(), output_dtype=torch.uint8, output_layout="packed_u8").shape == (
        1, 12, 12, 48)


# ---------------------------------------------------------------------------
# host pack / unpack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 96), (59, 83), (41, 41)])
def test_host_pack_unpack_match_jax_and_plain(hw):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    packed = tinf.pack_u8_host(x)
    assert packed.shape == tinf.packed_shape(2, *hw)
    np.testing.assert_array_equal(packed, jinf.pack_u8_host(x))
    np.testing.assert_array_equal(packed, tinf.pack_u8_plain(x))
    hb, wb = -(-hw[0] // 4), -(-hw[1] // 4)
    raw = rng.integers(0, 256, (2, hb, wb, 48), dtype=np.uint8)
    out = tinf.unpack_u8_host(raw, *hw)
    np.testing.assert_array_equal(out, jinf.unpack_u8_host(raw, *hw))
    np.testing.assert_array_equal(out, tinf.unpack_u8_plain(raw, *hw))
    # the device-side relayouts are the same maps
    np.testing.assert_array_equal(TT.unpack_u8(torch.from_numpy(raw), *hw).numpy(), out)
    np.testing.assert_array_equal(TT.pack_u8(torch.from_numpy(out)).numpy(), tinf.pack_u8_plain(out, pad=0))


@pytest.mark.parametrize("hw", [(256, 384), (250, 243)])
def test_host_slabs_equal_one_slab(monkeypatch, hw):
    """Many row slabs on the pool (ragged-tail memset and overhang guard
    included) give the single slab's bytes, into a caller's buffer too."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (1, *hw, 3), dtype=np.uint8)
    hb, wb = -(-hw[0] // 4), -(-hw[1] // 4)
    raw = rng.integers(0, 256, (1, hb, wb, 48), dtype=np.uint8)
    monkeypatch.setattr(tinf, "_HOST_WORKERS", 4)
    monkeypatch.setattr(tinf, "_MIN_ROWS_PER_SLAB", 8)
    out = np.full(tinf.packed_shape(1, *hw), 7, np.uint8)
    packed_par = tinf.pack_u8_host(x, out=out)
    assert packed_par is out
    unpacked_par = tinf.unpack_u8_host(raw, *hw)
    monkeypatch.setattr(tinf, "_HOST_WORKERS", 1)
    np.testing.assert_array_equal(packed_par, tinf.pack_u8_host(x))
    np.testing.assert_array_equal(unpacked_par, tinf.unpack_u8_host(raw, *hw))


def test_host_pack_rejects_bad_input():
    with pytest.raises(ValueError, match="reflect pad"):
        tinf.pack_u8_host(np.zeros((1, 40, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        tinf.pack_u8_host(np.zeros((1, 64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="out must be"):
        tinf.pack_u8_host(np.zeros((1, 64, 64, 3), np.uint8), out=np.zeros((1, 35, 36, 48), np.uint8))
    with pytest.raises(ValueError, match="inconsistent"):
        tinf.unpack_u8_host(np.zeros((1, 4, 4, 48), np.uint8), 17, 16)


# ---------------------------------------------------------------------------
# quantize warning, warmup, params forms
# ---------------------------------------------------------------------------


def test_packed_input_float_frames_warn_once_per_instance():
    params = jinf.load_params(STARRY)
    fimg = np.random.default_rng(0).uniform(0, 255, (1, 48, 44, 3)).astype(np.float32)
    s = tinf.Stylizer(params=params, packed_input=True, packed_output=True, device="cpu")
    with pytest.warns(UserWarning, match="quantizing to uint8"):
        got = s.stylize_batch(fimg).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any warning now fails the test
        again = s.stylize_batch(fimg).numpy()  # once per instance only
        u8 = s.stylize_batch(np.clip(fimg, 0, 255).astype(np.uint8)).numpy()  # uint8 never warns
    np.testing.assert_array_equal(got, again)
    np.testing.assert_array_equal(got, u8)
    s2 = tinf.Stylizer(params=params, packed_input=True, packed_output=True, device="cpu")
    with pytest.warns(UserWarning, match="quantizing to uint8"):
        s2.stylize_batch(fimg)


@pytest.mark.parametrize(
    "flags,want",
    [
        ({}, [torch.float32]),
        ({"output_uint8": True}, [torch.uint8, torch.float32]),
        ({"packed_input": True}, [torch.uint8]),
    ],
)
def test_warmup_runs_each_dtype_signature(monkeypatch, flags, want):
    s = tinf.Stylizer(STARRY, device="cpu", **flags)
    seen = []
    fwd = s._fwd
    monkeypatch.setattr(s, "_fwd", lambda p, x, hw=None: seen.append(x.dtype) or fwd(p, x, hw))
    s.warmup(48, 44)
    assert seen == want
    seen.clear()
    s.warmup(48, 44, dtypes=[np.uint8])
    assert seen == want[:1]  # uint8 frames become float32 unless uint8 comes out


def test_stylizer_takes_torch_or_numpy_params():
    np_params = jinf.load_params(STARRY)
    x = np.random.default_rng(4).integers(0, 256, (1, 24, 20, 3), dtype=np.uint8)
    a = tinf.Stylizer(params=np_params, output_uint8=True, device="cpu").stylize_batch(x)
    b = tinf.Stylizer(params=tinf.load_params(STARRY, device="cpu"), output_uint8=True, device="cpu").stylize_batch(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="model_path or params"):
        tinf.Stylizer(device="cpu")
    with pytest.raises(ValueError, match="upsample_method"):
        tinf.Stylizer(STARRY, upsample_method="bilinear", device="cpu")


def test_profiling_helpers(tmp_path):
    """hard_sync on the CPU (nothing to wait for), trace() writes a Chrome
    trace, and the stylize mode's operation count follows the net's shapes
    (the same count for the JAX package's shape law)."""
    from faststyle_tpu_torch.utils import profiling

    x = torch.ones(4, 4)
    profiling.hard_sync({"a": [x]})
    with profiling.trace(tmp_path / "tr"):
        (x @ x).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert TT.output_shape(1080, 1920) == JT.output_shape(1080, 1920)
    assert profiling.stylize_ops(1080, 1920) == 162454302720.0
