"""The port's transform net and VGG16 tower against the JAX package's, with
the same weights and inputs, float32 on the CPU.

Tolerances: the transform net's output is in [0, 255] after 16 convs and
16 instance norms; float32 sums in another order (oneDNN vs XLA) leave
differences of order 1e-4 there, so atol 2e-3 (out of 255) with rtol 1e-5.
The VGG tower gets rtol 1e-4 relative to each activation's largest value."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from faststyle_tpu.inference import load_params as jax_load_params  # noqa: E402
from faststyle_tpu.models import transform_net as JT  # noqa: E402
from faststyle_tpu.models import vgg16 as JV  # noqa: E402
from faststyle_tpu_torch import convert  # noqa: E402
from faststyle_tpu_torch.inference import load_params  # noqa: E402
from faststyle_tpu_torch.models import transform_net as TT  # noqa: E402
from faststyle_tpu_torch.models import vgg16 as TV  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "path,method",
    [("weights/starry_final.npz", "resize"), ("tests/assets/deconv_oracle_net.npz", "deconv")],
)
def test_transform_net_matches_jax(rng, path, method):
    np_params = jax_load_params(ROOT / path)
    x = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JT.apply(np_params, jnp.asarray(x), method, layout="naive"))
    params = load_params(ROOT / path, device="cpu")
    got = TT.apply(params, torch.from_numpy(x), method)
    assert got.shape == ref.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-3)


def test_transform_net_features_and_ragged_shape(rng, starry_params):
    """The taps of apply_with_features and the shape law at a ragged size
    (30 x 37 -> 32 x 40), against the JAX walk."""
    x = rng.uniform(0, 255, (2, 30, 37, 3)).astype(np.float32)
    ref_y, ref_f = JT.apply_with_features(starry_params, jnp.asarray(x))
    y, f = TT.apply_with_features(convert.params_from_numpy(starry_params, device="cpu"), torch.from_numpy(x))
    assert tuple(y.shape) == (2, *TT.output_shape(30, 37), 3) == ref_y.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-5, atol=2e-3)
    assert f.keys() == ref_f.keys()
    for k in f:
        np.testing.assert_allclose(f[k].numpy(), np.asarray(ref_f[k]), rtol=1e-4, atol=1e-3, err_msg=k)


def test_transform_net_uint8_and_bf16(rng, starry_params):
    """uint8 in -> uint8 out (clip on the device), and a bf16 conv stack
    stays close to float32 (bf16 keeps ~3 significant digits: a few counts
    out of 255)."""
    params = convert.params_from_numpy(starry_params, device="cpu")
    x = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    y8 = TT.apply(params, torch.from_numpy(x))
    assert y8.dtype == torch.uint8
    ref8 = np.asarray(JT.apply(starry_params, jnp.asarray(x), layout="naive"))
    assert np.abs(y8.numpy().astype(int) - ref8.astype(int)).max() <= 1
    yf = TT.apply(params, torch.from_numpy(x.astype(np.float32)))
    yb = TT.apply(params, torch.from_numpy(x.astype(np.float32)), compute_dtype=torch.bfloat16)
    assert yb.dtype == torch.float32
    assert float((yb - yf).abs().mean()) < 4.0


def test_resize_upsample_reference_formulation(rng, starry_params):
    """The literal resize-then-conv upsample (fused_upsample=False), the
    oracle of the fused phase form, against the JAX walk."""
    params = convert.params_from_numpy(starry_params, device="cpu")
    x = rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(JT.apply(starry_params, jnp.asarray(x), layout="naive", fused_upsample=False))
    got = TT.apply(params, torch.from_numpy(x), fused_upsample=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-3)


def test_deconv_transposed_formulation(rng):
    """The literal transposed convs (fused_upsample=False), the oracle of the
    deconv net's phase forms, against the JAX walk at a ragged size."""
    np_params = jax_load_params(ROOT / "tests/assets/deconv_oracle_net.npz")
    params = convert.params_from_numpy(np_params, device="cpu")
    x = rng.uniform(0, 255, (1, 30, 37, 3)).astype(np.float32)
    ref = np.asarray(JT.apply(np_params, jnp.asarray(x), "deconv", layout="naive"))
    for fused in (False, True):
        got = TT.apply(params, torch.from_numpy(x), "deconv", fused_upsample=fused)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-3, err_msg=f"fused={fused}")


@pytest.mark.parametrize(
    "method,path", [("resize", "weights/starry_final.npz"), ("deconv", "tests/assets/deconv_oracle_net.npz")]
)
def test_init_params_shapes_and_stats(method, path):
    """The file-layout shapes of a trained net of each variant, and the
    reference's distributions: std 0.1 convs, std 1 upsample convs, IN
    affine 1 / 0."""
    ref = jax_load_params(ROOT / path)
    got = convert.params_to_numpy(TT.init_params(torch.Generator().manual_seed(0), method, device="cpu"))
    assert got.keys() == ref.keys()
    for blk in ref:
        assert got[blk].keys() == ref[blk].keys()
        for var in ref[blk]:
            assert got[blk][var].shape == ref[blk][var].shape, (blk, var)
    assert abs(got["resblock_0"]["W1"].std() - 0.1) < 0.01
    assert abs(got["upsample_0"]["W"].std() - 1.0) < 0.05
    np.testing.assert_array_equal(got["upsample_2"]["INscale"], 1.0)


def test_transform_net_module_is_apply(rng, starry_params):
    params = convert.params_from_numpy(starry_params, device="cpu")
    net = TT.TransformNet(params)
    x = torch.from_numpy(rng.uniform(0, 255, (1, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(net(x), TT.apply(params, x), rtol=0, atol=0)
    assert len(list(net.parameters())) == sum(len(v) for v in params.values())


_VGG_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]


@pytest.fixture(scope="module")
def vgg_np():
    """Random VGG16 weights from numpy, He-scaled so activations stay O(1)-O(100)."""
    rng = np.random.default_rng(7)
    names = [n for n in JV.LAYER_ORDER if n.startswith("conv")]
    params, cin = {}, 3
    for name, cout in zip(names, _VGG_CHANNELS):
        w = rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))
        params[name] = {"W": w.astype(np.float32), "b": rng.standard_normal(cout).astype(np.float32)}
        cin = cout
    return params


def test_vgg_tower_matches_jax(rng, vgg_np):
    x = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    layers = ["conv1_2", "pool1", "conv2_2", "conv3_3", "pool3", "conv4_3"]
    ref = JV.apply(vgg_np, jnp.asarray(x), layers)
    got = TV.apply(convert.params_from_numpy(vgg_np, device="cpu"), torch.from_numpy(x), layers)
    assert got.keys() == set(layers)
    for name in layers:
        r = np.asarray(ref[name])
        np.testing.assert_allclose(got[name].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_vgg_truncates_and_odd_pools(rng, vgg_np):
    """Truncation at the deepest requested layer, and SAME pools on odd
    extents (a 20 x 13 input pools to 10x7, 5x4, 3x2)."""
    x = rng.uniform(0, 255, (1, 20, 13, 3)).astype(np.float32)
    params = convert.params_from_numpy(vgg_np, device="cpu")
    got = TV.apply(params, torch.from_numpy(x), ["conv1_1", "pool3"])
    ref = JV.apply(vgg_np, jnp.asarray(x), ["conv1_1", "pool3"])
    assert set(got) == {"conv1_1", "pool3"}
    assert tuple(got["pool3"].shape) == ref["pool3"].shape == (1, 3, 2, 256)
    r = np.asarray(ref["pool3"])
    np.testing.assert_allclose(got["pool3"].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())
    with pytest.raises(ValueError):
        TV.apply(params, torch.from_numpy(x), ["conv9_9"])


@pytest.mark.parametrize("pool,layers", [("pool1", ["conv2_2", "pool2"]), ("pool3", ["conv4_1", "conv4_3"])])
def test_vgg_input_layer_continues_the_tower(rng, vgg_np, pool, layers):
    """apply(pool activation, input_layer=pool) gives the full tower's
    deeper activations, as the JAX package's continuation does."""
    x = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    params = convert.params_from_numpy(vgg_np, device="cpu")
    full = TV.apply(params, torch.from_numpy(x), [pool] + layers)
    got = TV.apply(params, full[pool], layers, input_layer=pool)
    ref = JV.apply(vgg_np, jnp.asarray(full[pool].numpy()), layers, input_layer=pool)
    assert got.keys() == set(layers)
    for name in layers:
        torch.testing.assert_close(got[name], full[name], rtol=0, atol=0)
        r = np.asarray(ref[name])
        np.testing.assert_allclose(got[name].numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize(
    "input_layer,layers,match",
    [("conv2_1", ["conv3_1"], "pool boundary"), ("pool2", ["conv2_2", "conv3_1"], "cannot be computed"),
     ("pool3", ["pool2"], "end before")],
)
def test_vgg_input_layer_rejects(vgg_np, input_layer, layers, match):
    params = convert.params_from_numpy(vgg_np, device="cpu")
    with pytest.raises(ValueError, match=match):
        TV.apply(params, torch.zeros(1, 4, 4, 128), layers, input_layer=input_layer)


def test_vgg_load_npz_and_layer_order(tmp_path, vgg_np):
    flat = {f"{n}_{k}": v for n, p in vgg_np.items() for k, v in p.items()}
    flat["fc6_W"] = np.zeros((2, 2), np.float32)
    np.savez(tmp_path / "vgg.npz", **flat)
    params = TV.load_npz(tmp_path / "vgg.npz", device="cpu")
    ref = JV.load_npz(tmp_path / "vgg.npz")
    assert params.keys() == ref.keys()
    np.testing.assert_array_equal(convert.kernel_to_file(params["conv2_1"]["W"]), ref["conv2_1"]["W"])
    assert TV.LAYER_ORDER == JV.LAYER_ORDER
    assert TV.layer_index("conv4_3") == JV.layer_index("conv4_3")
    np.savez(tmp_path / "bad.npz", conv1_1_mean=np.zeros(3, np.float32), **flat)
    with pytest.raises(ValueError):
        TV.load_npz(tmp_path / "bad.npz", device="cpu")


def test_vgg_init_params_shapes(vgg_np):
    got = TV.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert got.keys() == vgg_np.keys()
    for name in vgg_np:
        assert convert.kernel_to_file(got[name]["W"]).shape == vgg_np[name]["W"].shape
        assert float(got[name]["W"].abs().max()) <= 0.2 + 1e-6  # truncated at 2 std
