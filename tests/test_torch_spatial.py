"""The port's row-sharded serving (faststyle_tpu_torch.parallel.spatial) on
lists of CPU entries: one frame's rows over 2-8 shards against the port's
own single-device forward, and one 2-way case against the JAX package's
SpatialStylizer on two virtual CPU devices.

Tolerances are tests/test_parallel.py's: 5e-2 of 255 against the single
device (the shards add their partial IN sums in another order than one
reduction), 1e-4 between uint8 and float32 input of the same values; halo
8 must leak by more than 0.5. The JAX package's spatial tests are all
marked slow, so the port is held mostly to itself here, at small sizes.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu_torch.inference import _as_torch_params, load_params_numpy  # noqa: E402
from faststyle_tpu_torch.models import transform_net  # noqa: E402
from faststyle_tpu_torch.ops import layers as L  # noqa: E402
from faststyle_tpu_torch.ops.cuda import instance_norm  # noqa: E402
from faststyle_tpu_torch.parallel import spatial  # noqa: E402
from faststyle_tpu_torch.parallel.spatial import SpatialStylizer, spatial_stylize_fn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 5e-2


@pytest.fixture(scope="module")
def starry():
    return load_params_numpy(ROOT / "weights" / "starry_final.npz")


def _single(params, img, method="resize"):
    p = _as_torch_params(params, torch.device("cpu"))
    with torch.inference_mode():
        return transform_net.apply(p, torch.as_tensor(img, dtype=torch.float32)[None], method)[0].numpy()


def _frame(seed, h, w):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


def test_four_way_ragged_width_matches_single_device(starry):
    img = _frame(0, 96, 43)
    s = SpatialStylizer(starry, ["cpu"] * 4)
    assert s.shards_for(96) == 4
    out = s(img)
    assert out.shape == (96, 44, 3) and out.dtype == np.float32  # 43 -> 44 columns by the shape law
    np.testing.assert_allclose(out, _single(starry, img), atol=ATOL)


def test_eight_way_halo_16_exact_and_halo_8_leaks(starry):
    """The contamination bound: halo 16 is exact (the default 24 carries a
    margin); halo 8 must leak, or the bound is stale and the default can
    shrink."""
    img = _frame(2, 256, 64)
    ref = _single(starry, img)
    ok = SpatialStylizer(starry, ["cpu"] * 8, halo=16)
    assert ok.shards_for(256) == 8
    np.testing.assert_allclose(ok(img), ref, atol=ATOL)
    leaky = SpatialStylizer(starry, ["cpu"] * 8, halo=8)(img)
    assert np.abs(leaky - ref).max() > 0.5


def test_shards_for_reduces_to_an_aligned_count_and_falls_back_exactly(starry):
    s = SpatialStylizer(starry, ["cpu"] * 8)
    assert [s.shards_for(h) for h in (2160, 4320, 120, 122)] == [6, 8, 6, 1]
    img = _frame(3, 120, 64)
    np.testing.assert_allclose(s(img), _single(starry, img), atol=ATOL)
    # no aligned n at all: the single-device forward itself, bit for bit
    img2 = _frame(4, 122, 64)
    np.testing.assert_array_equal(s(img2), _single(starry, img2))


def test_deconv_matches_single_device():
    params = transform_net.init_params(torch.Generator().manual_seed(7), "deconv", device="cpu")
    img = _frame(5, 128, 64)
    out = SpatialStylizer(params, ["cpu"] * 4, upsample_method="deconv")(img)
    np.testing.assert_allclose(out, _single(params, img, "deconv"), atol=ATOL)


@pytest.mark.parametrize("h", [120, 122], ids=["sharded", "fallback"])
def test_uint8_and_float_input_agree_whichever_shard_count(starry, h):
    """Both normalize to float32 before dispatch, so the 1-way fallback does
    not take the uint8-in, clipped-uint8-out forward."""
    s = SpatialStylizer(starry, ["cpu"] * 8)
    u8 = np.random.default_rng(6).integers(0, 256, (h, 64, 3), dtype=np.uint8)
    got = s(u8)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, s(u8.astype(np.float32)), atol=1e-4)


def test_the_walk_yields_its_16_instance_norms_in_schedule_order(starry):
    """The walk stops at each of the 16 instance norms; sent the plain norm
    and its epilogue it is bit-identical with apply, and the extents follow
    _in_layer_schedule."""
    p = _as_torch_params(starry, torch.device("cpu"))
    h, w = 96, 40
    x = torch.as_tensor(_frame(7, h, w))[None]
    seen = []
    with torch.inference_mode():
        steps = transform_net._walk_steps(p, L.reflect_pad(x, 40), "resize")
        try:
            t = next(steps)
            while True:
                seen.append(t.x.shape[1])
                t = steps.send(instance_norm.epilogue_plain(L.instance_norm(t.x, t.scale, t.shift), t.then, t.skip))
        except StopIteration as done:
            got = done.value
        want = transform_net.apply(p, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert seen == [extent for extent, _ in spatial._in_layer_schedule(h)]
    assert len(seen) == 16


@pytest.mark.parametrize("h", [96, 256, 1080, 2160, 4320])
def test_in_layer_schedule_is_the_jax_packages(h):
    from faststyle_tpu.parallel.spatial import _in_layer_schedule

    assert spatial._in_layer_schedule(h) == _in_layer_schedule(h)


def test_two_way_matches_the_jax_spatial_stylizer(starry, starry_params):
    import jax

    from faststyle_tpu.parallel import mesh as jmesh
    from faststyle_tpu.parallel.spatial import SpatialStylizer as JaxSpatialStylizer

    img = _frame(8, 96, 43)
    ref = JaxSpatialStylizer(starry_params, jmesh.data_mesh(jax.devices()[:2]), halo=16)(img)
    s = SpatialStylizer(starry, ["cpu"] * 2, halo=16)
    assert s.shards_for(96) == 2
    out = s(img)
    assert out.shape == ref.shape == (96, 44, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_refuses_misaligned_heights_halos_and_windows(starry):
    with pytest.raises(ValueError, match="H % \\(4\\*n\\) == 0"):
        spatial_stylize_fn(starry, 100, 40, ["cpu"] * 2)
    with pytest.raises(ValueError, match="halo must be a multiple of 4"):
        spatial_stylize_fn(starry, 96, 40, ["cpu"] * 2, halo=6)
    with pytest.raises(ValueError, match="image too small to shard 2 ways"):
        spatial_stylize_fn(starry, 48, 40, ["cpu"] * 2, halo=24)
    with pytest.raises(ValueError, match="built for 96x40 frames"):
        spatial_stylize_fn(starry, 96, 40, ["cpu"] * 2)(_frame(9, 96, 44))


def test_a_shard_that_raises_stops_the_frame_and_the_forward_runs_again(starry, monkeypatch):
    """An error inside one shard's walk at its third IN call surfaces as
    that error; the same forward then runs a frame to the right answer."""
    real = spatial._spatial_norms

    def flaky(pending, call, *args):
        if call == 2:
            raise ArithmeticError("IN call 3 failed")
        return real(pending, call, *args)

    fn = spatial_stylize_fn(starry, 96, 40, ["cpu"] * 4)
    img = _frame(10, 96, 40)
    monkeypatch.setattr(spatial, "_spatial_norms", flaky)
    with pytest.raises(ArithmeticError, match="IN call 3 failed"):
        fn(img)
    monkeypatch.setattr(spatial, "_spatial_norms", real)
    np.testing.assert_allclose(fn(img).numpy(), _single(starry, img), atol=ATOL)


def test_a_walk_with_another_number_of_in_calls_is_refused(starry, monkeypatch):
    """Every shard's walk must stop at exactly the schedule's 16 IN calls."""
    fn = spatial_stylize_fn(starry, 96, 40, ["cpu"] * 2)
    img = _frame(11, 96, 40)
    short = spatial._in_layer_schedule(96)[:15]
    monkeypatch.setattr(spatial, "_in_layer_schedule", lambda h: short)
    with pytest.raises(RuntimeError, match="more IN calls than the schedule's 15"):
        spatial_stylize_fn(starry, 96, 40, ["cpu"] * 2)(img)
    monkeypatch.setattr(spatial, "_in_layer_schedule", lambda h: short + short[-1:] * 2)
    with pytest.raises(RuntimeError, match="a walk ended after 16 IN calls; the schedule has 17"):
        spatial_stylize_fn(starry, 96, 40, ["cpu"] * 2)(img)
    assert fn(img).shape == (96, 40, 3)
