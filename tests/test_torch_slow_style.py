"""The port's Gatys slow-style against the JAX package's, float32 on the CPU
at 32x32 pixels, with one random VGG16 (numpy seed, He-scaled) written as a
Frossard `.npz` and loaded by both packages.

Tolerances: the loss and its pixel gradient within rtol 1e-4 (float32 sums
through the VGG tower in another order; the gradient relative to its
largest entry). Adam at lr 10 moves each pixel by about lr per step in a
direction set by the ratios of its gradients, and an entry whose gradient
is within that 1e-4 of zero may move the other way: so after 3 steps from
the same start, the first loss (same pixels) within rtol 1e-4, the later
ones within 5e-3 (measured: up to 1.1e-3), every pixel within
2 * lr * steps of the JAX package's (measured: up to 32) and half of them
within 1 (measured median: 0.07-0.18)."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from faststyle_tpu import losses as jlosses  # noqa: E402
from faststyle_tpu.cli import slow_style as jcli  # noqa: E402
from faststyle_tpu.models import vgg16 as JV  # noqa: E402
from faststyle_tpu.training import slow_style as jslow  # noqa: E402
from faststyle_tpu_torch.cli import slow_style as cli  # noqa: E402
from faststyle_tpu_torch.models import vgg16 as TV  # noqa: E402
from faststyle_tpu_torch.training import slow_style as tslow  # noqa: E402

SIZE = 32
LR = 10.0
CONTENT = {"conv3_3": 1.0}
STYLE = {"conv1_2": 5.0, "conv2_2": 5.0, "conv3_3": 5.0, "conv4_3": 5.0}
BETA = 1e-4


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    rng = np.random.default_rng(11)
    flat, cin = {}, 3
    for name in [n for n in JV.LAYER_ORDER if n.startswith("conv")]:
        cout = {1: 64, 2: 128, 3: 256}.get(int(name[4]), 512)
        flat[f"{name}_W"] = (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2 / (9 * cin))).astype(np.float32)
        flat[f"{name}_b"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        cin = cout
    path = tmp_path_factory.mktemp("vgg") / "vgg16_random.npz"
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    content = 127 + 100 * np.sin(2 * np.pi * (xx + 2 * yy))[..., None] * np.array([1.0, 0.5, -0.7])
    content = np.clip(content + rng.normal(0, 10, content.shape), 0, 255).astype(np.float32)
    style = rng.uniform(0, 255, (40, 36, 3)).astype(np.float32)
    return content, style


def _jax_init(seed=0):
    """The JAX optimize's own white-noise start for a [1, SIZE, SIZE, 3] image."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (1, SIZE, SIZE, 3), jnp.float32) * 255.0)


def test_loss_and_pixel_gradient_match_jax(vgg_path, images):
    content, style = images
    jvgg = JV.load_npz(vgg_path)
    tvgg = TV.load_npz(vgg_path, device="cpu")
    px = np.random.default_rng(13).uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    layers = tuple(dict.fromkeys(tuple(CONTENT) + tuple(STYLE)))

    j_grams = jslow.style_target_grams(jvgg, style[None], tuple(STYLE))
    j_content = jslow.content_targets(jvgg, content[None], tuple(CONTENT))

    def jloss(p):
        acts = JV.apply(jvgg, p, layers, loss_layout=True)
        return jlosses.perceptual_loss(acts, j_content, j_grams, CONTENT, STYLE, p, BETA)[0]

    want_loss, want_grad = jax.value_and_grad(jloss)(jnp.asarray(px))

    t_grams = tslow.style_target_grams(tvgg, style[None], tuple(STYLE))
    t_content = tslow.content_targets(tvgg, content[None], tuple(CONTENT))
    pixels = torch.from_numpy(px).requires_grad_()
    loss = tslow.pixel_loss(tvgg, pixels, t_content, t_grams, CONTENT, STYLE, BETA)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    g = np.asarray(want_grad)
    np.testing.assert_allclose(pixels.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max())


def _run_both(vgg_path, images, content_weights, style_weights, steps):
    content, style = images
    j_log, t_log = [], []
    j_out = jslow.optimize(
        JV.load_npz(vgg_path), content, style, content_weights=content_weights, style_weights=style_weights,
        beta=BETA, learn_rate=LR, num_steps=steps, log_every=1, seed=0,
        log_fn=lambda s, v: j_log.append((s, v)),
    )
    t_out = tslow.optimize(
        TV.load_npz(vgg_path, device="cpu"), content, style, content_weights=content_weights,
        style_weights=style_weights, beta=BETA, learn_rate=LR, num_steps=steps, log_every=1,
        log_fn=lambda s, v: t_log.append((s, v)), init=_jax_init(),
    )
    return j_out, t_out, j_log, t_log


@pytest.mark.parametrize(
    "content_weights,style_weights",
    [(CONTENT, STYLE), ({}, STYLE), (CONTENT, {})],
    ids=["both", "style-only", "content-only"],
)
def test_optimize_steps_match_jax(vgg_path, images, content_weights, style_weights):
    steps = 3
    j_out, t_out, j_log, t_log = _run_both(vgg_path, images, content_weights, style_weights, steps)
    assert [s for s, _ in t_log] == [s for s, _ in j_log] == [1, 2, 3]
    np.testing.assert_allclose(t_log[0][1], j_log[0][1], rtol=1e-4)
    np.testing.assert_allclose([v for _, v in t_log], [v for _, v in j_log], rtol=5e-3)
    assert t_out.shape == j_out.shape == (SIZE, SIZE, 3) and t_out.dtype == np.float32
    diff = np.abs(t_out - np.asarray(j_out))
    assert diff.max() <= 2 * LR * steps
    assert np.median(diff) <= 1.0


def test_single_sided_runs_skip_the_other_target_pass(vgg_path, images, monkeypatch):
    content, style = images
    vgg = TV.load_npz(vgg_path, device="cpu")

    def no_call(*_a, **_k):
        raise AssertionError("target pass of the absent side ran")

    kw = dict(beta=BETA, learn_rate=LR, num_steps=1, log_every=1)
    with monkeypatch.context() as m:
        m.setattr(tslow, "content_targets", no_call)
        out = tslow.optimize(vgg, content, style, content_weights={}, style_weights={"conv1_2": 1.0}, **kw)
    assert np.isfinite(out).all()
    with monkeypatch.context() as m:
        m.setattr(tslow, "style_target_grams", no_call)
        out = tslow.optimize(vgg, content, style, content_weights={"conv1_2": 1.0}, style_weights={}, **kw)
    assert np.isfinite(out).all()
    with pytest.raises(ValueError, match="at least one"):
        tslow.optimize(vgg, content, style, content_weights={}, style_weights={}, **kw)


def test_log_fn_steps_never_past_num_steps(vgg_path, images):
    content, style = images
    seen = []
    out = tslow.optimize(
        TV.load_npz(vgg_path, device="cpu"), content, style, content_weights={"conv1_2": 1.0},
        style_weights={"conv1_2": 1.0}, num_steps=5, log_every=2, log_fn=lambda s, v: seen.append(s),
    )
    assert seen == [2, 4, 5]
    assert out.shape == (SIZE, SIZE, 3)


def test_seeded_init_is_reproducible(vgg_path, images):
    content, style = images
    vgg = TV.load_npz(vgg_path, device="cpu")
    kw = dict(content_weights={"conv1_2": 1.0}, style_weights={}, num_steps=1, learn_rate=LR)
    a = tslow.optimize(vgg, content, style, seed=3, **kw)
    b = tslow.optimize(vgg, content, style, seed=3, **kw)
    c = tslow.optimize(vgg, content, style, seed=4, **kw)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1.0


def test_cli_flags_defaults_and_run(vgg_path, tmp_path, capsys):
    mine = vars(cli.setup_parser().parse_args([]))
    assert mine.pop("device") == "cuda"
    assert mine == vars(jcli.setup_parser().parse_args([]))
    from faststyle_tpu_torch.utils import image_io

    content_p, style_p = tmp_path / "c.png", tmp_path / "s.png"
    image_io.imwrite(content_p, np.full((24, 20, 3), 90, np.uint8))
    image_io.imwrite(style_p, np.random.default_rng(5).integers(0, 256, (16, 16, 3), dtype=np.uint8))
    out, history = cli.main([
        "--style_img_path", str(style_p), "--cont_img_path", str(content_p), "--vgg_path", str(vgg_path),
        "--num_steps_break", "3", "--output_img_path", str(tmp_path / "o" / "out.jpg"), "--device", "cpu",
        "--loss_style_layers", "conv1_2", "conv2_2", "--style_weights", "5", "5",
    ])
    assert out.shape == (24, 20, 3) and (tmp_path / "o" / "out.jpg").exists()
    assert [s for s, _ in history] == [3] and np.isfinite(history[0][1])
    assert "Saved" in capsys.readouterr().out
