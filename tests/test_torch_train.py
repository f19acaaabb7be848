"""The port's training slice against the JAX package's, float32 on the CPU:
one train step from identical params and batch, the fused content tower
in three configurations, NaN checking, the loop with checkpoints and
--resume, the final .npz in the JAX package's loader, and the CLI with
--train_dir, --debug_nans and --data_parallel.

Tolerances: loss parts rtol 1e-4 (float32 sums over a VGG tower in another
order). Gradients within 2e-4 of each leaf's largest entry, except the two
full-resolution blocks initconv_0/1 at 1e-2: their weight gradients are
reductions over 2 x 112 x 112 positions whose terms mostly cancel, and
torch's CPU conv backward accumulates them in float32 blocks (measured
against a float64 run of the port: up to 5.6e-3 there, 1e-5 elsewhere;
the JAX package is within 5e-5 of it everywhere). Adam's first
step moves each param by ~lr * sign(g), so an update can differ by up to
2 * lr where a gradient entry is near zero; the params after one step are
compared at atol 2 * lr = 2e-3, and all but 1% of entries (those whose
gradient is within the tolerance of zero) must agree to 1e-6."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from faststyle_tpu import inference as jinference  # noqa: E402
from faststyle_tpu.training import slow_style as jslow  # noqa: E402
from faststyle_tpu.training import train_step as jstep  # noqa: E402
from faststyle_tpu_torch import convert  # noqa: E402
from faststyle_tpu_torch.models import vgg16  # noqa: E402
from faststyle_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402
from faststyle_tpu_torch.training import loop  # noqa: E402
from faststyle_tpu_torch.training import slow_style as tslow  # noqa: E402
from faststyle_tpu_torch.training import train_step as tstep  # noqa: E402
from faststyle_tpu_torch.utils.logging import MetricsLogger  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
LR = 1e-3
STYLE_LAYERS = ("conv1_2", "conv2_2")
CONTENT_LAYERS = ("conv2_2",)


_VGG_CHANNELS = (("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128), ("conv2_2", 128), ("conv3_1", 256),
                 ("conv3_2", 256), ("conv3_3", 256), ("conv4_1", 512))


def _vgg_np(seed=3, depth=4):
    """Random He-scaled numpy VGG weights for the first `depth` convs
    (4: blocks 1-2, all the small config reads; 8: through conv4_1)."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for name, cout in _VGG_CHANNELS[:depth]:
        w = rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))
        params[name] = {"W": w.astype(np.float32), "b": 0.1 * rng.standard_normal(cout).astype(np.float32)}
        cin = cout
    return params


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    vgg_np = _vgg_np()
    style = rng.uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    batch = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    net_np = jinference.load_params(ROOT / "weights" / "starry_final.npz")
    return vgg_np, style, batch, net_np


def _configs(**kw):
    common = dict(
        content_layers=CONTENT_LAYERS,
        content_weights=(1.0,),
        style_layers=STYLE_LAYERS,
        style_weights=(5.0, 5.0),
        beta=1e-6,
        learn_rate=LR,
    )
    common.update(kw)
    return jstep.TrainConfig.make(**common), tstep.TrainConfig.make(**common)


def test_one_train_step_matches_jax(setup):
    vgg_np, style, batch, net_np = setup
    jcfg, tcfg = _configs()

    j_grams = jslow.style_target_grams(vgg_np, style, STYLE_LAYERS)
    vgg_t = convert.params_from_numpy(vgg_np, device="cpu")
    t_grams = tslow.style_target_grams(vgg_t, style, STYLE_LAYERS)
    for name in STYLE_LAYERS:
        np.testing.assert_allclose(t_grams[name].numpy(), np.asarray(j_grams[name]), rtol=1e-4, atol=1e-6)

    j_state = jstep.init_state(jax.random.PRNGKey(0), jcfg, params=jax.tree.map(jnp.asarray, net_np))
    j_grads = jax.jit(jstep.make_grad_fn(vgg_np, j_grams, jcfg))(j_state.params, jnp.asarray(batch))[1]
    j_state, j_metrics = jax.jit(jstep.make_train_step(vgg_np, j_grams, jcfg))(j_state, jnp.asarray(batch))

    t_state = tstep.init_state(tcfg, params=convert.params_from_numpy(net_np, device="cpu"), device="cpu")
    t_state, t_metrics = tstep.make_train_step(vgg_t, t_grams, tcfg)(t_state, batch)
    assert t_state.step == 1

    assert t_metrics.keys() == j_metrics.keys()
    for k in t_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-4, err_msg=k)

    grads = {blk: {v: p.grad for v, p in sub.items()} for blk, sub in t_state.net.params().items()}
    t_grads = convert.params_to_numpy(grads)
    t_params = convert.params_to_numpy(t_state.net.params())
    for blk in net_np:
        for var in net_np[blk]:
            jg = np.asarray(j_grads[blk][var])
            rel = 1e-2 if blk in ("initconv_0", "initconv_1") else 2e-4
            np.testing.assert_allclose(
                t_grads[blk][var], jg, rtol=0, atol=rel * np.abs(jg).max(), err_msg=f"grad {blk}/{var}"
            )
            jp = np.asarray(j_state.params[blk][var])
            tp = t_params[blk][var]
            np.testing.assert_allclose(tp, jp, rtol=0, atol=2 * LR, err_msg=f"param {blk}/{var}")
            assert np.mean(np.abs(tp - jp) > 1e-6) < 1e-2, f"param {blk}/{var}"
            assert np.abs(tp - net_np[blk][var]).max() > 0.5 * LR  # the step moved it


# the fused tower's configurations, as the JAX package's tests have them:
# content inside the tower (split pool2), style deeper than the split pool
# (a continuation from pool3), and the split pool as a loss layer itself
FUSED_CONFIGS = {
    "plain": (dict(content_layers=CONTENT_LAYERS, style_layers=STYLE_LAYERS, beta=1e-6), 2),
    "deeper_style": (dict(content_layers=("conv3_3",), style_layers=("conv1_2", "conv4_1")), 1),
    "pool_loss_layer": (dict(content_layers=("pool2",), style_layers=("conv1_2", "conv3_3")), 1),
}


@pytest.mark.parametrize("name", list(FUSED_CONFIGS))
def test_fused_content_tower_matches_jax_and_unfused(setup, name):
    """One fused step against the JAX package's fused step and against the
    port's plain step, from identical params and batch: loss parts rtol
    1e-4; params within 2 * lr, and all but 1% of the net's entries within
    1e-6 (counted over the whole net: one sign flip in a 64-entry leaf is
    already 1.6% of it; the JAX package differs in 1-4 of 424102)."""
    _, style, _, net_np = setup
    kw, n = FUSED_CONFIGS[name]
    jcfg, tcfg = _configs(content_weights=(1.0,), style_weights=(5.0, 5.0), **kw)
    vgg_np = _vgg_np(depth=8)
    vgg_t = convert.params_from_numpy(vgg_np, device="cpu")
    batch = np.random.default_rng(5).uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)
    style_layers = kw["style_layers"]

    j_grams = jslow.style_target_grams(vgg_np, style, style_layers)
    j_state = jstep.init_state(jax.random.PRNGKey(0), jcfg, params=jax.tree.map(jnp.asarray, net_np))
    j_step = jax.jit(jstep.make_train_step(vgg_np, j_grams, jcfg, fused_content_tower=True))
    j_state, j_metrics = j_step(j_state, jnp.asarray(batch))

    t_grams = tslow.style_target_grams(vgg_t, style, style_layers)
    runs = {}
    for fused in (True, False):
        state = tstep.init_state(tcfg, params=convert.params_from_numpy(net_np, device="cpu"), device="cpu")
        state, metrics = tstep.make_train_step(vgg_t, t_grams, tcfg, fused_content_tower=fused)(state, batch)
        runs[fused] = ({k: float(v) for k, v in metrics.items()}, convert.params_to_numpy(state.net.params()))
    j_params = {blk: {v: np.asarray(a) for v, a in sub.items()} for blk, sub in j_state.params.items()}
    for label, (other_metrics, other_params) in (("jax fused", (dict(j_metrics), j_params)), ("port plain", runs[False])):
        metrics, params = runs[True]
        assert metrics.keys() == other_metrics.keys()
        for k in metrics:
            np.testing.assert_allclose(metrics[k], float(other_metrics[k]), rtol=1e-4, err_msg=f"{label} {k}")
        diffs = []
        for blk in net_np:
            for var in net_np[blk]:
                a, b = params[blk][var], other_params[blk][var]
                np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR, err_msg=f"{label} param {blk}/{var}")
                diffs.append(np.abs(a - b).ravel())
        assert np.mean(np.concatenate(diffs) > 1e-6) < 1e-2, label
    assert runs[True][0]["content_loss"] > 0 and runs[True][0]["style_loss"] > 0


def test_fused_content_tower_without_content_layers_is_the_plain_step(setup):
    _, style, batch, _ = setup
    _, cfg = _configs(content_layers=(), content_weights=())
    vgg_t = convert.params_from_numpy(_vgg_np(), device="cpu")
    grams = tslow.style_target_grams(vgg_t, style, STYLE_LAYERS)
    out = []
    for fused in (True, False):
        state = tstep.init_state(cfg, seed=1, device="cpu")
        _, metrics = tstep.make_train_step(vgg_t, grams, cfg, fused_content_tower=fused)(state, batch)
        out.append({k: float(v) for k, v in metrics.items()})
    assert out[0] == out[1] and out[0]["content_loss"] == 0.0


def _nan_batches(n, nan_at=None):
    rng = np.random.default_rng(6)
    batches = [rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(n)]
    if nan_at is not None:
        batches[nan_at][1, 5, 7, 2] = np.nan
    return batches


def test_debug_nans_raises_on_a_nan_batch(tmp_path, setup):
    """A NaN pixel in the second batch: FloatingPointError naming step 2,
    and no final weights written."""
    vgg_np, style, _, _ = setup
    _, cfg = _configs()
    vgg_t = convert.params_from_numpy(vgg_np, device="cpu")
    with pytest.raises(FloatingPointError, match="step 2"):
        _run_loop(tmp_path, vgg_t, style, _nan_batches(3, nan_at=1), cfg, debug_nans=True)
    assert not (tmp_path / "models" / "tiny_final.npz").exists()


def test_debug_nans_checks_the_loss_parts():
    """A step whose loss parts are not finite raises, even when nothing
    reaches the backward."""
    state = tstep.init_state(_configs()[1], seed=0, device="cpu")

    def step(st, batch):
        return st, {"loss": torch.tensor(float("inf")), "style_loss": torch.tensor(1.0)}

    with pytest.raises(FloatingPointError, match=r"step 1: non-finite loss parts \{'loss': inf\}"):
        loop.nan_checked(step)(state, None)


def test_debug_nans_changes_nothing_on_clean_batches(tmp_path, setup):
    vgg_np, style, _, _ = setup
    _, cfg = _configs()
    vgg_t = convert.params_from_numpy(vgg_np, device="cpu")
    runs = [
        _run_loop(tmp_path / str(flag), vgg_t, style, _nan_batches(2), cfg, debug_nans=flag)
        for flag in (False, True)
    ]
    assert runs[0].step == runs[1].step == 2
    for (n, a), (_, b) in zip(runs[0].net.named_parameters(), runs[1].net.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def _run_loop(tmp_path, vgg_t, style, batches, cfg, **kw):
    return loop.train(
        vgg_params=vgg_t,
        style_img=style[0],
        batches=iter(batches),
        config=cfg,
        model_name="tiny",
        train_root=tmp_path / "training",
        models_root=tmp_path / "models",
        summaries_root=tmp_path / "summaries",
        logger=MetricsLogger(tmp_path / "summaries", kw.pop("run", "run0"), echo=False),
        device="cpu",
        **kw,
    )


def test_loop_checkpoint_resume_and_final_npz(tmp_path, setup):
    """Loop -> checkpoint at step 4 -> final npz; --resume restores step 4
    with the params and Adam moments it saved and trains on to 6; the final
    npz loads in the JAX package's load_params with its key set."""
    vgg_np, style, _, net_np = setup
    _, cfg = _configs()
    vgg_t = convert.params_from_numpy(vgg_np, device="cpu")
    rng = np.random.default_rng(1)
    batches = [rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(6)]

    state = _run_loop(tmp_path, vgg_t, style, batches, cfg, num_steps_ckpt=4, log_every=2)
    assert state.step == 6
    assert ckpt_lib.all_steps(tmp_path / "training" / "tiny") == [4]
    assert (tmp_path / "summaries" / "run0" / "metrics.csv").read_text().count("\n") >= 3

    final = tmp_path / "models" / "tiny_final.npz"
    loaded = jinference.load_params(final)
    assert {f"{b}/{v}" for b in loaded for v in loaded[b]} == {
        f"{b}/{v}" for b in net_np for v in net_np[b]
    }
    want = convert.params_to_numpy(state.net.params())
    for blk in want:
        for var in want[blk]:
            np.testing.assert_array_equal(loaded[blk][var], want[blk][var])

    template = tstep.init_state(cfg, seed=5, device="cpu")
    restored = ckpt_lib.restore_latest(tmp_path / "training" / "tiny", template)
    assert restored.step == 4
    assert all(len(s) == 3 for s in restored.optimizer.state.values())

    state2 = _run_loop(tmp_path, vgg_t, style, batches[:2], cfg, resume=True, run="run1")
    assert state2.step == 6


def test_checkpoint_roundtrip_is_exact(tmp_path, setup):
    vgg_np, style, batch, _ = setup
    _, cfg = _configs()
    vgg_t = convert.params_from_numpy(vgg_np, device="cpu")
    grams = tslow.style_target_grams(vgg_t, style, STYLE_LAYERS)
    state = tstep.init_state(cfg, seed=2, device="cpu")
    state, _ = tstep.make_train_step(vgg_t, grams, cfg)(state, batch)
    ckpt_lib.save(tmp_path, state)
    restored = ckpt_lib.restore_latest(tmp_path, tstep.init_state(cfg, seed=9, device="cpu"))
    assert restored.step == 1
    for (n, a), (_, b) in zip(state.net.named_parameters(), restored.net.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    for a, b in zip(state.optimizer.state.values(), restored.optimizer.state.values()):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_checkpoint_retention_and_corrupt_fallback(tmp_path, capsys):
    _, cfg = _configs()
    state = tstep.init_state(cfg, seed=2, device="cpu")
    for s in range(8):
        state.step = s
        ckpt_lib.save(tmp_path, state, keep=3)
    assert sorted(ckpt_lib.all_steps(tmp_path)) == [5, 6, 7]
    (tmp_path / "step_7" / "state.npz").write_bytes(b"not a zipfile")
    restored = ckpt_lib.restore_latest(tmp_path, tstep.init_state(cfg, seed=3, device="cpu"))
    assert restored.step == 6
    assert "unreadable" in capsys.readouterr().out


def test_checkpoint_mismatch_raises(tmp_path):
    _, cfg = _configs()
    ckpt_lib.save(tmp_path, tstep.init_state(cfg, seed=2, device="cpu"))
    _, deconv = _configs(upsample_method="deconv")
    with pytest.raises(ckpt_lib.CheckpointMismatch):
        ckpt_lib.restore_latest(tmp_path, tstep.init_state(deconv, seed=2, device="cpu"))


def test_cli_train_on_cpu(tmp_path, monkeypatch):
    """`cli.train.main --device cpu` on a tiny image dir: steps, checkpoints
    and the final weights."""
    from faststyle_tpu_torch.cli import train as cli
    from faststyle_tpu_torch.utils import image_io

    rng = np.random.default_rng(4)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(4):
        image_io.imwrite(img_dir / f"{i}.png", rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    vgg = convert.params_to_numpy(vgg16.init_params(torch.Generator().manual_seed(0), device="cpu"))
    np.savez(tmp_path / "vgg.npz", **{f"{n}_{k}": v for n, p in vgg.items() for k, v in p.items()})
    monkeypatch.chdir(tmp_path)
    state = cli.main([
        "--image_dir", str(img_dir), "--vgg_path", str(tmp_path / "vgg.npz"),
        "--style_img_path", str(ROOT / "style_images" / "starry_night_crop.jpg"),
        "--style_target_resize", "0.05", "--batch_size", "2", "--preprocess_size", "32", "32",
        "--loss_content_layers", "conv2_2", "--loss_style_layers", "conv1_2", "conv2_2",
        "--style_weights", "5", "5", "--num_steps_break", "3", "--num_steps_ckpt", "2",
        "--model_name", "tiny", "--device", "cpu",
    ])
    assert state.step == 3
    assert ckpt_lib.all_steps(tmp_path / "training" / "tiny") == [2]
    assert (tmp_path / "models" / "tiny_final.npz").exists()




def _cli_args(tmp_path, records, *extra):
    """cli.train's arguments for 3 steps at b2@32 on the CPU."""
    from faststyle_tpu_torch.models import vgg16

    vgg = convert.params_to_numpy(vgg16.init_params(torch.Generator().manual_seed(0), device="cpu"))
    np.savez(tmp_path / "vgg.npz", **{f"{n}_{k}": v for n, p in vgg.items() for k, v in p.items()})
    return [
        "--train_dir", str(records), "--vgg_path", str(tmp_path / "vgg.npz"),
        "--style_img_path", str(ROOT / "style_images" / "starry_night_crop.jpg"),
        "--style_target_resize", "0.05", "--batch_size", "2", "--preprocess_size", "32", "32",
        "--loss_content_layers", "conv2_2", "--loss_style_layers", "conv1_2", "conv2_2",
        "--style_weights", "5", "5", "--num_steps_break", "3", "--num_steps_ckpt", "2",
        "--num_pipe_buffer", "2", "--model_name", "tiny", "--device", "cpu", *extra,
    ]


@pytest.fixture
def records(tmp_path):
    from faststyle_tpu_torch.data import writer
    from faststyle_tpu_torch.utils import image_io

    rng = np.random.default_rng(8)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(6):
        image_io.imwrite(img_dir / f"{i}.jpg", rng.integers(0, 256, (40, 36, 3), dtype=np.uint8))
    writer.write_dataset(img_dir, tmp_path / "records", num_shards=2, num_threads=2)
    return tmp_path / "records"


@pytest.fixture
def no_dist_env(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("extra", [(), ("--debug_nans",)], ids=["train_dir", "train_dir_debug_nans"])
def test_cli_train_dir_trains(tmp_path, monkeypatch, records, extra):
    from faststyle_tpu_torch.cli import train as cli

    monkeypatch.chdir(tmp_path)
    state = cli.main(_cli_args(tmp_path, records, *extra))
    assert state.step == 3
    assert ckpt_lib.all_steps(tmp_path / "training" / "tiny") == [2]
    assert (tmp_path / "models" / "tiny_final.npz").exists()


def test_cli_data_parallel_world_of_one_on_cpu(tmp_path, monkeypatch, records, no_dist_env):
    """--data_parallel started alone: a gloo world of one that trains the
    same steps as the plain run and is destroyed afterwards."""
    import torch.distributed as dist

    from faststyle_tpu_torch.cli import train as cli

    runs = {}
    for flag in ("plain", "dp"):
        (tmp_path / flag).mkdir()
        monkeypatch.chdir(tmp_path / flag)
        state = cli.main(_cli_args(tmp_path, records, *(["--data_parallel"] if flag == "dp" else [])))
        assert state.step == 3 and not dist.is_initialized()
        runs[flag] = jinference.load_params(tmp_path / flag / "models" / "tiny_final.npz")
    for blk in runs["plain"]:
        for var in runs["plain"][blk]:
            np.testing.assert_allclose(runs["dp"][blk][var], runs["plain"][blk][var], rtol=0, atol=1e-6)


def test_cli_data_parallel_batch_must_divide_the_world(monkeypatch):
    from faststyle_tpu_torch.cli import train as cli

    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit, match="--batch_size 4 not divisible by 3 devices"):
        cli.main(["--train_dir", "x", "--data_parallel", "--device", "cpu"])


def test_cli_needs_a_data_source():
    from faststyle_tpu_torch.cli import train as cli

    with pytest.raises(SystemExit, match=r"need --train_dir \(TFRecords\) or --image_dir \(JPEGs\)"):
        cli.main(["--device", "cpu"])
