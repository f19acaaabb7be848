"""The port's distillation trainer (faststyle_tpu_torch/tools) against the
JAX tool (tools/distill_validation.py, tools/make_training_images.py) on
the CPU, float32, from the same numpy params and batches.

Tolerances: losses rtol 1e-4 (float32 sums over the net in other orders;
the gradients agree to ~4e-6 of each leaf's largest entry). Params within
2 * lr per step of each other (an update is at most lr in size, and one
whose gradient entry sits near zero may flip); after the first step all
but 1% of each leaf's entries within 1e-6, so a leaf whose gradient were
flipped or dropped would fail, however small. Adam's second update divides by
each entry's own gradient scale, so an entry whose gradient is a thousandth
of its leaf's largest carries the 4e-6 as a 4e-3 relative error into an
update of size lr: after later steps all but 1% of each leaf within lr / 10. The Polyak
average moves by (1 - decay) of that, so it is held at 1e-6 throughout.
The LR schedule to 1e-6 relative of optax's."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from faststyle_tpu import inference as jinference  # noqa: E402
from faststyle_tpu.models import transform_net as jnet  # noqa: E402
from faststyle_tpu_torch import convert  # noqa: E402
from faststyle_tpu_torch.models import transform_net as tnet  # noqa: E402
from faststyle_tpu_torch.tools import distill_validation as TDV  # noqa: E402
from faststyle_tpu_torch.tools import make_training_images as TMTI  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
SIZE = 32


@pytest.fixture(scope="module")
def jdv():
    sys.path.insert(0, str(REPO / "tools"))
    import distill_validation as DV

    return DV


def _np(tree):
    return {b: {v: np.asarray(a) for v, a in sub.items()} for b, sub in tree.items()}


def _nets(method):
    """A teacher and a student at init, the teacher's IN scales and shifts
    moved off 1 and 0: with both nets' shifts at 0, every IN layer whose
    output the loss reads directly has a shift gradient of zero up to
    rounding, and Adam turns that rounding into updates of any size."""
    rng = np.random.default_rng(1)
    teacher = _np(jnet.init_params(jax.random.PRNGKey(42), method))
    for sub in teacher.values():
        for var, a in sub.items():
            if var.startswith("IN"):
                sub[var] = (a + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
    student = _np(jnet.init_params(jax.random.PRNGKey(0), method))
    return teacher, student


def _batches(n):
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(n)]


def _run_jax(make, kwargs, teacher, student, batches):
    step_fn, opt = make(LR, None, **kwargs)
    params = jax.tree.map(jnp.asarray, student)
    ema = jax.tree.map(jnp.copy, params)
    opt_state = opt.init(params)
    metrics, snaps = [], []
    for b in batches:
        params, ema, opt_state, (loss, aux) = step_fn(params, ema, opt_state, jax.tree.map(jnp.asarray, teacher),
                                                      jnp.asarray(b))
        metrics.append((float(loss), float(aux)))
        snaps.append((_np(params), _np(ema)))
    return metrics, snaps


def _run_port(make, kwargs, teacher, student, batches, method):
    step_fn, opt = make(LR, None, **kwargs)
    net = tnet.TransformNet(convert.params_from_numpy(student, device="cpu"), method)
    ema = {b: {v: t.detach().clone() for v, t in sub.items()} for b, sub in net.params().items()}
    opt_state = opt.init(net)
    t_params = convert.params_from_numpy(teacher, device="cpu")
    metrics, snaps = [], []
    for b in batches:
        net, ema, opt_state, (loss, aux) = step_fn(net, ema, opt_state, t_params, torch.from_numpy(b))
        metrics.append((float(loss), float(aux)))
        snaps.append((convert.params_to_numpy(net.params()), convert.params_to_numpy(ema)))
    return metrics, snaps


def _compare(port, jax_out, start):
    (pm, psnaps), (jm, jsnaps) = port, jax_out
    np.testing.assert_allclose(np.array(pm), np.array(jm), rtol=1e-4)
    for step, ((pp, pe), (jp, je)) in enumerate(zip(psnaps, jsnaps), start=1):
        for label, a_tree, b_tree, close in (("params", pp, jp, 1e-6 if step == 1 else LR / 10), ("ema", pe, je, 1e-6)):
            for blk in b_tree:
                for var in b_tree[blk]:
                    a, b = a_tree[blk][var], b_tree[blk][var]
                    np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * step, err_msg=f"{label} {blk}/{var}")
                    far = np.mean(np.abs(a - b) > close)
                    assert far < 1e-2, f"{label} {blk}/{var} after step {step}: {far:.2%} beyond {close}"
    pp = psnaps[-1][0]
    moved = max(np.abs(pp[b][v] - start[b][v]).max() for b in start for v in start[b])
    assert moved > 0.5 * LR  # the steps moved the student


def test_distill_steps_match_jax(jdv):
    """Two steps of make_distill_step with feature matching, Gram matching,
    EMA 0.99 and a cosine schedule over 10 steps."""
    teacher, student = _nets("resize")
    kwargs = dict(decay_steps=10, feature_w=1.0, gram_w=1.0, ema_decay=0.99)
    batches = _batches(2)
    j = _run_jax(jdv.make_distill_step, kwargs, teacher, student, batches)
    p = _run_port(TDV.make_distill_step, kwargs, teacher, student, batches, "resize")
    _compare(p, j, student)
    assert p[0][1][0] < p[0][0][0]  # the loss fell


@pytest.mark.parametrize("method", ["resize", "deconv"])
def test_teacher_forcing_step_matches_jax(jdv, method):
    teacher, student = _nets(method)
    kwargs = dict(decay_steps=10, ema_decay=0.99, upsample_method=method)
    batches = _batches(1)
    j = _run_jax(jdv.make_teacher_forcing_step, kwargs, teacher, student, batches)
    p = _run_port(TDV.make_teacher_forcing_step, kwargs, teacher, student, batches, method)
    _compare(p, j, student)


@pytest.mark.parametrize("decay_steps", [0, 10, 7])
def test_lr_schedule_matches_optax(decay_steps):
    adam = TDV.CosineAdam(3e-4, decay_steps)
    want = optax.cosine_decay_schedule(3e-4, decay_steps, alpha=0.02) if decay_steps else (lambda c: 3e-4)
    for count in range(decay_steps + 3):
        np.testing.assert_allclose(adam.rate(count), float(want(count)), rtol=1e-6)
    net = tnet.TransformNet(tnet.init_params(torch.Generator().manual_seed(0), device="cpu"))
    opt = adam.init(net)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    for count in range(3):
        adam.step(opt)
        assert opt.param_groups[0]["lr"] == adam.rate(count) and opt.param_groups[0]["count"] == count + 1


def test_make_training_images_gives_the_jax_tools_images(tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "tools/make_training_images.py"), str(tmp_path / "jax"), "--num", "8",
         "--size", "48", "--seed", "3"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    TMTI.main([str(tmp_path / "port"), "--num", "8", "--size", "48", "--seed", "3"])
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.jpg"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.jpg")) and len(names) == 8
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name


@pytest.mark.parametrize("extra", [["--layerwise"], ["--gram_w", "1", "--ema_decay", "0.999"]],
                         ids=["layerwise", "gram_ema"])
def test_cli_on_cpu_writes_an_npz_both_packages_read(tmp_path, monkeypatch, extra):
    """main --device cpu --steps 3 --precision float32 on a tiny corpus: the
    saved student loads in both packages' load_params with the teacher's
    key set, and the held-out SSIMs come back. The Batcher's shuffle buffer
    is cut from 1000 to 4 images here (the CLI's 1000 would hold 0.8 GB of
    decoded images)."""
    TMTI.main([str(tmp_path / "imgs"), "--num", "4", "--size", "32"])
    made = TDV.pipeline.image_dir_batcher
    monkeypatch.setattr(TDV.pipeline, "image_dir_batcher",
                        lambda *a, **kw: made(*a, **{**kw, "min_after_dequeue": 4}))
    out = tmp_path / "student.npz"
    res = TDV.main(["--image_dir", str(tmp_path / "imgs"), "--out", str(out), "--steps", "3", "--batch_size", "1",
                    "--precision", "float32", "--device", "cpu", *extra])
    assert res["out"] == out and out.exists()
    assert [r[0] for r in res["rows"]] == [1]
    assert set(res["ssim"]) == {"256", "512", "native"} and all(0 < s <= 1 for s in res["ssim"].values())
    teacher = jinference.load_params(REPO / "weights" / "starry_final.npz")
    for loaded in (jinference.load_params(out), convert.params_to_numpy(TDV.load_params(out, device="cpu"))):
        assert {f"{b}/{v}" for b in loaded for v in loaded[b]} == {f"{b}/{v}" for b in teacher for v in teacher[b]}
    assert (tmp_path / "distill_student_native.png").exists()


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDV.main(["--image_dir", str(tmp_path), "--steps", "1"])
