"""The port's data-parallel train step on two CPU ranks (gloo), against the
JAX package's `make_dp_train_step` on a 2-device mesh of the virtual CPU
devices and against the port's one-process step on the concatenated
batch; and the training loop under DP, where only rank 0 writes files.

Tolerances are tests/test_parallel.py's: loss rtol 1e-4; params rtol 1e-4
and atol 3e-3 after a step (a near-zero gradient entry can flip the sign
of Adam's first update under reordered sums: up to 2 * lr); the JAX
package's second step is held at that file's multi-step bound, rtol 5e-2
and atol 2e-3.

The ranks are `spawn`ed processes with one thread each, joined with a
timeout that fails the test if a rank dies or hangs.
"""

import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
WORLD = 2
STEPS = 2
LR = 1e-3
JOIN_TIMEOUT_S = 120


def _config(pkg):
    return pkg.TrainConfig.make(
        content_layers=("conv2_2",),
        content_weights=(1.0,),
        style_layers=("conv1_2",),
        style_weights=(5.0,),
        beta=1e-6,
        learn_rate=LR,
    )


def _inputs():
    """Numpy VGG blocks 1-2 (He-scaled), the starry net, a style image and
    STEPS global batches of 4 at 32x32, all from seeds."""
    from faststyle_tpu_torch.inference import load_params_numpy

    rng = np.random.default_rng(0)
    vgg, cin = {}, 3
    for name, cout in (("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128), ("conv2_2", 128)):
        w = rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin))
        vgg[name] = {"W": w.astype(np.float32), "b": 0.1 * rng.standard_normal(cout).astype(np.float32)}
        cin = cout
    style = rng.uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    batches = rng.uniform(0, 255, (STEPS, 2 * WORLD, SIZE, SIZE, 3)).astype(np.float32)
    net = load_params_numpy(ROOT / "weights" / "starry_final.npz")
    return vgg, net, style, batches


def _flat(params):
    return {f"{b}/{v}": np.asarray(a) for b, sub in params.items() for v, a in sub.items()}


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    """One rank: STEPS dp steps from the starry net (rank 1 starts from
    another init, which the first step's broadcast replaces), then the
    loop for STEPS steps under dp with checkpoints every step, then the
    loop under dp and debug_nans with a NaN in rank 1's rows."""
    import torch.distributed as dist

    from faststyle_tpu_torch import convert
    from faststyle_tpu_torch.parallel.data_parallel import make_dp_train_step
    from faststyle_tpu_torch.parallel.mesh import DataMesh
    from faststyle_tpu_torch.training import loop, slow_style
    from faststyle_tpu_torch.training import train_step as tstep

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=WORLD)
    try:
        vgg_np, net_np, style, batches = _inputs()
        cfg = _config(tstep)
        vgg = convert.params_from_numpy(vgg_np, device="cpu")
        grams = slow_style.style_target_grams(vgg, style, ("conv1_2",))
        params = convert.params_from_numpy(net_np, device="cpu") if rank == 0 else None
        state = tstep.init_state(cfg, seed=9, params=params, device="cpu")
        step = make_dp_train_step(vgg, grams, cfg)
        rows = slice(rank * 2, (rank + 1) * 2)
        out = {}
        for i in range(STEPS):
            state, metrics = step(state, batches[i, rows])
            out[f"loss/{i}"] = float(metrics["loss"])
            for k, v in _flat(convert.params_to_numpy(state.net.params())).items():
                out[f"{i}/{k}"] = v
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)

        root = Path(out_dir) / f"run{rank}"
        loop.train(
            vgg_params=vgg, style_img=style[0], batches=iter(batches[:, rows]), config=cfg,
            model_name="dp", num_steps_ckpt=1, log_every=1, train_root=root / "training",
            models_root=root / "models", summaries_root=root / "summaries", device="cpu",
            dp=DataMesh(rank, WORLD, torch.device("cpu")),
        )

        # a NaN pixel in rank 1's rows only: under debug_nans every rank
        # raises at the same step instead of one waiting in the all-reduce
        nan = batches[:, rows].copy()
        if rank == 1:
            nan[0, 1, 3, 4, 0] = np.nan
        try:
            loop.train(
                vgg_params=vgg, style_img=style[0], batches=iter(nan), config=cfg, model_name="nan",
                train_root=root / "nan", models_root=root / "nan", summaries_root=root / "nan", device="cpu",
                dp=DataMesh(rank, WORLD, torch.device("cpu")), debug_nans=True,
            )
            (Path(out_dir) / f"nan{rank}.txt").write_text("no error")
        except FloatingPointError as e:
            (Path(out_dir) / f"nan{rank}.txt").write_text(str(e))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The two spawned ranks' results (one run for the module's tests)."""
    import multiprocessing as mp

    out = tmp_path_factory.mktemp("dp")
    ctx = mp.get_context("spawn")
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # inherited by the ranks at spawn
    try:
        procs = [
            ctx.Process(target=_rank_main, args=(r, f"file://{out / 'store'}", str(out))) for r in range(WORLD)
        ]
        for p in procs:
            p.start()
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    try:
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT_S)
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def test_ranks_agree_and_match_one_process_on_the_whole_batch(dp_runs):
    from faststyle_tpu_torch import convert
    from faststyle_tpu_torch.training import slow_style
    from faststyle_tpu_torch.training import train_step as tstep

    _, ranks = dp_runs
    for k in ranks[0]:  # both ranks hold the same params and global metrics
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)

    vgg_np, net_np, style, batches = _inputs()
    cfg = _config(tstep)
    vgg = convert.params_from_numpy(vgg_np, device="cpu")
    grams = slow_style.style_target_grams(vgg, style, ("conv1_2",))
    state = tstep.init_state(cfg, params=convert.params_from_numpy(net_np, device="cpu"), device="cpu")
    step = tstep.make_train_step(vgg, grams, cfg)
    for i in range(STEPS):
        state, metrics = step(state, batches[i])
        np.testing.assert_allclose(ranks[0][f"loss/{i}"], float(metrics["loss"]), rtol=1e-4)
        for k, v in _flat(convert.params_to_numpy(state.net.params())).items():
            np.testing.assert_allclose(ranks[0][f"{i}/{k}"], v, rtol=1e-4, atol=3e-3, err_msg=f"step {i} {k}")


def test_matches_jax_dp_step_on_a_two_device_mesh(dp_runs):
    import jax
    import jax.numpy as jnp

    from faststyle_tpu.parallel import data_parallel as jdp
    from faststyle_tpu.parallel import mesh as jmesh
    from faststyle_tpu.training import slow_style as jslow
    from faststyle_tpu.training import train_step as jstep

    _, ranks = dp_runs
    vgg_np, net_np, style, batches = _inputs()
    cfg = _config(jstep)
    mesh = jmesh.data_mesh(jax.devices()[:WORLD])
    grams = jslow.style_target_grams(vgg_np, style, ("conv1_2",))
    step = jdp.make_dp_train_step(vgg_np, grams, cfg, mesh)
    state = jstep.init_state(jax.random.PRNGKey(0), cfg, params=jax.tree.map(jnp.asarray, net_np))
    bounds = [(1e-4, 3e-3), (5e-2, 2e-3)]  # after one step; after more (test_parallel.py)
    for i in range(STEPS):
        state, metrics = step(state, jax.device_put(batches[i], jmesh.batch_sharding(mesh)))
        np.testing.assert_allclose(ranks[0][f"loss/{i}"], float(metrics["loss"]), rtol=1e-4)
        rtol, atol = bounds[i]
        for k, v in _flat(jax.device_get(state.params)).items():
            np.testing.assert_allclose(ranks[0][f"{i}/{k}"], v, rtol=rtol, atol=atol, err_msg=f"step {i} {k}")


def test_debug_nans_raises_on_every_rank(dp_runs):
    """A NaN in one rank's rows raises FloatingPointError on both ranks at
    step 1 (the all-reduced loss parts carry it), and neither hangs."""
    out, _ = dp_runs
    for r in range(WORLD):
        assert (out / f"nan{r}.txt").read_text().startswith("step 1: non-finite loss parts")


def test_only_rank_0_writes_files(dp_runs):
    out, _ = dp_runs
    run0, run1 = out / "run0", out / "run1"
    assert sorted(p.name for p in (run0 / "training" / "dp").iterdir()) == ["step_1", "step_2"]
    assert (run0 / "models" / "dp_final.npz").exists()
    assert len(list((run0 / "summaries").glob("*/metrics.csv"))) == 1
    assert not run1.exists() or not any(p.is_file() for p in run1.rglob("*"))


def test_shard_rows_cuts_each_global_batch():
    from faststyle_tpu_torch.parallel import mesh

    closed = []

    def source():
        try:
            for i in range(3):
                yield np.full((4, 1), i) + np.arange(4)[:, None] * 10
        finally:
            closed.append(True)

    got = list(mesh.shard_rows(source(), rank=1, size=2))
    assert [b[:, 0].tolist() for b in got] == [[20, 30], [21, 31], [22, 32]]
    assert closed == [True]
    with pytest.raises(ValueError, match="does not split"):
        list(mesh.shard_rows(iter([np.zeros((3, 1))]), rank=0, size=2))


def test_world_from_env_and_pad_batch(monkeypatch):
    from faststyle_tpu.parallel import mesh as jmesh
    from faststyle_tpu_torch.parallel import mesh

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.world_from_env() == (0, 1, 0)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.world_from_env() == (3, 4, 1)
    monkeypatch.setenv("RANK", "4")
    with pytest.raises(ValueError, match="outside"):
        mesh.world_from_env()
    batch = np.arange(5 * 2).reshape(5, 2)
    for n in (1, 2, 4, 8):
        got, n0 = mesh.pad_batch_to_devices(batch, n)
        want, w0 = jmesh.pad_batch_to_devices(batch, n)
        np.testing.assert_array_equal(got, want)
        assert n0 == w0 == 5


def test_init_data_parallel_world_of_one_on_cpu(monkeypatch):
    import torch.distributed as dist

    from faststyle_tpu_torch.parallel import mesh

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    m = mesh.init_data_parallel("cpu")
    try:
        assert (m.rank, m.size, m.device.type, m.owns_group) == (0, 1, "cpu", True)
        assert dist.get_backend() == "gloo"
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        m.close()
    assert not dist.is_initialized()
