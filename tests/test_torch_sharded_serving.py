"""The port's batch-sharded serving (parallel.data_parallel.ShardedStylizer)
on a list of four CPU entries, against the JAX package's ShardedStylizer on
its eight virtual CPU devices and against the port's own Stylizer; and the
port's multi-device dry run (parallel.dryrun) on two CPU entries.

Tolerances are tests/test_parallel.py's: float32 rtol 1e-4 and atol 1e-2
(torch's and XLA's CPU convolutions sum in other orders), uint8 within one
count (a clip-boundary flip), packed I/O bit-exact with the port's own
packed Stylizer.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu_torch.inference import Stylizer, load_params_numpy  # noqa: E402
from faststyle_tpu_torch.parallel import dryrun  # noqa: E402
from faststyle_tpu_torch.parallel.data_parallel import ShardedStylizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32
DEVICES = ["cpu"] * 4


@pytest.fixture(scope="module")
def starry():
    return load_params_numpy(ROOT / "weights" / "starry_final.npz")


def test_matches_the_jax_sharded_stylizer(starry, starry_params):
    from faststyle_tpu.parallel import data_parallel as jdp
    from faststyle_tpu.parallel import mesh as jmesh

    batch = np.random.default_rng(0).uniform(0, 255, (8, SIZE, SIZE, 3)).astype(np.float32)
    ref = jdp.ShardedStylizer(starry_params, jmesh.data_mesh()).stylize_batch(batch)
    out = ShardedStylizer(starry, DEVICES).stylize_batch(batch)
    assert out.dtype == np.float32 and out.shape == ref.shape == batch.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-2)


def test_pads_a_batch_the_devices_do_not_divide(starry):
    batch = np.random.default_rng(1).uniform(0, 255, (5, SIZE, SIZE, 3)).astype(np.float32)
    out = ShardedStylizer(starry, DEVICES).stylize_batch(batch)
    assert out.shape == (5, SIZE, SIZE, 3) and out.dtype == np.float32
    ref = Stylizer(params=starry, device="cpu").stylize_batch(batch).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-2)


def test_uint8_out_within_one_count_of_the_stylizer(starry):
    batch = np.random.default_rng(5).integers(0, 256, (5, 96, 88, 3), dtype=np.uint8)
    out = ShardedStylizer(starry, DEVICES, output_uint8=True).stylize_batch(batch)
    assert out.dtype == np.uint8 and out.shape == batch.shape
    ref = Stylizer(params=starry, output_uint8=True, device="cpu").stylize_batch(batch).numpy()
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_packed_io_bit_exact_with_the_packed_stylizer_and_warns_on_floats(starry):
    batch = np.random.default_rng(6).integers(0, 256, (3, 96, 88, 3), dtype=np.uint8)
    sharded = ShardedStylizer(starry, DEVICES, packed_input=True, packed_output=True)
    out = sharded.stylize_batch(batch)
    assert out.dtype == np.uint8 and out.shape == batch.shape
    single = Stylizer(params=starry, packed_input=True, packed_output=True, device="cpu")
    np.testing.assert_array_equal(out, np.stack([single(img) for img in batch]))
    with pytest.warns(UserWarning, match="quantizing to uint8"):
        sharded.stylize_batch(batch.astype(np.float32))


def test_defaults_to_the_visible_cards_and_never_falls_back(starry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedStylizer(starry)


def test_dryrun_on_two_cpu_entries(monkeypatch, capsys):
    import torch.distributed as dist

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    dryrun.run(2, device="cpu")
    out = capsys.readouterr().out
    assert "[dryrun] 2-device cpu list OK" in out and "spatial (96, 44, 3) (2-way rows" in out
    assert not dist.is_initialized()  # the group it made is closed


def test_dryrun_needs_the_cards_it_names(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 3 devices, have 1"):
        dryrun.run(3)
