"""The port's bench (faststyle_tpu_torch/bench.py) and the three tools
ported with it, on the CPU at small sizes.

- The gate's status parsing with a stubbed subprocess.run, in the cases of
  tests/test_bench_gate.py, plus a checkout without chip_smoke.py.
- The FLOP counts from shapes equal torch.utils.flop_counter.FlopCounterMode
  over the port's CPU forward, train step and slow-style step, exactly:
  both count the same convolutions and matmuls at the same shapes (the
  data gradients as the forward convolutions that ops.conv_grad runs), and
  every count is an integer.
- Each bench function at a tiny size with device="cpu" gives positive,
  finite rates and a record stamped "cpu"; main at tiny sizes prints one
  line in bench.py's schema; a failed gate prints the zero line and exits
  3; the watchdog does the same in a subprocess; without --device the
  entry point refuses the CPU-only machine.
- tools.make_random_vgg against tools/make_random_vgg.py (keys, shapes,
  dtypes, both loaders, per-layer std within 10%: the draws differ, the
  distribution does not) and tools.export_tf_checkpoint against
  tools/export_tf_checkpoint.py (byte-identical bundles).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from faststyle_tpu_torch import bench  # noqa: E402
from faststyle_tpu_torch.utils.profiling import stylize_ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STARRY = ROOT / "weights" / "starry_final.npz"
PASSED = "chip_smoke: partial run of phases kernel wgrad (with device and build): passed; no kernels or ok line"


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread, here and in the children (OMP_NUM_THREADS):
    these tiny benches run thousands of small ops beside other test
    workers, and a small op spread over busy cores waits on its slowest
    thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def _fake_run(returncode, stdout="", stderr=""):
    def fake(cmd, **kwargs):
        assert cmd[1:] == [str(ROOT / "chip_smoke.py"), "kernel", "wgrad"] and kwargs["cwd"] == bench.REPO
        return subprocess.CompletedProcess(cmd, returncode, stdout=stdout, stderr=stderr)

    return fake


def _timeout(cmd, **kwargs):
    raise subprocess.TimeoutExpired(cmd, kwargs["timeout"])


@pytest.mark.parametrize(
    "run, status, said",
    [
        (_fake_run(0, f"== kernel\ngram [4, 256, 256, 64] float32: ok\n{PASSED}\n"), "pass", "passed"),
        # rc 0 without the partial-run line: nothing was asserted, never a pass
        (_fake_run(0, "== device\n"), "skipped", "skipped"),
        (_fake_run(1, "== kernel\n", "Traceback ...\nAssertionError: gram [4, 256, 256, 64] torch.float32: "
                                     "max |kernel - plain| 0.1 > 0.0001 * 1.0\n"), "FAIL", "AssertionError"),
        # a kernel that does not build is the build's fault, not the machine's
        (_fake_run(1, "== build\n", "RuntimeError: building conv_wgrad.cu failed:\n"), "FAIL", "RuntimeError"),
        (_fake_run(1, "", "SystemExit: chip_smoke: unknown phases ['kernel']; the phases are [...]\n"), "ERROR",
         "unknown phases"),
        (_fake_run(1, "== device\n", "chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card\n"),
         "ERROR", "is_available"),
        (_fake_run(2, "", "usage: chip_smoke.py\n"), "ERROR", "rc 2"),
        (_timeout, "ERROR", "TimeoutExpired"),
    ],
    ids=["pass", "all_skipped", "failure", "build_failure", "usage_error", "no_card", "rc2", "timeout"],
)
def test_gate_status(monkeypatch, run, status, said):
    monkeypatch.setattr(subprocess, "run", run)
    got, detail = bench.run_gate(timeout=5)
    assert got == status and detail.startswith(status) and said in detail, detail


def test_gate_without_chip_smoke_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "REPO", tmp_path)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("no gate process may start"))
    status, detail = bench.run_gate()
    assert status == "ERROR" and "chip_smoke.py" in detail


@pytest.mark.parametrize(
    "first, budget, want_status, want_calls",
    [
        # a timed-out slice retries once, bounded, when the budget allows
        ("ERROR (TimeoutExpired: ... timed out after 1485 seconds)", 2000, "pass", [1485, 300]),
        # budget too thin: no retry
        ("ERROR (TimeoutExpired: ...)", 600, "ERROR", [1485]),
        # an error that is no timeout never retries
        ("ERROR (OSError: boom)", 9999, "ERROR", [1485]),
    ],
    ids=["retry_with_budget", "no_retry_without_budget", "no_retry_on_other_error"],
)
def test_gate_with_recovery(monkeypatch, first, budget, want_status, want_calls):
    calls = []

    def fake_gate(timeout):
        calls.append(timeout)
        return ("ERROR", first) if len(calls) == 1 else ("pass", f"pass ({PASSED})")

    monkeypatch.setattr(bench, "run_gate", fake_gate)
    status, detail = bench.gate_with_recovery(1485, lambda: budget)
    assert status == want_status and calls == want_calls
    assert ("after a timed-out first attempt" in detail) == (len(calls) == 2)


def test_failed_gate_prints_the_zero_line_and_exits_3(monkeypatch, capsys):
    monkeypatch.setattr(bench, "gate_with_recovery", lambda *a: ("FAIL", "FAIL (rc 1: AssertionError: boom)"))
    monkeypatch.setattr(bench, "bench_inference", lambda *a, **k: pytest.fail("no timing after a failed gate"))
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--watchdog_secs", "0"])
    assert exc.value.code == 3
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == bench.METRIC and line["value"] == 0 and line["vs_baseline"] == 0
    assert line["details"]["gate"].startswith("FAIL") and line["details"]["platform"] == "cpu"


def test_watchdog_prints_the_zero_line_and_exits_3():
    code = "from faststyle_tpu_torch import bench; import time; bench._start_watchdog(0.5); time.sleep(60)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 3, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] == 0 and line["metric"] == bench.METRIC and "watchdog" in line["details"]["error"]


def test_entry_point_refuses_the_cpu_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is available")
    out = subprocess.run([sys.executable, "-m", "faststyle_tpu_torch.bench", "--watchdog_secs", "0"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert '"metric"' not in out.stdout


def test_card_record_and_peaks_on_the_cpu():
    assert bench.card_record("cpu")["platform"] == "cpu" and "device_name" not in bench.card_record("cpu")
    assert bench._peak_flops("bfloat16", "cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.card_record()


# ---------------------------------------------------------------------------
# FLOP counts
# ---------------------------------------------------------------------------


def _random_vgg():
    from faststyle_tpu_torch.models import vgg16

    return vgg16.init_params(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_serving_flops_equal_flop_counter(hw):
    from faststyle_tpu_torch.models import transform_net

    params = transform_net.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        transform_net.apply(params, x)
    assert counter.get_total_flops() == stylize_ops(*hw)


def _cudnn_input_grad(dy, w, stride, padding, x_hw):
    """The data gradient as the card's bf16 step takes it: one
    aten.convolution_backward (cuDNN's there), not the forward convs."""
    x = dy.new_zeros((dy.shape[0], w.shape[1], *x_hw))
    return torch.ops.aten.convolution_backward(dy, x, w, None, [stride] * 2, list(padding), [1, 1], False, [0, 0],
                                               1, [True, False, False])[0]


@pytest.mark.parametrize("precision, b4_256", [("float32", 482316320768), ("bfloat16", 479707856896)])
def test_train_step_flops_equal_flop_counter(monkeypatch, precision, b4_256):
    """One CPU recipe step at b2@64: the transform net's 16 convs with their
    weight and data gradients, VGG16 on both paths, the four Grams. In
    bfloat16 the data gradients take aten.convolution_backward, as on the
    card (the CPU would run the float32 forward convs)."""
    from faststyle_tpu_torch.ops import conv_grad
    from faststyle_tpu_torch.training import slow_style, train_step

    if precision == "bfloat16":
        monkeypatch.setattr(conv_grad, "input_grad", _cudnn_input_grad)
    config = train_step.TrainConfig.make(compute_dtype=bench._dtype(precision))
    vgg = _random_vgg()
    rng = np.random.default_rng(0)
    grams = slow_style.style_target_grams(vgg, rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32),
                                          tuple(dict(config.style_weights)))
    state = train_step.init_state(config, seed=1, device="cpu")
    step = train_step.make_train_step(vgg, grams, config)
    batch = torch.from_numpy(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    assert counter.get_total_flops() == bench.train_step_flops(2, 64, precision=precision)
    assert bench.train_step_flops(4, 256, precision=precision) == b4_256


def test_slow_style_flops_equal_flop_counter():
    """One Gatys step at 48x64 (odd pooled extents), the pixels the leaf."""
    from faststyle_tpu_torch.training import slow_style

    vgg = _random_vgg()
    img = np.random.default_rng(2).uniform(0, 255, (1, 48, 64, 3)).astype(np.float32)
    tgt_grams = slow_style.style_target_grams(vgg, img, tuple(bench.SLOW_STYLE_STYLE))
    tgt_content = slow_style.content_targets(vgg, img, tuple(bench.SLOW_STYLE_CONTENT))
    pixels = torch.from_numpy(img).requires_grad_()
    with FlopCounterMode(display=False) as counter:
        slow_style.pixel_loss(vgg, pixels, tgt_content, tgt_grams, bench.SLOW_STYLE_CONTENT,
                              bench.SLOW_STYLE_STYLE, 1e-4).backward()
    assert counter.get_total_flops() == bench.slow_style_flops(48, 64)


# ---------------------------------------------------------------------------
# Each bench on the CPU, small
# ---------------------------------------------------------------------------


def _rates(rec):
    keys = ("fps", "small_fps", "device_fps", "steps_per_sec", "p50_ms", "p99_ms", "device_ms", "host_ms")
    vals = []
    for k in keys:
        v = rec.get(k)
        vals += v if isinstance(v, list) else ([] if v is None else [v])
    return vals


@pytest.mark.parametrize(
    "call",
    [
        lambda: bench.bench_inference(1, "float32", 2, device="cpu", hw=(64, 64), small_hw=(48, 48)),
        lambda: bench.bench_train_step(2, "float32", repeats=1, batch=1, size=64, device="cpu"),
        lambda: bench.bench_slow_style(2, chunk=1, size=32, device="cpu"),
        lambda: bench.bench_packed_io_e2e(4, 64, 64, depth=2, device="cpu"),
        lambda: bench.bench_latency_sync(64, 48, 3, device="cpu"),
        lambda: bench.bench_packed_io(2, 2, device="cpu", hw=(64, 64)),
    ],
    ids=["inference", "train_step", "slow_style", "packed_io_e2e", "latency_sync", "packed_io"],
)
def test_bench_on_the_cpu(call):
    rec = call()
    rates = _rates(rec)
    assert rec["device"] == "cpu" and rates and all(math.isfinite(r) and r > 0 for r in rates), rec
    if "steps_per_sec" in rec:
        assert rec["flops_per_step"] > 0 and rec["gram_launches"] == rec["conv_wgrad_launches"] == 0
    if "mean_steps_per_sec" in rec:  # all steps over all time: between the slowest and fastest chunk
        assert min(rec["steps_per_sec"]) <= rec["mean_steps_per_sec"] <= max(rec["steps_per_sec"])
    if "small_fps" in rec:
        assert len(rec["fps"]) == len(rec["small_fps"]) == 2


def test_calibrate_host():
    rec = bench.calibrate_host(repeats=2)
    assert rec["pack_1080p_1core_ms"] > 0 and rec["unpack_1080p_1core_ms"] > 0 and rec["cpu_count"] >= 1


def test_main_at_tiny_sizes_prints_one_line_in_the_schema(monkeypatch, capsys):
    """main --device cpu --quick --skip_gate with every size shrunk: the
    whole order (serving, packed-u8 serving, train, slow-style, the DP
    child through torch.distributed.run with one gloo rank), one line."""
    for name, value in (("SERVE_HW", (64, 64)), ("SMALL_HW", (48, 48)), ("LARGE_HW", (64, 96)),
                        ("WEBCAM_HW", (48, 64)), ("TRAIN_SHAPE", (1, 32)), ("SLOW_SIZE", 32), ("DP_SHAPE", (1, 32))):
        monkeypatch.setattr(bench, name, value)
    bench.main(["--device", "cpu", "--quick", "--skip_gate", "--watchdog_secs", "0"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "1080p_stylize_fps_per_chip" and line["unit"] == "frames/sec" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 60.0, 3)
    d = line["details"]
    assert d["platform"] == "cpu" and "device_name" not in d and d["cudnn_allow_tf32"] is False
    for key in ("stylize_512px_fps", "stylize_1080p_fps_packed_io_serving", "packed_io_host_ms_per_frame",
                "model_flops_per_frame_1080p", "serving_tflops_per_s", "stylize_1080p_fps_packed_io_e2e",
                "stylize_4k_fps_packed_io_e2e", "stream_800x600_latency_ms_p50", "stream_1080p_device_ms_per_frame",
                "train_steps_per_sec_b4_256", "train_flops_per_step_b4_256", "train_tflops_per_s",
                "slow_style_steps_per_sec_256", "slow_style_1000step_seconds", "host_calibration", "io_link"):
        assert key in d, key
    assert "train_mfu" not in d and "serving_mfu" not in d and "chip_calibration" not in d  # no peak on the CPU
    assert set(d["dispersion"]) == {"1080p_fps", "512px_fps", "packed_io_device_fps", "packed_io_host_ms",
                                    "train_steps_per_sec", "slow_style_steps_per_sec"}
    assert all(set(v) == {"runs", "spread_pct"} for v in d["dispersion"].values())
    dp = d["dp_scaling"]
    assert dp["device"] == "cpu" and dp["cards"] == 1 and dp["1way_ms_per_step"] > 0
    assert "weak_scaling_efficiency" not in dp and dp["timed_steps"] == 5
    assert dp["ranks_cudnn_allow_tf32"] is False and dp["ranks_matmul_allow_tf32"] is False
    assert d["train_timed_steps"] == 40 and d["train_gram_launches"] == 0  # the CPU takes the plain versions


def test_dp_worker_runs_in_full_float32():
    """A DP rank is its own process (torch.distributed.run): it turns TF32
    off itself, and its record says so."""
    rec = bench._dp_subprocess(1, 1, device="cpu", per_card_batch=1, size=32, timeout=300)
    assert rec["world"] == 1 and rec["ms_per_step"] > 0
    assert rec["cudnn_allow_tf32"] is False and rec["matmul_allow_tf32"] is False


# ---------------------------------------------------------------------------
# The tools
# ---------------------------------------------------------------------------


def test_measure_fused_tower_on_the_cpu(monkeypatch, capsys):
    from faststyle_tpu_torch.tools import measure_fused_tower

    for name, value in (("STEPS", 1), ("REPS", 1), ("PRECISION", "float32"), ("SHAPE", (1, 32))):
        monkeypatch.setattr(measure_fused_tower, name, value)
    rates = measure_fused_tower.main(["--device", "cpu"])
    assert set(rates) == {False, True} and all(len(r) == 1 and r[0] > 0 for r in rates.values())
    assert "=== MEASURE DONE ===" in capsys.readouterr().out


def test_make_random_vgg_matches_the_jax_tool(tmp_path):
    from faststyle_tpu.models import vgg16 as jax_vgg16

    from faststyle_tpu_torch.models import vgg16
    from faststyle_tpu_torch.tools import make_random_vgg

    jax_out = tmp_path / "jax.npz"
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "make_random_vgg.py"), str(jax_out)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    port_out = make_random_vgg.main([str(tmp_path / "port.npz"), "--seed", "0"])
    with np.load(jax_out) as j, np.load(port_out) as p:
        assert sorted(j.files) == sorted(p.files) and len(p.files) == 26
        for key in j.files:
            assert p[key].shape == j[key].shape and p[key].dtype == j[key].dtype, key
            if key.endswith("_b"):
                assert not p[key].any() and not j[key].any(), key
            else:
                assert abs(p[key].std() / j[key].std() - 1) <= 0.1, key
                assert np.abs(p[key]).max() <= 0.2 + 1e-6, key  # truncated at 2 sigma of 0.1
    vgg16.load_npz(port_out, device="cpu")
    jax_vgg16.load_npz(port_out)


def test_export_tf_checkpoint_matches_the_jax_tool_byte_for_byte(tmp_path):
    from faststyle_tpu_torch.tools import export_tf_checkpoint

    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "export_tf_checkpoint.py"), str(STARRY),
                           str(tmp_path / "jax" / "starry.ckpt")], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    export_tf_checkpoint.main([str(STARRY), str(tmp_path / "port" / "starry.ckpt")])
    for suffix in (".index", ".data-00000-of-00001"):
        jax_bytes = (tmp_path / "jax" / f"starry.ckpt{suffix}").read_bytes()
        assert (tmp_path / "port" / f"starry.ckpt{suffix}").read_bytes() == jax_bytes and len(jax_bytes) > 0
