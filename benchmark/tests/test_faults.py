"""A run with the timed path broken underneath comes out not correct: the
whole run at a small size on the CPU (the look for a card skipped), once
for each fault the cells can have. (On the CPU the port computes every
conv's weight gradient through `conv_wgrad.conv_weight_grad`, its plain
version; on the card the kernel takes 6 of the 16.)"""

import time

import pytest
import torch

from benchmark.harness import run_cell
from benchmark.tests.conftest import SMALL


def _run(bench, workload, seed=3):
    return run_cell(bench, workload, seed, 0.5, False, "cpu", time.perf_counter(), SMALL[workload])[1]


def test_frame_altered_where_produced(bench_copy, monkeypatch, one_thread):
    from faststyle_tpu_torch import inference

    produce = inference.Stylizer.stylize_device
    monkeypatch.setattr(inference.Stylizer, "stylize_device", lambda self, x, hw=None: produce(self, x, hw).flip(1))
    line = _run(bench_copy, "stylize_4k_d4")
    assert line["correct"] is False
    assert line["checks"]["frame_mae_max"]["value"] > line["checks"]["frame_mae_max"]["limit"]


def test_step_returns_state_unchanged(bench_copy, monkeypatch, one_thread):
    from faststyle_tpu_torch.training import train_step

    make = train_step.make_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def unchanged(state, batch):
            before = [p.detach().clone() for p in state.net.parameters()]
            state, parts = step(state, batch)
            with torch.no_grad():
                for p, b in zip(state.net.parameters(), before):
                    p.copy_(b)
            return state, parts

        return unchanged

    monkeypatch.setattr(train_step, "make_train_step", broken)
    line = _run(bench_copy, "train_b16_256")
    assert line["correct"] is False
    assert line["checks"]["update3_median_gap"]["value"] == pytest.approx(1.0, abs=0.01)


def test_half_the_batch_left_out(bench_copy, monkeypatch, one_thread):
    """The loss over the first half of each batch, doubled: the mean taken
    over the rest."""
    from faststyle_tpu_torch.training import train_step

    make = train_step.make_grad_fn

    def broken(*args, **kwargs):
        grad_fn = make(*args, **kwargs)

        def half(net, batch):
            parts = grad_fn(net, batch[: batch.shape[0] // 2])
            for p in net.parameters():
                p.grad.mul_(2)
            return {k: 2 * v for k, v in parts.items()}

        return half

    monkeypatch.setattr(train_step, "make_grad_fn", broken)
    line = _run(bench_copy, "train_b16_256")
    assert line["correct"] is False
    assert line["checks"]["loss1_gap"]["value"] > line["checks"]["loss1_gap"]["limit"]


def test_batch_rows_altered_where_produced(bench_copy, monkeypatch, one_thread):
    from faststyle_tpu_torch.data import pipeline

    decode = pipeline._decode_resize
    monkeypatch.setattr(pipeline, "_decode_resize", lambda data, size: decode(data, size)[:, ::-1].copy())
    line = _run(bench_copy, "train_b16_256")
    assert line["correct"] is False
    assert line["checks"]["batch_err_max"]["value"] > line["checks"]["batch_err_max"]["limit"]


def _wgrad_zeroed_after(monkeypatch, calls: int):
    """conv_wgrad's weight gradients come back as zeros after `calls` calls."""
    from faststyle_tpu_torch.ops.cuda import conv_wgrad

    produce = conv_wgrad.conv_weight_grad
    count = [0]

    def broken(*args, **kwargs):
        count[0] += 1
        dw = produce(*args, **kwargs)
        return dw if count[0] <= calls else torch.zeros_like(dw)

    monkeypatch.setattr(conv_wgrad, "conv_weight_grad", broken)


def test_conv_weight_gradients_zeroed(bench_copy, monkeypatch, one_thread):
    """A fault inside the kernels' weight gradients moves none of the
    instance-norm leaves, so not the median leaf: the conv numbers see it."""
    _wgrad_zeroed_after(monkeypatch, 0)
    line = _run(bench_copy, "train_b16_256")
    assert line["correct"] is False
    for name in ("grad1_conv_worst_gap", "update3_conv_worst_gap", "window_grad_conv_worst_gap"):
        assert line["checks"][name]["value"] > line["checks"][name]["limit"], name


def test_step_changes_after_the_checked_steps(bench_copy, monkeypatch, one_thread):
    """A step that goes wrong only after warm-up (here: zero weight
    gradients from the fourth step on) is caught at the window's kept step."""
    _wgrad_zeroed_after(monkeypatch, 16 * SMALL["train_b16_256"]["traffic"].get("checked_steps", 3))
    line = _run(bench_copy, "train_b16_256")
    assert line["correct"] is False
    assert line["checks"]["grad1_conv_worst_gap"]["value"] <= line["checks"]["grad1_conv_worst_gap"]["limit"]
    assert line["checks"]["window_grad_conv_worst_gap"]["value"] > line["checks"]["window_grad_conv_worst_gap"]["limit"]


def test_batcher_repeats_a_batch(bench_copy, monkeypatch, one_thread):
    """A Batcher that hands out one batch again and again after its first
    three: the window's sampled batches repeat."""
    from faststyle_tpu_torch.data import pipeline

    produce = pipeline.Batcher.__iter__

    def repeating(self):
        it = produce(self)
        for _ in range(4):
            batch = next(it)
            yield batch
        while True:
            yield batch.copy()

    monkeypatch.setattr(pipeline.Batcher, "__iter__", repeating)
    line = _run(bench_copy, "train_b16_256")
    assert line["correct"] is False
    assert line["checks"]["rows_repeated"]["value"] > line["checks"]["rows_repeated"]["limit"]
