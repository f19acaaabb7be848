"""The frozen counts from shapes equal FlopCounterMode over the program on
the CPU at small sizes, and the port's own counts at the cells' sizes."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.spec import Bench


def _config(name):
    bench = Bench()
    return bench.config(name)


@pytest.mark.parametrize("hw", [(36, 52), (45, 61)])
def test_stylize_flops_equal_flop_counter(one_thread, hw):
    from faststyle_tpu_torch.models import transform_net

    params = transform_net.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        transform_net.apply(params, x)
    model = _config("johnson_in_resize_starry")["model"]
    assert counter.get_total_flops() == flops.stylize_frame_flops(model, *hw)
    assert flops.output_shape(model, *hw) == transform_net.output_shape(*hw)


def _cudnn_input_grad(dy, w, stride, padding, x_hw):
    """The data gradient as the card's bf16 step takes it: one
    aten.convolution_backward (cuDNN's there)."""
    x = dy.new_zeros((dy.shape[0], w.shape[1], *x_hw))
    return torch.ops.aten.convolution_backward(dy, x, w, None, [stride] * 2, list(padding), [1, 1], False, [0, 0],
                                               1, [True, False, False])[0]


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_train_step_flops_equal_flop_counter(one_thread, monkeypatch, precision):
    from faststyle_tpu_torch.models import vgg16
    from faststyle_tpu_torch.ops import conv_grad
    from faststyle_tpu_torch.training import slow_style, train_step

    if precision == "bfloat16":
        monkeypatch.setattr(conv_grad, "input_grad", _cudnn_input_grad)
    config = dict(_config("johnson_in_resize_vgg16_train"), precision=precision)
    tc = train_step.TrainConfig.make(compute_dtype=torch.bfloat16 if precision == "bfloat16" else None)
    vgg = vgg16.init_params(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    grams = slow_style.style_target_grams(vgg, rng.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32),
                                          tuple(dict(tc.style_weights)))
    state = train_step.init_state(tc, seed=1, device="cpu")
    step = train_step.make_train_step(vgg, grams, tc)
    batch = torch.from_numpy(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    assert counter.get_total_flops() == flops.train_step_flops(config, 2, 64, 64)


def test_counts_equal_the_ports_at_the_cells_sizes():
    from faststyle_tpu_torch import bench
    from faststyle_tpu_torch.utils.profiling import stylize_ops

    model = _config("johnson_in_resize_starry")["model"]
    for h, w in ((2160, 3840), (1080, 1920)):
        assert flops.stylize_frame_flops(model, h, w) == stylize_ops(h, w)
    config = _config("johnson_in_resize_vgg16_train")
    assert flops.train_step_flops(config, 16, 256, 256) == bench.train_step_flops(16, 256)
