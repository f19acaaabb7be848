"""The AdaIN counts from shapes (benchmark/adain_flops.py) equal
FlopCounterMode over the program's forward on the CPU at small sizes, and
the totals at the cell's size (8.0 TFLOP a 4K frame)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import adain_flops
from benchmark.spec import Bench


def _model():
    bench = Bench()
    return bench.config(bench.cell("adain_4k_d4")["config"])["model"]


@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_frame_flops_equal_flop_counter(one_thread, hw):
    """The port's forward runs the convs and their edge convs; the plain
    reference's runs the model's 19."""
    from benchmark.reference import adain as reference
    from faststyle_tpu_torch.models import adain

    params = adain.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(1)) * 255
    style = adain.encode_style(params, x[0])
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        adain.apply(params, x, style)
    model = _model()
    assert counter.get_total_flops() == sum(c.flops for c in adain_flops.convs(model, *hw))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:  # the model's 19 convs alone
        reference.decoder(params, reference.vgg(params, x.permute(0, 3, 1, 2) / 255))
    assert counter.get_total_flops() == adain_flops.frame_flops(model, *hw)
    assert adain_flops.output_shape(model, *hw) == adain.output_shape(*hw)


def test_counts_at_the_cells_size():
    """3840x2160: 8.0 TFLOP, half in each tower; the convs' least time about
    8.8 ms at 989 TFLOP/s and 3.35 TB/s; the content norm 6 B an element of
    relu4_1 (270x480x512)."""
    model = _model()
    convs = [c for c in adain_flops.convs(model, 2160, 3840) if c.kind == "fwd"]
    assert len(convs) == 19
    enc, dec = sum(c.flops for c in convs[:10]), sum(c.flops for c in convs[10:])
    assert abs(enc - 4.0e12) < 0.01e12 and abs(dec - 4.0e12) < 0.01e12
    assert 8.7e-3 < sum(c.least_s(989e12, 3.35e12) for c in convs) < 8.9e-3
    assert adain_flops.features_shape(model, 2160, 3840) == (270, 480, 512)
    assert adain_flops.norm_bytes(model, 2160, 3840) == 6 * 270 * 480 * 512
