"""AdaIN on the port (faststyle_tpu_torch.models.adain) on the CPU: the walk
against the plain float32 reference (faststyle_tpu_torch/reference/adain.py,
naoto0804/pytorch-AdaIN's net.py and function.py) at an even and an odd
size with two styles; encode_style against calc_mean_std; the unbiased
instance norm; the instance-norm kernels' C = 512 plan and layout; the
reflect-padded conv without its padded copy; the Stylizer, FramePipeline
(each frame in the style it was submitted with) and both stylize CLIs; the
benchmark's copy of the reference against the program's. The kernels
themselves run only on the card (chip_smoke.py's norm phase)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faststyle_tpu_torch.inference import Stylizer, pack_u8_host, save_params, unpack_u8_host  # noqa: E402
from faststyle_tpu_torch.models import adain  # noqa: E402
from faststyle_tpu_torch.ops import layers as L  # noqa: E402
from faststyle_tpu_torch.ops.cuda import instance_norm as IN  # noqa: E402
from faststyle_tpu_torch.reference import adain as reference  # noqa: E402
from faststyle_tpu_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# float32 walk against float32 reference: the same operations summed in
# other orders (the port folds 1/255 into conv0, runs the border of each
# reflect-padded conv as its own conv and takes rsqrt where the reference
# divides by sqrt) through 19 convs; read 0.002 counts at 64x48
FLOAT_TOL_COUNTS = 0.05
# uint8 frames: a float gap of 0.05 counts moves a pixel across a rounding
# edge by at most one count
U8_TOL_COUNTS = 1


@pytest.fixture(scope="module")
def params():
    return adain.init_params(torch.Generator().manual_seed(adain.WEIGHTS_SEED), device="cpu")


def _image(seed, h, w):
    """A smooth [h, w, 3] uint8 image: coarse cells upsampled, plus noise."""
    g = torch.Generator().manual_seed(seed)
    cells = torch.rand(1, 3, h // 8 + 2, w // 8 + 2, generator=g)
    img = torch.nn.functional.interpolate(cells, size=(h, w), mode="bilinear", align_corners=False) * 255
    img = img + 12 * torch.randn(1, 3, h, w, generator=g)
    return img.clamp(0, 255).round().to(torch.uint8)[0].permute(1, 2, 0).numpy()


STYLES = [_image(11, 40, 56), _image(12, 48, 48)]


def _nchw01(img):
    return torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float() / 255


@pytest.mark.parametrize("hw", [(64, 48), (37, 53)])
def test_walk_matches_the_plain_reference(params, hw):
    """Float32 in, float32 out: the port's walk is the reference's
    style_transfer x 255 within FLOAT_TOL_COUNTS; the shape law (an odd
    size goes through ceil-mode pools); uint8 out within U8_TOL_COUNTS of
    the reference's save_image rounding, for two styles."""
    h, w = hw
    frame = _image(hw[0], h, w)
    for style_img in STYLES:
        style = adain.encode_style(params, torch.from_numpy(style_img).float())
        got = adain.apply(params, torch.from_numpy(frame).float()[None], style)
        want = reference.style_transfer(params, _nchw01(frame), _nchw01(style_img)) * 255
        assert got.shape == (1, *adain.output_shape(h, w), 3) == (1, *want.shape[2:], 3)
        assert float((got[0].permute(2, 0, 1) - want[0]).abs().max()) <= FLOAT_TOL_COUNTS
        u8 = adain.apply(params, torch.from_numpy(frame)[None], style)[0, :h, :w].numpy()
        ref = reference.stylize_u8(params, frame, style_img, "cpu")
        assert u8.dtype == np.uint8 and np.abs(u8.astype(int) - ref.astype(int)).max() <= U8_TOL_COUNTS


def test_output_shape_law():
    assert adain.output_shape(2160, 3840) == (2160, 3840)
    assert adain.output_shape(37, 53) == (40, 56)
    assert adain.output_shape(1, 9) == (8, 16)


def test_encode_style_is_calc_mean_std(params):
    """The style's (mean, sigma) at relu4_1 are calc_mean_std's, float32."""
    img = STYLES[0]
    style = adain.encode_style(params, torch.from_numpy(img), style_id=7)
    mean, std = reference.calc_mean_std(reference.vgg(params, _nchw01(img)))
    assert style.id == 7 and style.mean.dtype == style.std.dtype == torch.float32
    torch.testing.assert_close(style.mean, mean.flatten(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(style.std, std.flatten(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_instance_norm_unbiased_path(dtype):
    """layers.instance_norm with correction=1 is (x - mean) / sqrt(torch.var
    + eps) * scale + shift; the default still takes the biased variance."""
    g = torch.Generator().manual_seed(0)
    x = (3 * torch.randn(2, 5, 7, 16, generator=g) + 1).to(dtype)
    scale, shift = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g)
    xf = x.float()
    for correction in (0, 1):
        var = xf.var(dim=(1, 2), keepdim=True, correction=correction)
        want = (scale * ((xf - xf.mean(dim=(1, 2), keepdim=True)) * torch.rsqrt(var + 1e-5)) + shift).to(dtype)
        got = L.instance_norm(x, scale, shift, 1e-5, correction=correction)
        torch.testing.assert_close(got, want, rtol=1e-5 if dtype == torch.float32 else 1e-2, atol=1e-5)
    assert torch.equal(L.instance_norm(x, scale, shift), L.instance_norm(x, scale, shift, 1e-3, correction=0))
    got = IN.instance_norm_epilogue(x, scale, shift, "none", eps=1e-5, correction=1)
    assert torch.equal(got, L.instance_norm(x, scale, shift, 1e-5, correction=1))


def test_the_kernels_take_c512():
    """C = 512 fits a block's stride of 16-byte vectors in both dtypes; the
    entry point refuses what the kernels cannot take."""
    assert IN.fits(512, torch.bfloat16) and IN.fits(512, torch.float32) and IN.fits(64, torch.float32)
    assert not IN.fits(1024, torch.float32) and not IN.fits(5, torch.bfloat16)
    x, v = torch.zeros(1, 4, 4, 512), torch.ones(512)
    for kwargs, match in (({"correction": 2}, "correction"), ({"eps": 0.0}, "eps")):
        with pytest.raises(ValueError, match=match):
            IN.instance_norm_epilogue(x, v, v, **kwargs)
    with pytest.raises(ValueError, match="divide"):
        IN.instance_norm_epilogue(torch.zeros(1, 4, 4, 1024), torch.ones(1024), torch.ones(1024))


@pytest.mark.parametrize("vec", [8, 4])
def test_c512_plan_covers_relu4_1_in_whole_strides(vec):
    """At a 4K frame's relu4_1 (270x480x512): slabs of whole block strides
    (a whole number of pixels, so a thread's channels never change), none
    empty, covering the image, one wave of an H100's blocks."""
    hwc = 270 * 480 * 512
    for slots in ((396, 396), (528, 660)):
        p = IN.plan(1, hwc, vec, slots)
        stride = IN.THREADS * vec
        assert p.slab % stride == 0 and stride % 512 == 0
        assert (p.splits - 1) * p.slab < hwc <= p.splits * p.slab
        assert 0.9 * slots[0] <= p.splits <= slots[0]


@pytest.mark.parametrize("h,w,vec,sms", [(3, 5, 8, 2), (7, 9, 4, 3), (12, 10, 8, 132)])
def test_c512_statistics_layout_gives_the_moments(h, w, vec, sms):
    """The statistics kernels' walk (slabs, a thread's fixed channels, the
    merge tree over THREADS * vec / 512 items a channel) gives var_mean's
    moments in float64 at C = 512."""
    from test_torch_instance_norm import _stats_as_the_kernels_walk

    x = np.random.default_rng(h * w).normal(1.0, 2.0, (1, h, w, 512))
    p = IN.plan(1, h * w * 512, vec, (sms * 3, sms * 4))
    got = _stats_as_the_kernels_walk(x[0], 512, p)
    np.testing.assert_allclose(got[:, 0], x.mean(axis=(1, 2))[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[:, 1], x.var(axis=(1, 2))[0], rtol=1e-12)


@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 2, 2, 4), (1, 1, 3, 4), (1, 9, 4, 8), (1, 2, 5, 3)])
@pytest.mark.parametrize("relu", [False, True])
def test_reflect_conv_without_the_padded_copy(shape, relu):
    """conv3x3_reflect is the conv over reflect_pad(x, 1) with its bias (and
    relu), the border recomputed from strips; 1-px extents, and autograd,
    pad x itself."""
    g = torch.Generator().manual_seed(sum(shape))
    x, w, b = torch.randn(shape, generator=g), torch.randn(6, shape[-1], 3, 3, generator=g), torch.randn(6, generator=g)
    want = L.conv2d(L.reflect_pad(x, 1), w, padding="VALID", bias=b, relu=relu)
    with torch.inference_mode():
        torch.testing.assert_close(L.conv3x3_reflect(x, w, b, relu), want, rtol=1e-5, atol=1e-5)
    xg = x.clone().requires_grad_()
    L.conv3x3_reflect(xg, w, b, relu).sum().backward()  # under autograd: the padded route
    assert xg.grad.shape == x.shape
    assert torch.equal(L.resize_nearest(x, 2), x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


def _adain_spans(fn):
    before = set(profiling.recorded())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, [s.name for s in profiling.recorded() if s not in before and s.name.startswith("adain.")]


def test_content_norm_takes_the_kernels_where_they_engage(params, monkeypatch):
    """With the kernels' device the CPU's, the content AdaIN goes through
    instance_norm_epilogue (one `adain.norm` span a forward) with the plain
    walk's frames; encode_style records one `adain.style` span; as shipped
    on the CPU, no `adain.norm` span."""
    frame = torch.from_numpy(_image(5, 24, 32))[None]
    style, names = _adain_spans(lambda: adain.encode_style(params, torch.from_numpy(STYLES[1]), style_id=3))
    assert names == ["adain.style"]
    with torch.inference_mode():
        plain, names = _adain_spans(lambda: adain.apply(params, frame, style, compute_dtype=torch.bfloat16))
        assert names == []
        monkeypatch.setattr(IN, "engages", IN.takes)
        fused, names = _adain_spans(lambda: adain.apply(params, frame, style, compute_dtype=torch.bfloat16))
    assert names == ["adain.norm"] and torch.equal(fused, plain)


def test_stylizer_serves_adain_with_a_style(params):
    """The model kind comes from the block names; the packed-u8 path (pad 0)
    and the plain path give the same frames; an AdaIN call needs a style and
    a transform net's refuses one."""
    from faststyle_tpu_torch.models import transform_net

    frame = _image(8, 37, 53)
    plain = Stylizer(params=params, device="cpu", compute_dtype=torch.bfloat16)
    packed = Stylizer(params=params, device="cpu", compute_dtype=torch.bfloat16, packed_input=True,
                      packed_output=True)
    assert plain.model == packed.model == "adain" and packed.pad == 0
    assert packed.output_shape(37, 53) == (40, 56)
    handle = packed.encode_style(STYLES[0])
    assert handle.id == 1 and packed.encode_style(STYLES[1]).id == 2
    assert np.array_equal(packed(frame, style=handle), plain(frame, style=plain.encode_style(STYLES[0])))
    with pytest.raises(ValueError, match="style"):
        packed(frame)
    johnson = Stylizer(params=transform_net.init_params(torch.Generator().manual_seed(0), device="cpu"),
                       device="cpu")
    assert johnson.model == "transform_net" and johnson.pad == 40
    with pytest.raises(ValueError, match="style"):
        johnson(frame, style=handle)
    with pytest.raises(ValueError, match="AdaIN"):
        johnson.encode_style(STYLES[0])


def test_stylizer_graphs_a_shape_called_again_and_holds_one_graph(params, monkeypatch):
    """The CUDA graph's selection, driven on the CPU with the capture and
    the replay stubbed: a shape seen once runs eagerly, the next call at it
    captures (in place of any graph held) and replays, later calls replay
    with their own frame and style copied in."""
    from faststyle_tpu_torch import inference

    stylizer = Stylizer(params=params, device="cpu", compute_dtype=torch.bfloat16, packed_input=True,
                        packed_output=True)
    styles = [stylizer.encode_style(s) for s in STYLES]
    captured, replayed = [], []

    class Graph:
        def replay(self):
            replayed.append((g.x.clone(), g.style.mean.clone()))

    def capture(key, x, hw, style):
        nonlocal g
        captured.append(key)
        g = inference._Graph(key, Graph(), x.clone(), adain.Style(0, style.mean.clone(), style.std.clone()),
                             torch.zeros(1), False)
        return g

    g = None
    monkeypatch.setattr(stylizer, "_capture", capture)
    a, b = [(torch.as_tensor(pack_u8_host(_image(30 + i, *hw)[None], 0)), hw)
            for i, hw in enumerate([(16, 24), (24, 16)])]
    with torch.inference_mode():
        eager = stylizer._graphed(*a, styles[0])
        assert captured == [] and eager.dtype == torch.uint8
        stylizer._graphed(*a, styles[1])
        assert captured == [(tuple(a[0].shape), torch.uint8, (16, 24))] and len(replayed) == 1
        assert torch.equal(replayed[0][0], a[0]) and torch.equal(replayed[0][1], styles[1].mean)
        stylizer._graphed(*b, styles[0])  # a new shape: eager, the graph kept
        assert len(captured) == 1 and len(replayed) == 1
        stylizer._graphed(*a, styles[0])
        assert len(captured) == 1 and len(replayed) == 2 and torch.equal(replayed[1][1], styles[0].mean)
        stylizer._graphed(*b, styles[1])  # b again: captured in place of a's graph
        assert len(captured) == 2 and stylizer._graph.key == captured[1] != captured[0]


def test_frame_pipeline_keeps_each_frames_style(params):
    """Frames in flight across a style switch come back each in the style
    it was submitted with, through the packed ring at depth 2."""
    from faststyle_tpu_torch.cli.stylize_webcam import FramePipeline

    stylizer = Stylizer(params=params, device="cpu", compute_dtype=torch.bfloat16, packed_input=True,
                        packed_output=True)
    handles = [stylizer.encode_style(s) for s in STYLES]
    frames = [_image(20 + i, 36, 44) for i in range(5)]
    styles = [0, 0, 1, 1, 0]
    pipe = FramePipeline(stylizer, 36, 44, depth=2)
    got = []
    for frame, k in zip(frames, styles):
        pipe.submit(frame, handles[k])
        if len(pipe) > 2:
            got.append(pipe.fetch()[1].copy())
    while len(pipe):
        got.append(pipe.fetch()[1].copy())
    for frame, k, out in zip(frames, styles, got):
        assert np.array_equal(out, stylizer(frame, style=handles[k])[:36, :44])
    assert not np.array_equal(got[1], stylizer(frames[1], style=handles[1])[:36, :44])


def test_stylize_clis_take_a_style_image(params, tmp_path):
    """stylize_image and stylize_webcam serve an AdaIN params file with
    --style_image (the shorter side resized to 512 first)."""
    from faststyle_tpu_torch.cli import stylize_image, stylize_webcam
    from faststyle_tpu_torch.utils import image_io

    model = tmp_path / "adain.npz"
    save_params(model, params)
    content, style_path, out_path = tmp_path / "c.png", tmp_path / "s.png", tmp_path / "o.png"
    image_io.imwrite(content, _image(3, 29, 35))
    image_io.imwrite(style_path, _image(4, 32, 40))
    out = stylize_image.main(["--input_img_path", str(content), "--output_img_path", str(out_path), "--model_path",
                              str(model), "--style_image", str(style_path), "--device", "cpu"])
    stylizer = Stylizer(model_path=model, device="cpu")
    style = stylizer.encode_style(stylize_image.load_style_image(style_path))
    assert out.shape == stylizer.output_shape(29, 35) + (3,) == (32, 40, 3)  # as the decoder gives it
    assert np.array_equal(out, stylizer(image_io.imread(content), style=style))
    with pytest.raises(SystemExit, match="style_image"):
        stylize_image.main(["--input_img_path", str(content), "--model_path", str(model), "--device", "cpu"])
    seen = []
    result = stylize_webcam.main(["--model_path", str(model), "--style_image", str(style_path), "--device", "cpu",
                                  "--num_synthetic_frames", "3", "--resolution", "24", "16", "--no_display",
                                  "--packed_fetch", "--pipeline_depth", "2"], on_frame=lambda f: seen.append(f.copy()))
    assert result["frames"] == 3 and all(f.shape == (16, 24, 3) for f in seen)


def test_benchmark_reference_equals_the_programs(params):
    """The benchmark's copy draws the configuration's weights as the
    program's init_params does from the same seed, and stylizes as the
    program's reference does, bit for bit."""
    from benchmark.reference import adain as bench_reference

    config = json.loads((ROOT / "benchmark" / "configs" / "adain_vgg19_relu4_1.json").read_text())
    assert config["weights_seed"] == adain.WEIGHTS_SEED and config["last_conv_scale"] == adain.LAST_SCALE
    assert tuple(config["last_conv_bias"]) == adain.LAST_BIAS
    drawn = bench_reference.init_params(config)
    assert drawn.keys() == params.keys()
    assert all(torch.equal(drawn[b][v], params[b][v]) for b in params for v in params[b])
    frame = _image(6, 29, 43)
    moments = bench_reference.style_moments(drawn, STYLES[1], "cpu")
    assert np.array_equal(bench_reference.stylize_u8(drawn, frame, moments, "cpu"),
                          reference.stylize_u8(params, frame, STYLES[1], "cpu"))


@pytest.mark.parametrize("path", ["faststyle_tpu_torch/reference/adain.py", "benchmark/reference/adain.py"])
def test_references_import_neither_jax_nor_the_port(path):
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("faststyle_tpu_torch", "faststyle_tpu", "jax", "jaxlib", "flax"), name
