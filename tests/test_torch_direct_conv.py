"""The serving walk's direct 9x9 conv (faststyle_tpu_torch.ops.cuda.
direct_conv) on the CPU: the rule by which `layers.conv2d` routes a conv
to the kernel; the plain version against float64; the kernels' tiling
(every output written once, every tap staged) and both forms' arithmetic
walked in plain torch against float64 convs; the tile constants shared
with csrc/direct_conv.cu; the walk's two `conv.direct` spans a bf16 serving
forward and none in training; the kernels' names in the benchmark's `conv`
family; and the benchmark's reader of those spans. The CUDA kernels
themselves run only on the card (chip_smoke.py phase `conv` holds them
against the float32 conv there)."""

import re
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from benchmark.harness import Context, Record, Run  # noqa: E402
from benchmark.spec import Bench, family_of  # noqa: E402
from benchmark.trace import Spans, TraceData  # noqa: E402
from faststyle_tpu_torch.inference import Stylizer, load_params, pack_u8_host  # noqa: E402
from faststyle_tpu_torch.models import transform_net  # noqa: E402
from faststyle_tpu_torch.ops import layers as L  # noqa: E402
from faststyle_tpu_torch.ops.cuda import direct_conv as D  # noqa: E402
from faststyle_tpu_torch.utils import profiling  # noqa: E402

JOHNSON = [(3, 16), (16, 3)]  # (ci, co) of initconv_0 and upsample_2


def _x(shape, dtype=torch.bfloat16, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _w(co, ci, k=9, seed=1):
    return torch.randn(co, ci, k, k, generator=torch.Generator().manual_seed(seed)) * 0.1


def _conv64(x, w):
    """The SAME 9x9 conv in float64, NHWC."""
    return F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), padding=4).permute(0, 2, 3, 1)


# A model of csrc/direct_conv.cu's tiling and of both forms' arithmetic in
# plain torch, held to the .cu file's constants by test_the_tiles_are_the_kernels.

# output rows and columns a tile, staged input columns
TILES = {"pixels": (16, 128, 128 + 2 * D.PAD), "kn": (8, 88, 96)}


class Plan(NamedTuple):
    """How one call is cut: tiles of `rows` x `cols` outputs, each reading
    input rows [y0 - 4, y0 + rows + 4) and staged columns [x0 - 4, x0 - 4 +
    `patch_cols`); `tiles_y` x `tiles_x` tiles an image, `tiles` in all, on
    `blocks` blocks. The pixels form's blocks persist: block b takes tiles
    b, b + blocks, ... The kn form's blocks each walk one segment of
    `seg_steps` tiles down a column of tiles (`segs` segments a column),
    streaming the input rows."""

    form: str
    rows: int
    cols: int
    patch_rows: int
    patch_cols: int
    tiles_y: int
    tiles_x: int
    tiles: int
    blocks: int
    segs: int = 1
    seg_steps: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, h: int, w: int, ci: int, co: int, slots: Optional[int] = None) -> Plan:
    """The tiling of an [n, h, w, ci] -> co call; `slots` blocks the card
    holds at once (None: as many as there are tiles)."""
    form = D.SHAPES[(ci, co)]
    rows, cols, patch_cols = TILES[form]
    ty, tx = _cdiv(h, rows), _cdiv(w, cols)
    tiles = n * ty * tx
    slots = slots or tiles
    if form == "pixels":
        return Plan(form, rows, cols, rows + 2 * D.PAD, patch_cols, ty, tx, tiles, min(tiles, slots))
    segs = max(1, slots // (n * tx))
    return Plan(form, rows, cols, rows + 2 * D.PAD, patch_cols, ty, tx, tiles, n * tx * segs, segs, _cdiv(ty, segs))


def tile_origins(p: Plan) -> torch.Tensor:
    """[tiles, 3] (image, first output row, first output column) of each
    tile: the pixels form's in the order the kernel numbers them, the kn
    form's block by block, each down its segment."""
    if p.form == "pixels":
        t = torch.arange(p.tiles)
        rest = t // p.tiles_x
        return torch.stack([rest // p.tiles_y, (rest % p.tiles_y) * p.rows, (t % p.tiles_x) * p.cols], dim=1)
    b = torch.arange(p.blocks)[:, None]
    step = (b % p.segs) * p.seg_steps + torch.arange(p.seg_steps)[None, :]  # [blocks, seg_steps] tile rows
    strip = (b // p.segs).expand_as(step)
    keep = step < p.tiles_y
    return torch.stack([strip[keep] // p.tiles_x, step[keep] * p.rows, (strip[keep] % p.tiles_x) * p.cols], dim=1)


def pixels_weights(w: torch.Tensor) -> torch.Tensor:
    """[co=16, ci=3, 9, 9] -> [9, 32, 16] (kh, k, co): k = kw * 3 + ci, zero
    for k >= 27, the pixels form's B."""
    co, ci = w.shape[:2]
    b = w.permute(2, 3, 1, 0).reshape(D.K, D.K * ci, co)  # (kh, (kw, ci), co)
    return F.pad(b, (0, 0, 0, 32 - D.K * ci))


def kn_weights(w: torch.Tensor) -> torch.Tensor:
    """[co=3, ci=16, 9, 9] -> [9, 16, 32] (kh, ci, n): n = kw * 3 + co, zero
    for n >= 27, the kn form's B."""
    co, ci = w.shape[:2]
    b = w.permute(2, 1, 3, 0).reshape(D.K, ci, D.K * co)  # (kh, ci, (kw, co))
    return F.pad(b, (0, 32 - D.K * co))


def pixels_tile(patch: torch.Tensor, b: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """One tile in the pixels form: patch [rows + 8, cols + 8, 3] -> [rows,
    cols, 16]. Staged row r holds its elements flat and 8 zeros after them;
    output column c's im2col row for tap row kh is the 32 elements of
    staged row (r + kh) from element 3c."""
    flat = F.pad(patch.reshape(patch.shape[0], -1), (0, 8))
    a = flat.unfold(1, 32, 3)[:, :cols]  # [patch rows, cols, 32]
    return sum(a[kh : kh + rows] @ b[kh] for kh in range(D.K))


def kn_tile(patch: torch.Tensor, b: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """One tile in the kn form: patch [rows + 8, staged columns, 16] ->
    [rows, cols, 3]. Partials of each staged column over (kw, co), summed
    over kh and ci; output column c sums partial (c + kw, kw, co) over kw."""
    part = sum(patch[kh : kh + rows] @ b[kh] for kh in range(D.K))  # [rows, staged columns, 32]
    return sum(part[:, kw : kw + cols, 3 * kw : 3 * kw + 3] for kw in range(D.K))


def direct_conv_by_plan(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic in plain torch, in x's dtype: `plan`'s tiles
    each staged with zeros outside the image and computed by its form, every
    output written by exactly one tile (raises otherwise)."""
    n, h, wd, ci = x.shape
    co = w.shape[0]
    p = plan(n, h, wd, ci, co)
    b = (pixels_weights if p.form == "pixels" else kn_weights)(w.to(x.dtype))
    tile = pixels_tile if p.form == "pixels" else kn_tile
    # zeros around the image, enough for every tile's staged rows and columns
    xp = F.pad(x, (0, 0, D.PAD, p.patch_cols + p.cols, D.PAD, p.patch_rows + p.rows))
    y = torch.full((n, h, wd, co), float("nan"), dtype=x.dtype)
    for img, y0, x0 in tile_origins(p).tolist():
        patch = xp[img, y0 : y0 + p.patch_rows, x0 : x0 + p.patch_cols]
        out = tile(patch, b, p.rows, p.cols)
        rows, cols = min(p.rows, h - y0), min(p.cols, wd - x0)
        if not torch.isnan(y[img, y0 : y0 + rows, x0 : x0 + cols]).all():
            raise AssertionError(f"tile ({img}, {y0}, {x0}) writes outputs another tile wrote")
        y[img, y0 : y0 + rows, x0 : x0 + cols] = out[:rows, :cols]
    if torch.isnan(y).any():
        raise AssertionError("some outputs are written by no tile")
    return y



@pytest.mark.parametrize("ci,co", JOHNSON)
def test_takes_the_johnson_9x9s(ci, co):
    """bf16, 9x9, stride 1, SAME, no bias or relu, nothing recording a
    gradient (grad mode off, or on with nothing requiring grad): taken; on
    the CPU `engages` stays false, so the CPU walk never routes here."""
    x, w = _x((1, 12, 10, ci)), _w(co, ci)
    assert D.takes(x, w, 1, "SAME")
    with torch.inference_mode():
        assert D.takes(x, w)
    assert not D.engages(x, w)


@pytest.mark.parametrize("case", [
    "float32", "float16", "x_requires_grad", "w_requires_grad", "bias", "relu", "stride_2", "valid", "3x3", "1x1",
    "adain_3x3_512", "adain_conv0_1x1", "adain_decoder_last_3x3", "vgg16_conv1_1", "3_to_32", "16_to_16", "4_to_16",
    "16_to_4", "3_to_3",
])
def test_refuses_every_other_conv(case):
    """Float types other than bf16, a conv autograd records, a bias or relu,
    stride 2, VALID, other kernel extents, AdaIN's and VGG16's convs, and
    other channel counts all keep today's cuDNN path."""
    x, w, kw = _x((1, 12, 10, 3)), _w(16, 3), {}
    if case in ("float32", "float16"):
        x = x.to(getattr(torch, case))
    elif case == "x_requires_grad":
        x = x.float().requires_grad_().to(torch.bfloat16)
    elif case == "w_requires_grad":
        w = w.requires_grad_()
    elif case == "bias":
        kw["bias"] = torch.zeros(16)
    elif case == "relu":
        kw["relu"] = True
    elif case == "stride_2":
        kw["stride"] = 2
    elif case == "valid":
        kw["padding"] = "VALID"
    elif case in ("3x3", "1x1"):
        w = _w(16, 3, int(case[0]))
    else:
        ci, co, k = {"adain_3x3_512": (512, 256, 3), "adain_conv0_1x1": (3, 3, 1), "adain_decoder_last_3x3": (64, 3, 3),
                     "vgg16_conv1_1": (3, 64, 3), "3_to_32": (3, 32, 9), "16_to_16": (16, 16, 9),
                     "4_to_16": (4, 16, 9), "16_to_4": (16, 4, 9), "3_to_3": (3, 3, 9)}[case]
        x, w = _x((1, 12, 10, ci)), _w(co, ci, k)
    assert not D.takes(x, w, **kw)


@pytest.mark.parametrize("ci,co", JOHNSON)
@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (1, 7, 5), (2, 13, 11), (1, 9, 31)])
def test_plain_version_is_the_float64_conv_rounded_once(ci, co, n, h, w):
    """F.conv2d in float32 on the bf16 values, rounded to bf16: within half a
    bf16 unit of the float64 SAME conv (plus float32's summation error) at
    odd sizes, bf16 [n, h, w, co] out, and what the CPU entry point returns."""
    x, wt = _x((n, h, w, ci), seed=h), _w(co, ci, seed=w).to(torch.bfloat16)
    y = D.direct_conv_plain(x, wt)
    assert y.dtype == torch.bfloat16 and y.shape == (n, h, w, co) and y.is_contiguous()
    want = _conv64(x, wt)
    mag = F.conv2d(x.double().abs().permute(0, 3, 1, 2), wt.double().abs(), padding=4).permute(0, 2, 3, 1)
    half_ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 9)
    assert ((y.double() - want).abs() <= half_ulp + 1e-6 * mag).all()
    assert torch.equal(D.direct_conv(x, wt), y)


@pytest.mark.parametrize("ci,co", JOHNSON)
@pytest.mark.parametrize("n,h,w", [(1, 2240, 3920), (1, 2160, 3840), (1, 1, 1), (1, 7, 5), (3, 37, 250),
                                   (1, 668, 3920), (1, 588, 3840)])
def test_the_tiles_cover_every_output_once_and_stage_every_tap(ci, co, n, h, w):
    """The plan's tiles (at 4K, 1x1, 7x5, three ragged images and a 4K
    frame's 4-way row window) write each output pixel exactly once, and each
    tile's staged rows and columns hold every tap of its outputs, each tap
    inside the image or within the 4-px zero pad; `blocks` never exceeds the
    tiles."""
    p = plan(n, h, w, ci, co, slots=264)
    assert p.blocks <= max(264, n * p.tiles_x) and p.patch_rows == p.rows + 8 and p.patch_cols >= p.cols + 8
    org = tile_origins(p).numpy()
    assert len(org) == p.tiles == n * p.tiles_y * p.tiles_x
    count = np.zeros((n, h + 1, w + 1), np.int32)  # a 2-D difference array of each tile's outputs
    for img, y0, x0 in org:
        y1, x1 = min(y0 + p.rows, h), min(x0 + p.cols, w)
        assert y0 < y1 and x0 < x1, "a tile with no output"
        count[img, y0, x0] += 1
        count[img, y0, x1] -= 1
        count[img, y1, x0] -= 1
        count[img, y1, x1] += 1
        # the taps of the tile's outputs, rows y0 - 4 .. y1 + 3 and columns
        # x0 - 4 .. x1 + 3, all inside the image or its 4-px zero pad, and
        # all among the staged rows and columns (staged from y0 - 4, x0 - 4)
        assert 0 <= y0 and y1 <= h and 0 <= x0 and x1 <= w
        assert y1 + 4 <= y0 - 4 + p.patch_rows and x1 + 4 <= x0 - 4 + p.patch_cols
    written = count.cumsum(1).cumsum(2)[:, :h, :w]
    assert (written == 1).all()


@pytest.mark.parametrize("ci,co", JOHNSON)
@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (1, 7, 5), (2, 19, 133), (1, 21, 250), (1, 4, 300)])
def test_each_form_walked_in_plain_torch_is_the_conv(ci, co, n, h, w):
    """`direct_conv_by_plan` in float64 (the plan's tiles staged with zeros
    outside the image; the pixels form's im2col rows as 32 consecutive
    staged elements from 3c against K = 288 weights, the kn form's partials
    over (kw, co) then their shifted sum) equals the float64 conv."""
    x, wt = _x((n, h, w, ci), torch.float64, seed=h + w), _w(co, ci, seed=n).double()
    assert torch.allclose(direct_conv_by_plan(x, wt), _conv64(x, wt), rtol=0, atol=1e-12)


def test_kn_partials_then_the_shifted_sum_is_the_conv():
    """The kn form's arithmetic alone, over one whole row band: partials
    P[m, kw, co] = sum over kh, ci of x[., m, ci] w[co, ci, kh, kw] of every
    zero-padded input column, then y[c, co] = sum over kw of P[c + kw, kw, co]."""
    x, wt = _x((1, 6, 23, 16), torch.float64, seed=5), _w(3, 16, seed=6).double()
    xp = F.pad(x, (0, 0, 4, 4, 4, 4))[0]  # [14, 31, 16]
    b = kn_weights(wt)  # [9, 16, 32]
    part = sum(xp[kh : kh + 6] @ b[kh] for kh in range(9))  # [6, 31, 32]
    y = sum(part[:, kw : kw + 23, 3 * kw : 3 * kw + 3] for kw in range(9))
    assert torch.allclose(y, _conv64(x, wt)[0], rtol=0, atol=1e-12)
    assert (b[..., 27:] == 0).all() and (pixels_weights(_w(16, 3).double())[:, 27:] == 0).all()


def test_the_tiles_are_the_kernels():
    """The model's TILES match csrc/direct_conv.cu's tile constants."""
    src = (Path(D.__file__).resolve().parents[2] / "csrc" / "direct_conv.cu").read_text()
    const = {m[1]: m[2] for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", src)}
    env: dict = {}
    for name, expr in const.items():
        env[name] = eval(expr, {}, dict(env))  # noqa: S307 - the source's own constant expressions
    assert TILES["pixels"] == (env["PX_ROWS"], env["PX_COLS"], env["PX_COLS"] + 2 * env["PAD"])
    assert TILES["kn"] == (env["KN_ROWS"], env["KN_COLS"], env["KN_PCOLS"])
    assert env["KN_SLOTS"] == env["KN_ROWS"] + 2 * env["PAD"] + env["KN_ROWS"]
    assert env["K"] == D.K and env["PAD"] == D.PAD


@pytest.mark.parametrize("bad,match", [
    (lambda: D.direct_conv(_x((1, 5, 5, 3), torch.float32), _w(16, 3)), "bfloat16"),
    (lambda: D.direct_conv(_x((1, 5, 5, 3)), _w(16, 3, 3)), "9x9"),
    (lambda: D.direct_conv(_x((1, 5, 5, 4)), _w(16, 4)), "9x9"),
    (lambda: D.direct_conv(_x((1, 5, 5, 16)), _w(16, 3)), "9x9"),
    (lambda: D.direct_conv(_x((1, 5, 6, 3)).transpose(1, 2), _w(16, 3)), "contiguous"),
    (lambda: D.direct_conv(_x((5, 5, 3)), _w(16, 3)), "NHWC"),
])
def test_refuses_what_the_kernels_do_not_take(bad, match):
    with pytest.raises((ValueError, TypeError), match=match):
        bad()


@pytest.mark.parametrize("name", [
    "(anonymous namespace)::direct_conv_kernel(unsigned short const*, unsigned short const*, __nv_bfloat16*, int, "
    "int, int, int, long long)",
    "(anonymous namespace)::direct_conv_kn_kernel(__nv_bfloat16 const*, unsigned short const*, __nv_bfloat16*, int, "
    "int, int, int, long long)",
    "direct_conv_kernel", "direct_conv_kn_kernel",
])
def test_the_kernels_are_filed_as_convs(name):
    """The benchmark's kernel tables file both kernels under `conv`, so
    `conv_roofline.stylize` counts their time and `nonconv_ms_per_frame`
    does not."""
    assert family_of(name, Bench().kernel_tables()) == "conv"


@pytest.fixture
def kernel_device_is_the_cpu(monkeypatch):
    """The walk treats CPU activations as the card's: engages() is the
    rule without the device, and direct_conv runs its plain version."""
    monkeypatch.setattr(D, "engages", D.takes)


def _direct_spans(fn):
    before = set(profiling.recorded())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.recorded() if s not in before and s.name == "conv.direct"]


@pytest.mark.parametrize("method", transform_net.UPSAMPLE_METHODS)
def test_a_bf16_serving_forward_runs_two_direct_convs(kernel_device_is_the_cpu, method):
    """With the kernel's device the CPU's, a bf16 Stylizer's packed-u8
    forward hands initconv_0 and upsample_2 (the deconv variant's final
    conv too) to direct_conv, one `conv.direct` span each; a float32
    forward hands it none."""
    params = transform_net.init_params(torch.Generator().manual_seed(3), method, device="cpu")
    frames = np.random.default_rng(4).integers(0, 256, (1, 46, 50, 3), dtype=np.uint8)
    packed = torch.as_tensor(pack_u8_host(frames))
    for dtype, want in ((torch.bfloat16, 2), (None, 0)):
        stylizer = Stylizer(params=params, upsample_method=method, compute_dtype=dtype, packed_input=True,
                            packed_output=True, device="cpu")
        _, spans = _direct_spans(lambda: stylizer.stylize_device(packed, (46, 50)))
        assert len(spans) == want


@pytest.mark.parametrize("seed", [4, 5])
def test_the_direct_route_keeps_bf16_serving_as_close_to_float32(kernel_device_is_the_cpu, monkeypatch, seed):
    """The shipped starry weights in bf16: the frames of the direct route sit
    as close to the float32 walk's as those of cuDNN's route (about half a
    count on average either way; one bf16 rounding that flips anywhere
    reaches every pixel through the instance norms' moments, so the two
    bf16 routes themselves differ about as much)."""
    params = load_params(Path(__file__).resolve().parents[1] / "weights" / "starry_final.npz", device="cpu")
    frames = torch.as_tensor(np.random.default_rng(seed).integers(0, 256, (1, 46, 50, 3), dtype=np.uint8))

    def frame(dtype):
        with torch.inference_mode():
            return transform_net.apply(params, frames, compute_dtype=dtype).int()

    direct = frame(torch.bfloat16)
    monkeypatch.setattr(D, "engages", lambda *_: False)
    cudnn, f32 = frame(torch.bfloat16), frame(None)
    gap, cudnn_gap = ((t - f32).abs().double().mean() for t in (direct, cudnn))
    assert gap <= 1.1 * cudnn_gap + 0.05 and cudnn_gap < 1.0


def test_a_train_step_records_no_direct_conv(kernel_device_is_the_cpu):
    """Autograd records the train step's forward, so neither 9x9 takes the
    kernel even where its device is the CPU's; the float32 net serving under
    no_grad takes it neither."""
    step, state = profiling.recipe_step(16, device="cpu")
    batch = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0)) * 255
    _, spans = _direct_spans(lambda: step(state, batch))
    assert spans == []
    with torch.no_grad():
        _, spans = _direct_spans(lambda: state.net(batch))
    assert spans == []


def test_a_bf16_conv2d_under_no_grad_takes_the_kernel(kernel_device_is_the_cpu):
    """layers.conv2d itself: the matching call runs direct_conv (its plain
    version here) inside one span; with a relu it keeps cuDNN's route."""
    x, w = _x((1, 9, 7, 3)), _w(16, 3)
    with torch.no_grad():
        y, spans = _direct_spans(lambda: L.conv2d(x, w))
        assert len(spans) == 1 and torch.equal(y, D.direct_conv_plain(x, w))
        _, spans = _direct_spans(lambda: L.conv2d(x, w, relu=True))
        assert spans == []


MS = 1_000_000


class _Span:
    def __init__(self, name, start_ms, end_ms):
        self.name, self.start_ns, self.end_ns = name, int(start_ms * MS), int(end_ms * MS)


def _run(trace):
    bench = Bench()
    cell = bench.cell("stylize_4k_d4")
    ctx = Context(bench, cell, bench.config(cell["config"]), bench.traffic(cell["traffic"]), 0, 1.0, True, None, 0.0)
    return Run(ctx, Record(1.0, 1.0, 0, 0, {}, {}, 0, Spans(), trace), "NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("records,want", [
    ([], None),  # a program that records no spans (the parent's)
    ([("stream.submit", 110, 120)], None),  # frames, no direct conv
    ([("conv.direct", 112, 113)], None),  # no frame
    ([(n, s + k, s + k + 0.5) for s in (110, 150) for k, n in enumerate(["stream.submit"] + ["conv.direct"] * 2)]
     + [("stream.submit", 90, 99), ("conv.direct", 91, 92), ("stream.submit", 200, 210), ("conv.direct", 201, 202)],
     2.0),  # the window's two frames; those before it and at its end left out
])
def test_direct_convs_per_frame_reader(monkeypatch, records, want):
    """`direct_convs_per_frame.stylize`: conv.direct spans over
    stream.submit spans starting in the traced window [100, 200) ms; None
    without either, and None without a trace."""
    from benchmark import program_spans

    monkeypatch.setattr(program_spans, "recorded", lambda: [_Span(*r) for r in records])
    trace = TraceData(100 * MS, 200 * MS, [], [("bench.window", 100 * MS, 200 * MS)])
    reader = Bench().reader("direct_convs_per_frame.stylize")
    assert reader.read(_run(trace)) == want
    assert reader.read(_run(None)) is None
