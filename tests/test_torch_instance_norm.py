"""The serving path's fused instance norm (faststyle_tpu_torch.ops.cuda.
instance_norm) on the CPU: its plain version against layers.instance_norm
and the epilogues it fuses; the kernels' launch plan and a plain walk of
the statistics kernels' layout (slabs, a thread's channels, the fixed merge
tree) against float64 moments; the transform net's walk taking the fused
route wherever the kernels would run, with the same frames as the plain
walk and one `norm.fused` span a norm; no such span in a train step; and
the benchmark's reader of those spans. The CUDA kernels themselves run only
on the card (chip_smoke.py holds them against the plain version there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.harness import Context, Record, Run  # noqa: E402
from benchmark.spec import Bench  # noqa: E402
from benchmark.trace import Spans, TraceData  # noqa: E402
from faststyle_tpu_torch.inference import Stylizer, pack_u8_host, unpack_u8_host  # noqa: E402
from faststyle_tpu_torch.models import transform_net  # noqa: E402
from faststyle_tpu_torch.ops import layers as L  # noqa: E402
from faststyle_tpu_torch.ops.cuda import instance_norm as IN  # noqa: E402
from faststyle_tpu_torch.utils import profiling  # noqa: E402

CHANNELS = (3, 16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)
# the 16 norms of a 3840x2160 frame: (h, w, c), as the walk meets them
SHAPES_4K = ([(2240, 3920, 16), (1120, 1960, 32), (560, 980, 64)]
             + [(560 - 2 * k, 980 - 2 * k, 64) for k in range(1, 11)]
             + [(1080, 1920, 32), (2160, 3840, 16), (2160, 3840, 3)])


def _inputs(seed, h, w, c, dtype):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(2, h, w, c, generator=g) + 1.5).to(dtype)
    scale = 1 + 0.5 * torch.randn(c, generator=g)
    shift = torch.randn(c, generator=g)
    skip = (2 * torch.randn(2, h + 4, w + 4, c, generator=g)).to(dtype)
    return x, scale, shift, skip


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("epilogue", IN.EPILOGUES)
def test_plain_version_is_the_norm_then_its_epilogue(epilogue, c, dtype):
    """Exactly layers.instance_norm, then relu, the crop-2 add, or
    scaled_tanh (and clamp, uint8) at odd H and W; the same chain on given
    moments (the card's check) reads the same bits from var_mean's; the
    CPU entry point is the plain version."""
    x, scale, shift, skip = _inputs(c, 7, 9, c, dtype)
    skip = skip if epilogue == "residual" else None
    y = L.instance_norm(x, scale, shift)
    want = {"none": lambda: y, "relu": lambda: torch.relu(y), "residual": lambda: y + skip[:, 2:-2, 2:-2, :],
            "tanh": lambda: L.scaled_tanh(y),
            "tanh_u8": lambda: L.scaled_tanh(y).clamp(0, 255).to(torch.uint8)}[epilogue]()
    got = IN.instance_norm_epilogue_plain(x, scale, shift, epilogue, skip)
    assert got.dtype == want.dtype == (torch.uint8 if epilogue == "tanh_u8" else dtype)
    assert torch.equal(got, want)
    var, mean = torch.var_mean(x.float(), dim=(1, 2), correction=0)
    given = IN.instance_norm_epilogue_plain(x, scale, shift, epilogue, skip, stats=(mean, torch.rsqrt(var + 1e-3)))
    assert torch.equal(given, want)
    assert torch.equal(IN.instance_norm_epilogue(x, scale, shift, epilogue, skip), want)


@pytest.mark.parametrize("bad,match", [
    (lambda x, s, b, k: (x[..., :5].contiguous(), s[:5], b[:5], "none", None), "divide"),
    (lambda x, s, b, k: (x.transpose(1, 2), s, b, "none", None), "contiguous"),
    (lambda x, s, b, k: (x.half(), s, b, "none", None), "float32 or bfloat16"),
    (lambda x, s, b, k: (x, s, b, "residual", None), "skip"),
    (lambda x, s, b, k: (x, s, b, "relu", k), "skip"),
    (lambda x, s, b, k: (x, s, b, "residual", k[:, 1:]), "skip"),
    (lambda x, s, b, k: (x, s[:3], b, "none", None), "scale"),
    (lambda x, s, b, k: (x, s, b, "gelu", None), "epilogue"),
])
def test_refuses_what_the_kernels_do_not_take(bad, match):
    x, scale, shift, skip = _inputs(0, 6, 8, 16, torch.float32)
    with pytest.raises((ValueError, TypeError), match=match):
        IN.instance_norm_epilogue(*bad(x, scale, shift, skip))


def _merge(a, b):
    """Chan's formula, as csrc/instance_norm.cu merges, in float64."""
    (na, ma, qa), (nb, mb, qb) = a, b
    if nb == 0:
        return a
    if na == 0:
        return b
    n = na + nb
    d = mb - ma
    return n, ma + d * nb / n, qa + qb + d * d * na * nb / n


def _stats_as_the_kernels_walk(img: np.ndarray, c: int, p: IN.NormPlan):
    """One image's moments walked as the statistics kernels lay them out:
    block s takes elements [s*slab, (s+1)*slab); thread t the vectors at
    t*vec + k*THREADS*vec of it, element j of each held as channel
    (t*vec + j) % c; the block folds items ch + c*k onto ch by halving;
    the merge kernel folds the blocks in order."""
    flat = img.reshape(-1).astype(np.float64)
    stride = IN.THREADS * p.vec
    items = IN.THREADS * p.vec
    per_split = []
    for s in range(p.splits):
        part = flat[s * p.slab: min((s + 1) * p.slab, flat.size)]
        moments = []
        for i in range(items):  # item i = t*vec + j
            vals = part[i::stride]
            assert np.all(np.arange(s * p.slab + i, s * p.slab + part.size, stride) % c == i % c)
            moments.append((vals.size, vals.mean() if vals.size else 0.0, ((vals - vals.mean()) ** 2).sum()
                            if vals.size else 0.0))
        length = items // c
        while length > 1:
            half, keep = length // 2, length - length // 2
            for i in range(c * half):
                moments[i] = _merge(moments[i], moments[i + c * keep])
            length = keep
        per_split.append(moments[:c])
    out = []
    for ch in range(c):
        m = (0, 0.0, 0.0)
        for split in per_split:
            m = _merge(m, split[ch])
        out.append((m[1], m[2] / m[0]))
    return np.array(out)


@pytest.mark.parametrize("h,w,c,vec,sms", [
    (7, 9, 3, 1, 132), (7, 9, 16, 1, 4), (40, 44, 3, 8, 6), (24, 32, 16, 8, 132), (23, 29, 32, 4, 3),
    (20, 22, 64, 8, 5), (12, 12, 64, 4, 2),
])
def test_the_statistics_layout_gives_the_moments(h, w, c, vec, sms):
    """The plan's slabs, each thread's fixed channels and the merge tree
    give var_mean's moments (float64, so only the layout is tested)."""
    x = np.random.default_rng(h * w + c).normal(2.0, 3.0, (1, h, w, c))
    p = IN.plan(1, h * w * c, vec, (sms * 3, sms * 4))
    got = _stats_as_the_kernels_walk(x[0], c, p)
    np.testing.assert_allclose(got[:, 0], x.mean(axis=(1, 2))[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[:, 1], x.var(axis=(1, 2))[0], rtol=1e-12)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("h,w,c", SHAPES_4K)
def test_the_plan_covers_every_element_in_whole_strides(h, w, c, n):
    """At the 4K frame's 16 norms: slabs of whole block strides (so a
    thread's channels never change), none empty, covering the image; each
    kernel one wave of as many blocks as the card holds, or nearly (an
    H100's 132 SMs, 3 to 5 blocks each); 16-byte vectors."""
    hwc = h * w * c
    for vec in (8, 4):  # bfloat16, float32
        for slots in ((396, 396), (528, 660), (660, 396)):
            p = IN.plan(n, hwc, vec, slots)
            stride = IN.THREADS * vec
            assert p.vec == vec and p.slab % stride == 0 and stride % c == 0
            assert (p.splits - 1) * p.slab < hwc <= p.splits * p.slab
            assert 0.9 * slots[0] <= n * p.splits <= slots[0]
            assert n * p.blocks == slots[1] // n * n


def test_vector_width_falls_back_to_one_element_a_load():
    """16 bytes a load where the pointers align and whole vectors fill an
    image (and a residual's rows); one element otherwise."""
    x = torch.zeros(2, 6, 8, 64, dtype=torch.bfloat16)
    skip = torch.zeros(2, 10, 12, 64, dtype=torch.bfloat16)
    assert IN.vector_width(x, None) == IN.vector_width(x, skip) == 8
    assert IN.vector_width(x.float(), None) == 4
    assert IN.vector_width(torch.zeros(1, 3, 5, 3), None) == 1  # 45 elements an image
    flat = torch.zeros(2 * 6 * 8 * 64 + 1, dtype=torch.bfloat16)
    assert IN.vector_width(flat[1:].view(2, 6, 8, 64), None) == 1
    assert IN.vector_width(torch.zeros(1, 4, 8, 3, dtype=torch.bfloat16), torch.zeros(1, 8, 12, 3,
                                                                                       dtype=torch.bfloat16)) == 1


def test_residual_reads_each_output_row_as_a_run_of_the_skip():
    """The apply kernel's skip offset for output element e (row y = e //
    (w*c), o = e % (w*c)): ((y + 2) * (w + 4) + 2) * c + o, the crop-2."""
    h, w, c = 5, 7, 16
    skip = torch.arange((h + 4) * (w + 4) * c).reshape(1, h + 4, w + 4, c)
    e = torch.arange(h * w * c)
    y, o = e // (w * c), e % (w * c)
    got = skip.reshape(-1)[((y + 2) * (w + 4) + 2) * c + o]
    assert torch.equal(got.reshape(1, h, w, c), skip[:, 2:-2, 2:-2, :])


@pytest.fixture
def kernel_device_is_the_cpu(monkeypatch):
    """The walk treats CPU activations as the card's: engages() is the
    kernels' rule without the device, and instance_norm_epilogue runs its
    plain version on them."""
    monkeypatch.setattr(IN, "engages", IN.takes)


def _fused_spans(fn):
    before = set(profiling.recorded())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.recorded() if s not in before and s.name == "norm.fused"]


@pytest.mark.parametrize("method", transform_net.UPSAMPLE_METHODS)
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
def test_serving_walk_takes_the_fused_route_with_the_same_frames(kernel_device_is_the_cpu, dtype, method):
    """With the kernels' device the CPU's, a Stylizer's packed-u8 forward
    (inference mode) hands all 16 norms to instance_norm_epilogue, one
    `norm.fused` span each, and returns the plain walk's frames bit for
    bit (apply_with_features, every norm plain, clipped to uint8); the
    uint8 and float outputs of apply take the same route."""
    params = transform_net.init_params(torch.Generator().manual_seed(3), method, device="cpu")
    frames = np.random.default_rng(4).integers(0, 256, (2, 46, 50, 3), dtype=np.uint8)
    x = torch.as_tensor(frames)
    want = transform_net.apply_with_features(params, x, method, compute_dtype=dtype)[0]
    want = want.clamp(0, 255).to(torch.uint8)
    stylizer = Stylizer(params=params, upsample_method=method, compute_dtype=dtype, packed_input=True,
                        packed_output=True, device="cpu")
    packed, spans = _fused_spans(lambda: stylizer.stylize_device(torch.as_tensor(pack_u8_host(frames)), (46, 50)))
    assert len(spans) == 16
    oh, ow = transform_net.output_shape(46, 50)
    assert np.array_equal(unpack_u8_host(packed.numpy(), oh, ow), want.numpy())
    with torch.inference_mode():
        u8, spans = _fused_spans(lambda: transform_net.apply(params, x, method, compute_dtype=dtype))
        assert len(spans) == 16 and torch.equal(u8, want)
        xf = x.float()
        f32, spans = _fused_spans(lambda: transform_net.apply(params, xf, method, compute_dtype=dtype))
    assert len(spans) == 16
    assert torch.equal(f32, transform_net.apply_with_features(params, xf, method, compute_dtype=dtype)[0])


def test_a_train_step_records_no_fused_norm(kernel_device_is_the_cpu):
    """Autograd records the train step's forward, so none of its norms
    takes the fused route even where the kernels' device is the CPU's; the
    same net serving under no_grad takes it 16 times."""
    step, state = profiling.recipe_step(16, device="cpu")
    batch = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0)) * 255
    _, spans = _fused_spans(lambda: step(state, batch))
    assert spans == []
    with torch.no_grad():
        _, spans = _fused_spans(lambda: state.net(batch))
    assert len(spans) == 16


def test_without_the_kernel_device_the_walk_stays_plain():
    """On the CPU, as shipped, serving takes the plain route: no span."""
    params = transform_net.init_params(torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        _, spans = _fused_spans(lambda: transform_net.apply(params, torch.zeros(1, 8, 8, 3, dtype=torch.uint8)))
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
    ([("stream.submit", 110, 120)], None),  # frames, no fused norm
    ([("norm.fused", 112, 113)], None),  # no frame
    ([(n, s + k, s + k + 0.5) for s in (110, 150) for k, n in enumerate(["stream.submit"] + ["norm.fused"] * 16)]
     + [("stream.submit", 90, 99), ("norm.fused", 91, 92), ("stream.submit", 200, 210), ("norm.fused", 201, 202)],
     16.0),  # the window's two frames; those before it and at its end left out
])
def test_fused_norms_per_frame_reader(monkeypatch, records, want):
    """`fused_norms_per_frame.stylize`: norm.fused spans over stream.submit
    spans starting in the traced window [100, 200) ms; None without either,
    and None without a trace."""
    from benchmark import program_spans

    monkeypatch.setattr(program_spans, "recorded", lambda: [_Span(*r) for r in records])
    trace = TraceData(100 * MS, 200 * MS, [], [("bench.window", 100 * MS, 200 * MS)])
    reader = Bench().reader("fused_norms_per_frame.stylize")
    assert reader.read(_run(trace)) == want
    assert reader.read(_run(None)) is None
