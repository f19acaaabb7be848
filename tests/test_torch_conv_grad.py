"""The port's deterministic convolution gradients (ops/conv_grad.py and the
plain version of ops/cuda/conv_wgrad.py) against the JAX package's vjp of
its conv2d and against torch's own convolution backward, on the CPU.

Tolerances: float32 dX and dW within 1e-5 of each gradient's largest
entry against jax.vjp (both sum the same products in float32, in other
orders, over at most 2 x 40 x 40 positions); bfloat16 within 2e-2 (the two
packages round the conv's bf16 products and sums at other places; dW is
rounded to bf16 in both before its cast back to float32). Against torch's
own backward in float64: 1e-10 (the same sums, other orders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from faststyle_tpu.ops import layers as JL  # noqa: E402
from faststyle_tpu_torch.ops import conv_grad  # noqa: E402
from faststyle_tpu_torch.ops import layers as TL  # noqa: E402
from faststyle_tpu_torch.ops.cuda import conv_wgrad  # noqa: E402

# (name, (h, w), (kh, kw), cin, cout, stride, padding, bias): every shape
# class of the transform net and VGG16, at small sizes
CLASSES = [
    ("9x9_same_s1", (20, 18), (9, 9), 3, 16, 1, "SAME", False),
    ("3x3_same_s2_even", (20, 18), (3, 3), 16, 32, 2, "SAME", False),
    ("3x3_same_s2_odd", (21, 19), (3, 3), 16, 32, 2, "SAME", False),
    ("3x3_valid", (12, 11), (3, 3), 8, 8, 1, "VALID", False),
    ("2x2_valid_phase", (13, 12), (2, 2), 8, 12, 1, "VALID", False),
    ("vgg_3x3_same_bias", (14, 13), (3, 3), 5, 7, 1, "SAME", True),
    ("9x9_same_s1_final", (24, 22), (9, 9), 16, 3, 1, "SAME", False),
]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, case, n=2):
    _, (h, w), (kh, kw), ci, co, stride, padding, bias = case
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    wt = (0.2 * rng.standard_normal((kh, kw, ci, co))).astype(np.float32)  # HWIO, as the JAX package holds it
    b = rng.standard_normal(co).astype(np.float32) if bias else None
    return x, wt, b


def _jax_vjp(x, wt, b, stride, padding, dtype, ct):
    def f(x, w, b):
        y = JL.conv2d(x.astype(dtype), w, stride=stride, padding=padding)
        return y if b is None else y + b.astype(dtype)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(wt), None if b is None else jnp.asarray(b))
    return (np.asarray(y, np.float32), *[None if g is None else np.asarray(g, np.float32) for g in vjp(ct)])


def _port(x, wt, b, stride, padding, dtype, ct):
    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()  # OIHW
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    y = TL.conv2d(xt.to(dtype), wtt, stride=stride, padding=padding, bias=bt)
    y.backward(torch.from_numpy(np.asarray(ct, np.float32)).to(dtype))
    gw = wtt.grad.permute(2, 3, 1, 0).numpy()  # back to HWIO
    return y.float().detach().numpy(), xt.grad.numpy(), gw, None if b is None else bt.grad.numpy()


def _close(got, want, tol, what):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CLASSES, ids=[c[0] for c in CLASSES])
def test_gradients_match_jax_vjp(rng, case, dtype):
    """dX, dW (and the bias's) of the port's conv2d, through Conv2dFunction,
    against jax.vjp of the JAX package's conv2d on the same numpy inputs."""
    _, _, _, _, _, stride, padding, _ = case
    x, wt, b = _inputs(rng, case)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    y_probe = np.asarray(JL.conv2d(jnp.asarray(x), jnp.asarray(wt), stride=stride, padding=padding))
    ct = rng.standard_normal(y_probe.shape).astype(np.float32)
    jy, jgx, jgw, jgb = _jax_vjp(x, wt, b, stride, padding, jdtype, jnp.asarray(ct, jdtype))
    ty, tgx, tgw, tgb = _port(x, wt, b, stride, padding, dtype, ct)
    tol = TOL[dtype]
    _close(ty, jy, tol, "forward")
    _close(tgx, jgx, tol, "dX")
    _close(tgw, jgw, tol, "dW")
    if b is not None:
        _close(tgb, jgb, tol, "db")


@pytest.mark.parametrize("case", CLASSES, ids=[c[0] for c in CLASSES])
def test_data_grad_as_forward_convs_equals_convolution_backward(rng, case):
    """input_grad (forward convs only) against aten.convolution_backward's
    input gradient, float64, for the same symmetric-pad conv the Function
    wraps (SAME's asymmetric pad is applied before it, as layers.conv2d does)."""
    _, (h, w), (kh, kw), ci, co, stride, padding, _ = case
    pad = (0, 0) if padding == "VALID" else ((kh - 1) // 2, (kw - 1) // 2)
    x = torch.from_numpy(rng.standard_normal((2, ci, h, w)))
    wt = torch.from_numpy(rng.standard_normal((co, ci, kh, kw)))
    y = torch.nn.functional.conv2d(x, wt, stride=stride, padding=pad)
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    want = torch.ops.aten.convolution_backward(dy, x, wt, None, [stride] * 2, list(pad), [1, 1], False, [0, 0], 1,
                                               [True, False, False])[0]
    got = conv_grad.input_grad(dy, wt, stride, pad, (h, w))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("stride,k,pad,hw", [(2, 3, (0, 0), (9, 8)), (3, 5, (2, 1), (11, 10)), (2, 1, (0, 0), (7, 6)),
                                             (2, 4, (1, 1), (10, 9))])
def test_data_grad_other_strides_and_kernels(rng, stride, k, pad, hw):
    """The phase decomposition at strides and kernels the nets do not use."""
    x = torch.from_numpy(rng.standard_normal((1, 3, *hw)))
    wt = torch.from_numpy(rng.standard_normal((4, 3, k, k)))
    y = torch.nn.functional.conv2d(x, wt, stride=stride, padding=pad)
    dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    want = torch.ops.aten.convolution_backward(dy, x, wt, None, [stride] * 2, list(pad), [1, 1], False, [0, 0], 1,
                                               [True, False, False])[0]
    torch.testing.assert_close(conv_grad.input_grad(dy, wt, stride, pad, hw), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", CLASSES, ids=[c[0] for c in CLASSES])
def test_plain_weight_grad_equals_conv2d_weight(rng, case):
    """The kernel's plain version (im2col product) against
    torch.nn.grad.conv2d_weight, float64 and float32."""
    _, (h, w), (kh, kw), ci, co, stride, padding, _ = case
    pad = (0, 0) if padding == "VALID" else ((kh - 1) // 2, (kw - 1) // 2)
    x = torch.from_numpy(rng.standard_normal((2, h, w, ci)))
    oh, ow = conv_wgrad.out_size(h, kh, stride, pad[0]), conv_wgrad.out_size(w, kw, stride, pad[1])
    dy = torch.from_numpy(rng.standard_normal((2, oh, ow, co)))
    want = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (co, ci, kh, kw), dy.permute(0, 3, 1, 2),
                                       stride=stride, padding=pad)
    got = conv_wgrad.conv_weight_grad(x, dy, (kh, kw), stride, pad)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    got32 = conv_wgrad.conv_weight_grad(x.float(), dy.float(), (kh, kw), stride, pad)
    assert got32.dtype == torch.float32
    torch.testing.assert_close(got32.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_launch_count_stays_zero_on_the_cpu(rng):
    before = conv_wgrad.launches
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 2)).astype(np.float32))
    conv_wgrad.conv_weight_grad(x, torch.ones(1, 6, 6, 3), (3, 3), 1, (1, 1))
    assert conv_wgrad.launches == before


@pytest.mark.parametrize(
    "xs,dys,k,s,p,err",
    [
        ((1, 6, 6, 2), (1, 5, 6, 3), (3, 3), 1, (1, 1), ValueError),  # dy's extent does not fit
        ((1, 6, 6, 2), (2, 6, 6, 3), (3, 3), 1, (1, 1), ValueError),  # batch
        ((6, 6, 2), (1, 6, 6, 3), (3, 3), 1, (1, 1), ValueError),  # not NHWC
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(xs, dys, k, s, p, err):
    with pytest.raises(err):
        conv_wgrad.conv_weight_grad(torch.zeros(xs), torch.zeros(dys), k, s, p)
    with pytest.raises(TypeError):
        conv_wgrad.conv_weight_grad(torch.zeros(1, 6, 6, 2), torch.zeros(1, 6, 6, 3, dtype=torch.bfloat16), (3, 3), 1,
                                    (1, 1))


# the six weight gradients of a b4@256 train step: (n, oh, ow, kh*kw*ci, co, X + dY bytes in float32)
TRAIN_WGRADS = {
    "init_0": (4, 336, 336, 243, 16, 4 * 336 * 336 * (3 + 16) * 4),
    "init_1": (4, 168, 168, 144, 32, 4 * (337 * 337 * 16 + 168 * 168 * 32) * 4),
    "init_2": (4, 84, 84, 288, 64, 4 * (169 * 169 * 32 + 84 * 84 * 64) * 4),
    "resblock": (4, 82, 82, 576, 64, 4 * (84 * 84 * 64 + 82 * 82 * 64) * 4),
    "up_0": (4, 64, 64, 256, 128, 4 * (65 * 65 * 64 + 64 * 64 * 128) * 4),
    "final": (4, 256, 256, 1296, 3, 4 * 256 * 256 * (16 + 3) * 4),
}


@pytest.mark.parametrize("name", list(TRAIN_WGRADS))
@pytest.mark.parametrize("sms", [132, 7])
def test_launch_plan_covers_every_row_within_the_byte_budget(name, sms):
    n, oh, ow, p, co, in_bytes = TRAIN_WGRADS[name]
    rows = n * oh * ow
    pl = conv_wgrad.plan(rows, p, co, in_bytes, sms)
    assert pl.chunk % conv_wgrad.KSTEP == 0
    assert pl.splits * pl.chunk >= rows > (pl.splits - 1) * pl.chunk  # every row, no empty split
    assert pl.splits == 1 or pl.splits * p * co * 4 <= in_bytes // 2
    assert pl.tile_c == next(t for t in conv_wgrad.TILE_C if min(co, 64) <= t)
    tiles = -(-p // conv_wgrad.TP) * -(-co // pl.tile_c)
    assert pl.blocks == tiles * pl.splits
    if sms == 132:
        assert pl.blocks >= sms  # enough blocks to fill the card
    assert pl.launches == (1 if pl.splits == 1 else 2)


def test_conv2d_takes_the_function_only_when_a_gradient_can_flow(rng):
    """No grad mode or no operand needing a gradient: F.conv2d itself (no
    Conv2dFunction node in the graph)."""
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    assert TL.conv2d(x, w).grad_fn is None
    wg = w.clone().requires_grad_()
    with torch.no_grad():
        assert TL.conv2d(x, wg).grad_fn is None
    y = TL.conv2d(x, wg)

    def names(fn, seen=()):
        out = [type(fn).__name__]
        for nxt, _ in fn.next_functions:
            if nxt is not None:
                out += names(nxt)
        return out

    assert any("Conv2dFunction" in n for n in names(y.grad_fn))


def test_bf16_weight_grad_is_rounded_to_bf16(rng):
    """In bf16 the weight is cast before the Function, so dW reaches the
    float32 parameter as a bf16 value, as the JAX vjp gives it."""
    x = torch.from_numpy(rng.standard_normal((2, 10, 10, 4)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((5, 4, 3, 3)).astype(np.float32)).requires_grad_()
    TL.conv2d(x, w).float().sum().backward()
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(w.grad, w.grad.to(torch.bfloat16).float(), rtol=0, atol=0)


def test_weight_gradient_route_by_shape():
    """The fixed rule: of a b4@256 step's 16 weight gradients, float32 sends
    all but the ten resblock convs to the kernel, bfloat16 none of them
    (the rest to cuDNN's deterministic algorithm)."""
    # (co, ci, kh, kw), stride of the transform net's convs, as the Function gets them
    convs = ([((16, 3, 9, 9), 1), ((32, 16, 3, 3), 2), ((64, 32, 3, 3), 2)] + [((64, 64, 3, 3), 1)] * 10
             + [((128, 64, 2, 2), 1), ((64, 32, 2, 2), 1), ((3, 16, 9, 9), 1)])
    route = {dt: [conv_grad.wgrad_by_kernel(w, s, dt) for w, s in convs] for dt in (torch.float32, torch.bfloat16)}
    assert route[torch.float32] == [True] * 3 + [False] * 10 + [True] * 3
    assert route[torch.bfloat16] == [False] * 16
