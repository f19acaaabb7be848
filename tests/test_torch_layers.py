"""The port's layer primitives against faststyle_tpu.ops.layers on the same
numpy inputs (float32 on the CPU).

Tolerance: rtol 1e-5 / atol 1e-4 on outputs of order 1-100 — both packages
compute in float32, the convolutions sum in another order (XLA vs oneDNN),
and nothing else differs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from faststyle_tpu.ops import layers as JL  # noqa: E402
from faststyle_tpu_torch import convert  # noqa: E402
from faststyle_tpu_torch.ops import layers as TL  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("hw,pad", [((16, 16), 40), ((10, 13), 4), ((1, 5), 3)])
def test_reflect_pad(rng, hw, pad):
    """Pads >= the extent reflect repeatedly, as jnp.pad does (torch's own
    'reflect' mode refuses them)."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    _close(TL.reflect_pad(_t(x), pad), JL.reflect_pad(jnp.asarray(x), pad), atol=0, rtol=0)


def test_resize_nearest(rng):
    x = rng.standard_normal((1, 5, 7, 4)).astype(np.float32)
    _close(TL.resize_nearest(_t(x), 4), JL.resize_nearest(jnp.asarray(x), 4), atol=0, rtol=0)


@pytest.mark.parametrize(
    "size,k,stride,padding",
    [
        (16, 3, 2, "SAME"),  # even extent: TF pads (0, 1)
        (15, 3, 2, "SAME"),  # odd extent: (1, 1)
        (12, 9, 1, "SAME"),
        (11, 3, 1, "VALID"),
    ],
)
def test_conv2d(rng, size, k, stride, padding):
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    got = TL.conv2d(_t(x), convert.kernel_to_torch(w), stride=stride, padding=padding)
    ref = JL.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding)
    _close(got, ref)


def test_conv2d_bias(rng):
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    got = TL.conv2d(_t(x), convert.kernel_to_torch(w), bias=_t(b))
    _close(got, JL.conv2d(jnp.asarray(x), jnp.asarray(w)) + b)


@pytest.mark.parametrize("stride,k,size", [(2, 3, 6), (2, 3, 7), (1, 9, 8)])
def test_transposed_conv2d(rng, stride, k, size):
    x = rng.standard_normal((2, size, size + 2, 4)).astype(np.float32)
    w_hwoi = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    got = TL.transposed_conv2d(_t(x), convert.kernel_to_torch(w_hwoi), stride)
    _close(got, JL.transposed_conv2d(jnp.asarray(x), jnp.asarray(w_hwoi), stride))


@pytest.mark.parametrize("stride,k,size", [(2, 3, 6), (2, 3, 7), (1, 9, 8)])
def test_deconv_as_forward_conv(rng, stride, k, size):
    """The deconv net's forward-conv forms (phase decomposition at stride 2,
    the adjoint kernel at stride 1) against the JAX transposed conv."""
    x = rng.standard_normal((2, size, size + 2, 4)).astype(np.float32)
    w_hwoi = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    fn = TL.deconv_upsample if stride == 2 else TL.deconv_same_s1
    got = fn(_t(x), convert.kernel_to_torch(w_hwoi))
    _close(got, JL.transposed_conv2d(jnp.asarray(x), jnp.asarray(w_hwoi), stride))


def test_upsample_phase_kernel(rng):
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    got = TL.upsample_phase_kernel(convert.kernel_to_torch(w))
    ref = JL.upsample_phase_kernel(jnp.asarray(w))
    np.testing.assert_allclose(convert.kernel_to_file(got), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_deconv_phase_kernel(rng):
    w_hwoi = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    got = TL.deconv_phase_kernel(convert.kernel_to_torch(w_hwoi))
    ref = JL.deconv_phase_kernel(jnp.asarray(w_hwoi))
    np.testing.assert_allclose(convert.kernel_to_file(got), np.asarray(ref), rtol=0, atol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_upsample_conv(rng, fused):
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 3)).astype(np.float32)
    fn = TL.upsample_conv if fused else TL.upsample_conv_reference
    ref = JL.upsample_conv_reference(jnp.asarray(x), jnp.asarray(w))
    _close(fn(_t(x), convert.kernel_to_torch(w)), ref)


def test_instance_norm(rng):
    """eps 1e-3 inside the rsqrt, biased variance: a near-constant channel
    makes the eps visible (torch's default 1e-5 would be far off)."""
    x = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    x[..., 0] = 3.0 + 1e-3 * x[..., 0]
    scale = rng.standard_normal(4).astype(np.float32)
    shift = rng.standard_normal(4).astype(np.float32)
    got = TL.instance_norm(_t(x), _t(scale), _t(shift))
    ref = JL.instance_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    _close(got, ref)


def test_instance_norm_bf16_keeps_dtype(rng):
    x = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
    got = TL.instance_norm(_t(x).bfloat16(), torch.ones(2), torch.zeros(2))
    assert got.dtype == torch.bfloat16


def test_scaled_tanh(rng):
    x = 3 * rng.standard_normal((1, 4, 5, 3)).astype(np.float32)
    _close(TL.scaled_tanh(_t(x)), JL.scaled_tanh(jnp.asarray(x)))


def test_relu_zero_subgradient():
    """The gradient at exactly 0 is 0, as in the JAX package's custom VJP."""
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    TL.relu(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 4)])
def test_max_pool_2x2_same(rng, hw):
    """Odd extents: TF SAME pads the high side with -inf."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    _close(TL.max_pool_2x2_same(_t(x)), JL.max_pool_2x2_same(jnp.asarray(x)), rtol=0, atol=0)
