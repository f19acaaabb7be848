"""The port's Gram op on the CPU against the JAX package's: the Pallas
kernel in interpret mode and losses.gram_matrix, forward and backward.

Tolerance rtol 1e-4 / atol 1e-5, as tests/test_pallas.py holds the Pallas
kernel to its oracle: float32 sums over hw rows in another order. The
CUDA kernel itself runs only on the card (chip_smoke.py holds it against
gram_matrix_plain there); here its host-side launch plan is checked, and a
CPU model of its 3xTF32 arithmetic is held to a float64 Gram."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from faststyle_tpu import losses as jlosses  # noqa: E402
from faststyle_tpu.ops.pallas.gram import gram_matrix_pallas  # noqa: E402
from faststyle_tpu_torch import losses as tlosses  # noqa: E402
from faststyle_tpu_torch.ops.cuda import gram  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 16, 16, 32), (3, 17, 9, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_lax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    got = gram.gram_matrix_plain(torch.from_numpy(x)).numpy()
    pallas = np.asarray(gram_matrix_pallas(jnp.asarray(x), row_tile=64, interpret=True))
    lax = np.asarray(jlosses.gram_matrix(jnp.asarray(x)))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, lax, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_forward_backward_matches_pallas_vjp(rng, shape):
    """GramFunction on a CPU tensor (the plain forward, the matmul
    backward) against the Pallas kernel's custom VJP, for one cotangent."""
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal((shape[0], shape[3], shape[3])).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    g = tlosses.gram_matrix(xt)
    (g * torch.from_numpy(ct)).sum().backward()

    def f(v):
        return jnp.sum(gram_matrix_pallas(v, row_tile=64, interpret=True) * ct)

    ref_g = gram_matrix_pallas(jnp.asarray(x), row_tile=64, interpret=True)
    ref_dx = jax.grad(f)(jnp.asarray(x))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=1e-5)
    assert gram.GramFunction.launches == 0  # the CPU path launches no kernel


def test_function_bf16_matches_f32_of_same_values(rng):
    """bf16 input: products of bf16 values are exact in f32, so the result
    equals the f32 Gram of the same (rounded) values."""
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32)).bfloat16()
    got = gram.gram_matrix(x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), gram.gram_matrix_plain(x.float()).numpy(), rtol=1e-6, atol=1e-7
    )


@pytest.mark.parametrize(
    "bad,err",
    [
        (lambda: torch.zeros(2, 4, 4, 3, dtype=torch.float16), TypeError),
        (lambda: torch.zeros(4, 4, 3), ValueError),
        (lambda: torch.zeros(2, 3, 4, 4).permute(0, 2, 3, 1), ValueError),
        (lambda: torch.zeros(0, 4, 4, 3), ValueError),
        (lambda: torch.zeros(1, 2, 2, 3, device="meta"), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        gram.gram_matrix(bad())


TRAIN_SHAPES = [(4, 256, 256, 64), (4, 128, 128, 128), (4, 64, 64, 256), (4, 32, 32, 512)]
RAGGED_SHAPES = [(1, 256, 256, 64), (3, 17, 9, 64), (2, 33, 31, 48), (1, 1, 1, 1), (2, 9, 11, 20)]
SMS = 132  # an H100's SM count


def _bytes(dtype):
    return torch.finfo(dtype).bits // 8


@pytest.mark.parametrize("b,h,w,c", TRAIN_SHAPES + RAGGED_SHAPES[:4])
def test_launch_plan_covers_every_row(b, h, w, c):
    """The split plan the wrapper hands the kernel: chunks are whole
    shared-memory stages, cover hw exactly once and leave no split empty;
    one 128-wide tile for 64 < c <= 128; at most one wave of the card's
    block slots, and more than one split wherever splitting is allowed and
    the tiles alone leave slots empty."""
    hw = h * w
    p = gram.plan(b, hw, c, torch.float32, num_sms=SMS)
    assert p.chunk % gram.KSTEP == 0
    assert p.splits * p.chunk >= hw > (p.splits - 1) * p.chunk
    assert p.tile == (128 if 64 < c <= 128 else 64)
    nt = -(-c // p.tile)
    tiles = b * nt * (nt + 1) // 2
    assert p.blocks == tiles * p.splits
    slots = SMS * gram.RESIDENT[p.tile]
    assert p.blocks <= slots or p.splits == 1
    cap = (b * hw * c * 4 // 2) // (b * c * c * 4)
    if tiles < slots and cap >= 2 and hw > gram.KSTEP:
        assert p.splits > 1
    assert p.launches == (1 if p.splits == 1 else 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c", TRAIN_SHAPES + RAGGED_SHAPES)
def test_plan_scratch_within_half_the_input(b, h, w, c, dtype):
    """The split scratch (splits x b x c^2 float32, none for one split)
    never outweighs half the input's bytes."""
    p = gram.plan(b, h * w, c, dtype, num_sms=SMS)
    scratch = p.splits * b * c * c * 4 if p.splits > 1 else 0
    assert 2 * scratch <= b * h * w * c * _bytes(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_is_one_launch_at_conv4_3(dtype):
    """conv4_3 at b4@256: a second split would bring the scratch to 8.4 MB,
    over half the input (8.4 MB in float32, half that in bf16), and 36
    tiles x 4 images already fill the card, so the tile kernel writes G
    itself in one launch."""
    p = gram.plan(4, 32 * 32, 512, dtype, num_sms=SMS)
    assert (p.splits, p.tile, p.blocks, p.launches) == (1, 64, 144, 1)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as the kernel does (and cvt.rna.tf32.f32): add
    half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _gram_3xtf32(f: torch.Tensor, diagonal: bool) -> torch.Tensor:
    """The kernel's float32 arithmetic on the CPU: f = hi + lo in TF32,
    products of TF32 values exact in float32 matmuls. An off-diagonal tile
    sums lo*hi + hi*lo + hi*hi; a diagonal one P + Q + Q^T, P = hi*hi and
    Q = hi*lo, which are the same three products."""
    hi = _tf32_rna(f)
    lo = _tf32_rna(f - hi)
    t = lambda a, b: torch.matmul(a.transpose(1, 2), b)  # noqa: E731
    if diagonal:
        q = t(hi, lo)
        return t(hi, hi) + q + q.transpose(1, 2)
    return t(lo, hi) + t(hi, lo) + t(hi, hi)


@pytest.mark.parametrize("diagonal", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("rows", [300, 32])
def test_3xtf32_arithmetic_meets_the_forward_tolerance(rng, rows, c, relu, diagonal):
    """3xTF32, modelled on the CPU, comes within 1e-4 of the largest entry
    of a float64 Gram (chip_smoke.py's forward tolerance), and far closer
    than 1xTF32 (hi*hi alone): the reason the kernel pays three passes.
    Over 32 rows 1xTF32 breaks that tolerance, so it tells the two apart;
    over many rows the rounding errors average out, which is why
    chip_smoke.py holds the kernel to a float64 Gram against 1xTF32's
    error on the same input instead."""
    x = rng.standard_normal((1, rows, c))
    if relu:
        x = np.maximum(x, 0.0)  # VGG features come out of a ReLU
    f = torch.from_numpy(x.astype(np.float32))
    hi = _tf32_rna(f)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float(((f - hi).abs() / f.abs().clamp_min(1e-30)).max()) <= 2.0**-11
    ref = torch.matmul(f.double().transpose(1, 2), f.double())
    scale = float(ref.abs().max())
    err3 = float((_gram_3xtf32(f, diagonal).double() - ref).abs().max())
    err1 = float((torch.matmul(hi.transpose(1, 2), hi).double() - ref).abs().max())
    assert err3 <= 1e-4 * scale
    assert err3 * 100 <= err1
    if rows == 32:
        assert err1 > 1e-4 * scale


def test_import_needs_no_nvcc_or_cuda(tmp_path):
    """Importing the port (and computing on the CPU) builds nothing: no
    compiler on PATH, no CUDA, no call of `build.build` (the host library
    builds only when a pack or unpack runs), and no Gram library appears."""
    code = (
        "import torch\n"
        "from faststyle_tpu_torch.ops.cuda import build\n"
        "def refuse(name): raise AssertionError(f'built {name} at import')\n"
        "build.build = refuse\n"
        "from faststyle_tpu_torch import inference, losses\n"
        "from faststyle_tpu_torch.ops.cuda import gram\n"
        "x = torch.ones(1, 4, 4, 8)\n"
        "assert losses.gram_matrix(x).shape == (1, 8, 8)\n"
        "print(build.BUILD_DIR)\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path / "none"),
               CUDA_VISIBLE_DEVICES="")
    before = set((ROOT / "build").glob("faststyle_tpu_torch/gram-*.so"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set((ROOT / "build").glob("faststyle_tpu_torch/gram-*.so")) == before
