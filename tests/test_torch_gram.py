"""The port's Gram op on the CPU against the JAX package's: the Pallas
kernel in interpret mode and losses.gram_matrix, forward and backward.

Tolerance rtol 1e-4 / atol 1e-5, as tests/test_pallas.py holds the Pallas
kernel to its oracle: float32 sums over hw rows in another order. The
CUDA kernel itself runs only on the card (chip_smoke.py holds it against
gram_matrix_plain there); here its host-side launch plan is checked."""

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


@pytest.mark.parametrize(
    "b,h,w,c",
    [(4, 256, 256, 64), (4, 128, 128, 128), (4, 64, 64, 256), (4, 32, 32, 512),
     (1, 256, 256, 64), (3, 17, 9, 64), (2, 33, 31, 48), (1, 1, 1, 1)],
)
def test_launch_plan_covers_every_row(b, h, w, c):
    """The split plan the wrapper hands the kernel: chunks are whole
    shared-memory stages, cover hw exactly once, and leave no split empty."""
    hw = h * w
    splits, chunk = gram.plan(b, hw, c, num_sms=132)
    assert chunk % gram.KSTEP == 0
    assert splits * chunk >= hw > (splits - 1) * chunk
    nt = -(-c // gram.TILE)
    blocks = b * splits * nt * (nt + 1) // 2
    assert blocks >= min(132, b * nt * (nt + 1) // 2 * -(-hw // gram.KSTEP))


def test_import_needs_no_nvcc_or_cuda(tmp_path):
    """Importing the port (and computing on the CPU) builds nothing: no
    compiler on PATH, no CUDA, and no build directory appears."""
    code = (
        "import torch\n"
        "from faststyle_tpu_torch import losses\n"
        "from faststyle_tpu_torch.ops.cuda import build, gram\n"
        "x = torch.ones(1, 4, 4, 8)\n"
        "assert losses.gram_matrix(x).shape == (1, 8, 8)\n"
        "print(build.BUILD_DIR)\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path / "none"),
               CUDA_VISIBLE_DEVICES="")
    before = set((ROOT / "build").glob("faststyle_tpu_torch/*.so"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set((ROOT / "build").glob("faststyle_tpu_torch/*.so")) == before
