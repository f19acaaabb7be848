"""Operands rounded to a lower precision, for the control."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() * scale


class _Round(torch.autograd.Function):
    """Rounds in the forward; passes the gradient through unchanged."""

    @staticmethod
    def forward(ctx, x, precision):
        if precision == "tf32":
            return _tf32(x)
        if precision == "bfloat16":
            return x.to(torch.bfloat16).float()
        if precision == "float8":
            return _fp8(x)
        raise ValueError(f"unknown precision {precision!r}")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x if precision == "float32" else _Round.apply(x, precision)
