"""Image quality metrics, SSIM and PSNR (the port's own copy of
faststyle_tpu/utils/metrics.py), for the parity checks against the TF
oracles.

SSIM follows Wang et al. 2004 with the standard settings (11x11 Gaussian,
sigma 1.5, K1=0.01, K2=0.03), computed per channel and averaged.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM between two HWC (or HW) images."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def f(x):
        return gaussian_filter(x, sigma=1.5, axes=(0, 1), truncate=3.5)

    mu_a, mu_b = f(a), f(b)
    var_a = f(a * a) - mu_a * mu_a
    var_b = f(b * b) - mu_b * mu_b
    cov = f(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
