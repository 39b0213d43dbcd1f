"""Video/image quality metrics for parity validation.

The port's own copy of ``moviigen_tpu/utils/metrics.py`` (host numpy and
scipy, no torch needed).

SURVEY §7.3: seed-for-seed RNG equality with the torch reference is
impossible (different PRNG streams); the fidelity contract is instead
(a) bit-near latent equality given identical injected noise, and
(b) PSNR/SSIM of decoded video. These metrics implement (b); the
pipelines accept explicit ``noise`` arrays for (a).
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB (default range [-1, 1] video)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Structural similarity (standard 11×11 Gaussian window, per-frame
    per-channel, averaged). a/b: [..., H, W]."""
    from scipy.signal import convolve2d

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim > 2:
        flat_a = a.reshape(-1, *a.shape[-2:])
        flat_b = b.reshape(-1, *b.shape[-2:])
        return float(np.mean([ssim(x, y, data_range)
                              for x, y in zip(flat_a, flat_b)]))

    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    mu_a = convolve2d(a, k, mode="valid")
    mu_b = convolve2d(b, k, mode="valid")
    mu_a2, mu_b2, mu_ab = mu_a ** 2, mu_b ** 2, mu_a * mu_b
    sa = convolve2d(a * a, k, mode="valid") - mu_a2
    sb = convolve2d(b * b, k, mode="valid") - mu_b2
    sab = convolve2d(a * b, k, mode="valid") - mu_ab

    num = (2 * mu_ab + c1) * (2 * sab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sa + sb + c2)
    return float(np.mean(num / den))


def latent_parity_report(ours: np.ndarray, theirs: np.ndarray) -> dict:
    """Summary stats for latent-level comparison given identical noise."""
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    diff = np.abs(ours - theirs)
    denom = np.maximum(np.abs(theirs), 1e-6)
    return {
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "max_rel_diff": float((diff / denom).max()),
        "psnr_db": psnr(ours, theirs,
                        data_range=float(theirs.max() - theirs.min())),
    }
