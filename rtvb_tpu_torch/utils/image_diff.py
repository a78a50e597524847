"""Golden-image comparison: pixel diff, RMSE, PSNR, SSIM, verdicts (port
of rtvb_tpu/utils/image_diff.py, the same bars).

Pixel-diff count at threshold 0.01, RMSE and PSNR on the 8-bit scale,
grayscale SSIM with a 3×3 Gaussian window (the standard K1 / K2), the
verdicts identical / veryClose / close / different, and a 3× amplified
diff image.  Host numpy; a tensor argument is copied to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .image import host

PIXEL_DIFF_THRESHOLD = 0.01
VERY_CLOSE = ("veryClose", 0.99, 1.0)   # SSIM > 0.99 and RMSE < 1.0 (8-bit scale)
CLOSE = ("close", 0.95, 5.0)


@dataclass
class DiffResult:
    diff_pixel_count: int
    diff_pixel_fraction: float
    rmse: float          # on the 0..255 scale
    psnr: float          # dB, 8-bit scale
    ssim: float
    verdict: str

    def __str__(self):
        return (f"diff_pixels={self.diff_pixel_count} ({self.diff_pixel_fraction:.4%}) "
                f"rmse={self.rmse:.4f} psnr={self.psnr:.2f}dB ssim={self.ssim:.5f} "
                f"→ {self.verdict}")


def _gaussian_blur3(img: np.ndarray) -> np.ndarray:
    k = np.array([0.25, 0.5, 0.25])
    out = np.apply_along_axis(lambda r: np.convolve(np.pad(r, 1, mode="edge"), k, "valid"), 0, img)
    out = np.apply_along_axis(lambda r: np.convolve(np.pad(r, 1, mode="edge"), k, "valid"), 1, out)
    return out


def ssim_gray(a: np.ndarray, b: np.ndarray) -> float:
    """Grayscale SSIM with a 3×3 Gaussian window."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    K1, K2, L = 0.01, 0.03, 255.0
    C1, C2 = (K1 * L) ** 2, (K2 * L) ** 2
    mu_a = _gaussian_blur3(a)
    mu_b = _gaussian_blur3(b)
    var_a = _gaussian_blur3(a * a) - mu_a * mu_a
    var_b = _gaussian_blur3(b * b) - mu_b * mu_b
    cov = _gaussian_blur3(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + C1) * (2 * cov + C2)) / (
        (mu_a**2 + mu_b**2 + C1) * (var_a + var_b + C2))
    return float(s.mean())


def compare(img, golden) -> DiffResult:
    """Both (H, W, 3) uint8 (or float in [0, 1], converted)."""
    def as_u8f(x):
        x = host(x)
        if x.dtype != np.uint8:
            x = (np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        return x.astype(np.float64)

    a = as_u8f(img)
    b = as_u8f(golden)
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}"

    per_px = np.abs(a - b).max(axis=-1) / 255.0
    diff_count = int((per_px > PIXEL_DIFF_THRESHOLD).sum())
    mse = float(((a - b) ** 2).mean())
    rmse = float(np.sqrt(mse))
    psnr = float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")
    gray_a = a.mean(axis=-1)
    gray_b = b.mean(axis=-1)
    s = ssim_gray(gray_a, gray_b)

    if diff_count == 0:
        verdict = "identical"
    elif s > VERY_CLOSE[1] and rmse < VERY_CLOSE[2]:
        verdict = "veryClose"
    elif s > CLOSE[1] and rmse < CLOSE[2]:
        verdict = "close"
    else:
        verdict = "different"
    return DiffResult(diff_count, diff_count / per_px.size, rmse, psnr, s, verdict)


def amplified_diff(img, golden, gain: float = 3.0) -> np.ndarray:
    """3×-amplified absolute difference image."""
    a = np.asarray(host(img), np.float32)
    b = np.asarray(host(golden), np.float32)
    if a.dtype == np.uint8:
        a = a / 255.0
    if b.dtype == np.uint8:
        b = b / 255.0
    return np.clip(np.abs(a - b) * gain, 0, 1)
