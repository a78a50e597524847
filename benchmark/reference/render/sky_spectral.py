"""Hosek–Wilkie spectral sky, numpy part (copy of the numpy code of
rtvb_tpu/render/sky_spectral.py, which imports jax.numpy at module level):
the exact 10-channel model, the solar-disk RGB polynomial and the per-sun
least-squares fit of the 12-function RGB basis.  Runs on the host at
sun-change time only; the per-pixel basis evaluation is in render/sky.py.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                     "data", "assets", "skydata.npz")

# Engine-units calibration: chosen so the spectral model's zenith radiance at
# the canonical sun elevation sits where the Preetham path put it (goldens
# shift by a re-bless, not by an exposure regime change).
SPECTRAL_SCALE = 0.12

N_BASIS = 12


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    z = np.load(_DATA)
    return {k: np.asarray(z[k]) for k in z.files}


# ---------------------------------------------------------------------------
# Exact model (numpy, sun-change time)
# ---------------------------------------------------------------------------

def config_at(sun_y: float):
    """Per-channel sky configuration (10, 9) + radiance scale (10,) at the
    given sun elevation — the quintic-bezier elevation interpolation
    (Sky.cu:20-48 getFittingData/getFittingData2)."""
    t = tables()
    elev = max(float(np.arcsin(np.clip(sun_y, 0.0, 1.0))), 0.0)
    s = (elev / (np.pi / 2.0)) ** (1.0 / 3.0)
    w = np.array([(1 - s) ** 5, 5 * (1 - s) ** 4 * s, 10 * (1 - s) ** 3 * s ** 2,
                  10 * (1 - s) ** 2 * s ** 3, 5 * (1 - s) * s ** 4, s ** 5],
                 np.float64)
    cfg = np.einsum("k,ckp->cp", w, t["sky_config"].astype(np.float64))
    rad = t["sky_rad"].astype(np.float64) @ w
    return cfg, rad


def _spectral_to_rgb(spec):
    """(..., 10) channel radiances → (..., 3) linear sRGB (Sky.cu:87-172)."""
    t = tables()
    xyz = spec @ t["cie_xyz"].T / float(t["cie_y_integral"])
    return xyz @ t["xyz_to_rgb"].T


def sky_radiance_exact(dirs: np.ndarray, sun_dir) -> np.ndarray:
    """(N, 3) unit dirs → (N, 3) RGB sky radiance, exact 10-channel model
    (Sky.cu:133-172 GetSkyRadiance).  Model units (no engine scale)."""
    sun = np.asarray(sun_dir, np.float64)
    cfg, rad = config_at(sun[1])
    d = np.asarray(dirs, np.float64)
    cos_t = np.clip(d[:, 1], 0.0, 1.0)[:, None]
    cos_g = np.clip(d @ sun, -1.0, 1.0)[:, None]
    gamma = np.arccos(cos_g)
    c = cfg[None, :, :]                    # (1, 10, 9)
    expm = np.exp(c[..., 4] * gamma)
    raym = cos_g * cos_g
    miem = (1.0 + raym) / (1.0 + c[..., 8] ** 2
                           - 2.0 * c[..., 8] * cos_g) ** 1.5
    zen = np.sqrt(cos_t)
    ri = ((1.0 + c[..., 0] * np.exp(c[..., 1] / (cos_t + 0.01)))
          * (c[..., 2] + c[..., 3] * expm + c[..., 5] * raym
             + c[..., 6] * miem + c[..., 7] * zen))
    return np.maximum(_spectral_to_rgb(ri * rad[None, :]), 0.0)


def sun_direct_channels(sun_y: float) -> np.ndarray:
    """(10,) solar-disk direct radiance per channel at the sun's elevation —
    the 45-piece cubic piecewise polynomial (Sky.cu:208-230)."""
    t = tables()
    solar = t["solar"].astype(np.float64).reshape(10, 45, 4)
    elev = max(float(np.arcsin(np.clip(sun_y, 0.0, 1.0))), 0.0)
    pos = min(int((2.0 * elev / np.pi) ** (1.0 / 3.0) * 45.0), 44)
    break_x = (pos / 45.0) ** 3 * (np.pi * 0.5)
    x = elev - break_x
    # coefficient of x^i sits at flat index 4*pos + 3 - i (decrementing read)
    return sum(x ** i * solar[:, pos, 3 - i] for i in range(4))


def sun_rgb_poly(sun_y: float, sun_diameter_deg: float = 0.51) -> np.ndarray:
    """(6, 3) RGB polynomial coefficients P with sunRGB(s) = Σ_i P[i]·s^i,
    s = limb sample cosine — the EXACT projection of GetSunRadiance
    (Sky.cu:176-256): darkening is polynomial in s, so spectral→RGB commutes
    with the polynomial.  Model units."""
    t = tables()
    direct = sun_direct_channels(sun_y)          # (10,)
    scale = 1.0 / ((sun_diameter_deg / 0.51) ** 2)
    per_deg = t["limb"].astype(np.float64) * direct[:, None] * scale  # (10, 6)
    return np.maximum(_spectral_to_rgb(per_deg.T), 0.0)              # (6, 3)


# ---------------------------------------------------------------------------
# RGB basis projection (fit in numpy at sun-change time; eval in torch per pixel)
# ---------------------------------------------------------------------------

def _features(cos_t, cos_g, gamma, B, E1, E2, Hm, xp=np, rcp=None, rsqrt=None,
              sqrt=None):
    """The 12 shared basis functions of (cosθ, γ).  xp switches numpy (fit)
    and torch (per-pixel eval) — one definition for both; rcp / rsqrt /
    sqrt let a caller pin how those round."""
    if rcp is None:
        rcp = lambda x: 1.0 / x
    if sqrt is None:
        sqrt = xp.sqrt
    if rsqrt is None:
        rsqrt = lambda x: rcp(sqrt(x))
    eu = xp.exp(B * rcp(cos_t + 0.01))
    e1 = xp.exp(E1 * gamma)
    e2 = xp.exp(E2 * gamma)
    g2 = cos_g * cos_g
    md = 1.0 + Hm * Hm - 2.0 * Hm * cos_g
    mie = (1.0 + g2) * rcp(md) * rsqrt(md)     # (1+cos²γ) · md^{-3/2}
    z = sqrt(cos_t)
    return [xp.ones_like(cos_t), eu, g2, z, e1, e2, mie,
            eu * g2, eu * z, eu * e1, eu * e2, eu * mie]


def fit_basis(sun_dir, n_dirs: int = 4096):
    """Least-squares RGB projection of the exact spectral sky onto the
    12-function basis for this sun position.  Returns (params (4,) f32
    [B̄, Ē₁, Ē₂, H̄], M (12, 3) f32) in model units."""
    sun = np.asarray(sun_dir, np.float64)
    cfg, rad = config_at(sun[1])
    t = tables()
    # luminance-weighted representative nonlinear constants
    w = t["cie_xyz"][1].astype(np.float64) * np.maximum(rad, 1e-12)
    w = w / w.sum()
    B = float(np.sum(w * cfg[:, 1]))
    e_sorted = np.sort(cfg[:, 4])
    E1 = float(e_sorted[2])                     # spread of the solar-peak widths
    E2 = float(e_sorted[-2])
    Hm = float(np.clip(np.sum(w * cfg[:, 8]), 0.0, 0.995))

    # Fibonacci hemisphere fit grid, plus a band hugging the horizon (the
    # gradient term blows up there — where fits go to die)
    i = np.arange(n_dirs, dtype=np.float64) + 0.5
    cos_t = 1.0 - i / n_dirs                    # stratified in cosθ: equal-area
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t ** 2))
    dirs = np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], -1)
    target = sky_radiance_exact(dirs, sun)      # (N, 3)

    cos_g = np.clip(dirs @ sun, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    F = np.stack(_features(np.clip(dirs[:, 1], 0.0, 1.0), cos_g, gamma,
                           B, E1, E2, Hm, xp=np), -1)   # (N, 12)
    # relative-error weighting: bright aureole must not drown the dome
    wgt = 1.0 / np.maximum(np.linalg.norm(target, axis=-1, keepdims=True), 1e-3)
    M, *_ = np.linalg.lstsq(F * wgt, target * wgt, rcond=None)
    return (np.array([B, E1, E2, Hm], np.float32), M.astype(np.float32))
