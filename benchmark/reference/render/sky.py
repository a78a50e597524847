"""Analytic daylight sky + sun (port of rtvb_tpu/render/sky.py).

The exact spectral model runs in numpy at sun-change time
(render/sky_spectral.py); per-pixel paths evaluate the fitted 12-function
RGB basis and the exact degree-5 sun-disk polynomial.  The per-frame
scalars are kept both as tensors (interop, state) and as host floats
(`SkyState.host`) so the per-pixel formulas broadcast plain numbers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import SkySettings

from ..ops import alias_table as at
from ..ops import mathutil as m
from . import sky_spectral as ss

SKY_RADIANCE_SCALE = 0.035
SPECTRAL_SCALE = 3.0
SUN_RADIANCE_SCALE = 1.2e5
ENV_W, ENV_H = 8, 4
N_BASIS = ss.N_BASIS
_ENV_OMEGA = 2.0 * math.pi / (ENV_W * ENV_H)


class SkyState(NamedTuple):
    sun_dir: tuple               # 3 × 0-d f32 tensors
    turbidity: torch.Tensor
    sky_intensity: torch.Tensor
    sun_intensity: torch.Tensor
    cos_sun_radius: torch.Tensor
    env_prob: torch.Tensor       # (ENV_W*ENV_H,)
    env_alias: torch.Tensor      # (ENV_W*ENV_H,) i32
    env_pmf: torch.Tensor
    basis_p: torch.Tensor        # (4,)
    basis_m: torch.Tensor        # (N_BASIS, 3)
    sun_poly: torch.Tensor       # (6, 3)
    host: dict                   # the same scalars as Python floats


def host_scalars(sun_dir, cos_sun_radius, basis_p, basis_m, sun_poly) -> dict:
    """Python-float copies of the per-pixel constants (exact f32 values)."""
    f = lambda a: np.asarray(a, np.float32).astype(np.float64).tolist()
    return dict(sun=[float(v) for v in f(sun_dir)],
                cos_r=float(f(cos_sun_radius)),
                basis_p=f(basis_p), basis_m=f(basis_m), sun_poly=f(sun_poly))


def sun_direction(time_of_day: float, axis_angle_deg: float):
    """Sun path east → zenith → west tilted about x (float32)."""
    t = torch.tensor(time_of_day, dtype=torch.float32)
    h = (t / 24.0) * 2.0 * math.pi
    c = torch.cos(h - math.pi * 0.5)
    s = torch.sin(h - math.pi * 0.5)
    a = torch.deg2rad(torch.tensor(axis_angle_deg, dtype=torch.float32))
    return m.normalize((c, s * torch.cos(a), s * torch.sin(a)))


def _preetham_rgb_np(dirs: np.ndarray, sun: np.ndarray, T: float
                     ) -> np.ndarray:
    """Preetham et al. 1999 analytic sky in numpy (the fit target of
    SkySettings.model "preetham"): zenith chromaticity polynomials + the
    Perez luminance distribution, kcd/m² × SKY_RADIANCE_SCALE."""
    cos_ts = float(np.clip(sun[1], 0.02, 1.0))
    ts = float(np.arccos(cos_ts))
    t2, t3 = ts * ts, ts ** 3
    xz = ((0.00166 * t3 - 0.00375 * t2 + 0.00209 * ts) * T * T
          + (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * ts + 0.00394) * T
          + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * ts + 0.25886))
    yz = ((0.00275 * t3 - 0.00610 * t2 + 0.00317 * ts) * T * T
          + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * ts + 0.00516) * T
          + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * ts + 0.26688))
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * ts)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192

    coefs = {
        "Y": (0.1787 * T - 1.4630, -0.3554 * T + 0.4275, -0.0227 * T + 5.3251,
              0.1206 * T - 2.5771, -0.0670 * T + 0.3703),
        "x": (-0.0193 * T - 0.2592, -0.0665 * T + 0.0008, -0.0004 * T + 0.2125,
              -0.0641 * T - 0.8989, -0.0033 * T + 0.0452),
        "y": (-0.0167 * T - 0.2608, -0.0950 * T + 0.0092, -0.0079 * T + 0.2102,
              -0.0441 * T - 1.6537, -0.0109 * T + 0.0529),
    }

    cos_t = np.clip(dirs[:, 1], 0.01, 1.0)
    cos_g = np.clip(dirs @ sun, -1.0, 1.0)
    gamma = np.arccos(cos_g)

    def perez(ct, g, cg, A, B, C, D, E):
        return (1.0 + A * np.exp(B / ct)) * (1.0 + C * np.exp(D * g)
                                             + E * cg * cg)

    def ratio(key):
        A, B, C, D, E = coefs[key]
        den = max(perez(1.0, ts, cos_ts, A, B, C, D, E), 1e-6)
        return perez(cos_t, gamma, cos_g, A, B, C, D, E) / den

    Y = Yz * ratio("Y")
    x = xz * ratio("x")
    y = yz * ratio("y")
    Yy = Y / np.maximum(y, 1e-5)
    X = x * Yy
    Z = (1.0 - x - y) * Yy
    rgb = np.stack([3.2406 * X - 1.5372 * Y - 0.4986 * Z,
                    -0.9689 * X + 1.8758 * Y + 0.0415 * Z,
                    0.0557 * X - 0.2040 * Y + 1.0570 * Z], -1)
    return np.maximum(rgb, 0.0) * SKY_RADIANCE_SCALE


def _fit_preetham_basis(sun_np: np.ndarray, T: float):
    """Least-squares fit of the 12-function basis to the Preetham model
    (float64 numpy): (params (4,) f32, M (12, 3) f32) in engine units."""
    n = 4096
    i = np.arange(n, dtype=np.float64) + 0.5
    cos_t = 1.0 - i / n
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t ** 2))
    dirs = np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], -1)
    target = _preetham_rgb_np(dirs, sun_np, float(T)) / SKY_RADIANCE_SCALE
    # representative nonlinear constants from the Perez Y row
    B = float(-0.3554 * T + 0.4275)
    D = float(0.1206 * T - 2.5771)
    params = np.array([B, D, D * 0.35, 0.6], np.float64)
    cos_g = np.clip(dirs @ sun_np, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    F = np.stack(ss._features(np.clip(dirs[:, 1], 0.0, 1.0), cos_g, gamma,
                              *params, xp=np), -1)
    wgt = 1.0 / np.maximum(np.linalg.norm(target, axis=-1, keepdims=True),
                           1e-3)
    M, *_ = np.linalg.lstsq(F * wgt, target * wgt, rcond=None)
    return (params.astype(np.float32),
            (M * SKY_RADIANCE_SCALE).astype(np.float32))


def _fit_sky_basis(s: SkySettings, sun_np: np.ndarray):
    """(basis_p, basis_m, sun_poly) in engine units for the configured
    model: "hosek" (the spectral fit) or "preetham"."""
    fade = float(np.clip((sun_np[1] + 0.1) * 8.0, 0.0, 1.0))
    vis = float(np.clip((sun_np[1] + 0.05) * 12.0, 0.0, 1.0))
    if getattr(s, "model", "hosek") == "hosek":
        params, M = ss.fit_basis(sun_np)
        M = M * (SPECTRAL_SCALE * s.sky_intensity * fade)
        poly = ss.sun_rgb_poly(float(sun_np[1]), s.sun_angular_diameter)
        poly = poly * (SPECTRAL_SCALE * s.sun_intensity * vis)
    else:
        # the Preetham target through the same basis (one per-pixel path)
        params, M = _fit_preetham_basis(sun_np, s.turbidity)
        M = M * (s.sky_intensity * fade)
        # warm sun with limb = 0.4 + 0.6·s exactly (a degree-1 polynomial)
        elev = float(np.clip(sun_np[1], 0.0, 1.0))
        warm = np.array([1.0, 0.75 + 0.23 * np.sqrt(elev),
                         0.52 + 0.44 * np.sqrt(elev)])
        base = SUN_RADIANCE_SCALE * s.sun_intensity * vis
        poly = np.zeros((6, 3))
        poly[0] = 0.4 * base * warm
        poly[1] = 0.6 * base * warm
    return (np.asarray(params, np.float32), np.asarray(M, np.float32),
            np.asarray(poly, np.float32))


def make_sky_state(s: SkySettings, device="cpu") -> SkyState:
    sun = sun_direction(s.time_of_day, s.sun_axis_angle)
    sun_np = np.array([float(v) for v in sun], np.float64)
    basis_p, basis_m, sun_poly = _fit_sky_basis(s, sun_np)
    cos_r = torch.cos(torch.deg2rad(
        torch.tensor(s.sun_angular_diameter, dtype=torch.float32) * 0.5))
    n_env = ENV_W * ENV_H
    base = sky_state_from_numpy(dict(
        sun_dir=np.array([float(v) for v in sun], np.float32),
        turbidity=s.turbidity, sky_intensity=s.sky_intensity,
        sun_intensity=s.sun_intensity, cos_sun_radius=float(cos_r),
        env_prob=np.ones(n_env, np.float32),
        env_alias=np.zeros(n_env, np.int32),
        env_pmf=np.full(n_env, 1.0 / n_env, np.float32),
        basis_p=basis_p, basis_m=basis_m, sun_poly=sun_poly), "cpu")
    _, pdf = build_sky_map(base, ENV_W, ENV_H)
    tab = at.build(np.maximum(pdf.numpy().reshape(-1), 1e-9))
    arrays = {f: getattr(base, f) for f in SkyState._fields}
    arrays.update(sun_dir=np.array([float(v) for v in sun], np.float32),
                  env_prob=tab.prob, env_alias=tab.alias, env_pmf=tab.pmf)
    return sky_state_from_numpy(arrays, device)


def sky_state_from_numpy(a: dict, device="cpu") -> SkyState:
    """SkyState from numpy arrays / floats (also the interop entry)."""
    def t(v, dtype=torch.float32):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    sun = np.asarray([float(v) for v in a["sun_dir"]], np.float32)
    return SkyState(
        sun_dir=tuple(t(v) for v in sun),
        turbidity=t(a["turbidity"]), sky_intensity=t(a["sky_intensity"]),
        sun_intensity=t(a["sun_intensity"]),
        cos_sun_radius=t(a["cos_sun_radius"]),
        env_prob=t(a["env_prob"]), env_alias=t(a["env_alias"], torch.int32),
        env_pmf=t(a["env_pmf"]), basis_p=t(a["basis_p"]),
        basis_m=t(a["basis_m"]), sun_poly=t(a["sun_poly"]),
        host=host_scalars(sun, np.asarray(a["cos_sun_radius"]),
                          np.asarray(_np(a["basis_p"])),
                          np.asarray(_np(a["basis_m"])),
                          np.asarray(_np(a["sun_poly"]))))


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


# ---------------------------------------------------------------------------
# Per-pixel evaluation
# ---------------------------------------------------------------------------

def eval_basis(cos_t, cos_g, gamma, params, M):
    """Per-pixel RGB from the fitted basis; params/M are host float lists."""
    f = ss._features(cos_t, cos_g, gamma, params[0], params[1], params[2],
                     params[3], xp=torch)
    r = g = b = None
    for k in range(N_BASIS):
        r = f[k] * M[k][0] if r is None else r + f[k] * M[k][0]
        g = f[k] * M[k][1] if g is None else g + f[k] * M[k][1]
        b = f[k] * M[k][2] if b is None else b + f[k] * M[k][2]
    return (torch.clamp(r, min=0.0), torch.clamp(g, min=0.0),
            torch.clamp(b, min=0.0))


def sky_radiance(d, sky: SkyState):
    h = sky.host
    sun = h["sun"]
    cos_t = torch.clamp(d[1], 0.0, 1.0)
    cos_g = torch.clamp(d[0] * sun[0] + d[1] * sun[1] + d[2] * sun[2],
                        -1.0, 1.0)
    gamma = torch.arccos(cos_g)
    r, g, b = eval_basis(cos_t, cos_g, gamma, h["basis_p"], h["basis_m"])
    horizon_dim = torch.where(d[1] < 0.0, 0.35, 1.0)
    return (r * horizon_dim, g * horizon_dim, b * horizon_dim)


def _sun_poly_eval(poly, s):
    r = poly[5][0] + s * 0.0
    g = poly[5][1] + s * 0.0
    b = poly[5][2] + s * 0.0
    for i in (4, 3, 2, 1, 0):
        r = r * s + poly[i][0]
        g = g * s + poly[i][1]
        b = b * s + poly[i][2]
    return r, g, b


def _sin2_r(cos_r: float) -> float:
    c = np.float32(cos_r)
    return float(max(np.float32(1.0) - c * c, np.float32(1e-12)))


def sun_radiance(d, sky: SkyState):
    h = sky.host
    sun = h["sun"]
    cos_g = d[0] * sun[0] + d[1] * sun[1] + d[2] * sun[2]
    in_disk = cos_g > h["cos_r"]
    s2 = 1.0 - (1.0 - cos_g * cos_g) / _sin2_r(h["cos_r"])
    s = m.sqrt(torch.clamp(s2, 0.0, 1.0))
    r, g, b = _sun_poly_eval(h["sun_poly"], s)
    z = torch.where(in_disk, 1.0, 0.0)
    return (torch.clamp(r, min=0.0) * z, torch.clamp(g, min=0.0) * z,
            torch.clamp(b, min=0.0) * z)


def sun_radiance_cone(u1, sky: SkyState):
    h = sky.host
    cos_r = h["cos_r"]
    cos_g = 1.0 - u1 * float(np.float32(1.0) - np.float32(cos_r))
    s = m.sqrt(torch.clamp(1.0 - (1.0 - cos_g * cos_g) / _sin2_r(cos_r),
                               0.0, 1.0))
    r, g, b = _sun_poly_eval(h["sun_poly"], s)
    return (torch.clamp(r, min=0.0), torch.clamp(g, min=0.0),
            torch.clamp(b, min=0.0))


# ---------------------------------------------------------------------------
# Packed per-frame scalars of the fused shading kernel (render/ris_kernel.py):
# everything that does not depend on the pixel's direction, as one flat f32
# vector — sun direction and cone, the sun polynomial, the fitted basis.
# ---------------------------------------------------------------------------

SF_SUN_X, SF_SUN_Y, SF_SUN_Z = 0, 1, 2
SF_COS_SUN = 3          # cos of sun angular radius
SF_PDF_SUN = 4          # solid-angle pdf of the sun cone sample
SF_ANY_LIGHTS = 5
SF_INV_SIN2R = 6        # 1 / sin²(sun radius) — limb sample-cosine constant
SF_SUN_POLY = 8         # 18 slots: (6 powers) × RGB, row-major i*3+c
SF_BASIS_P = 26         # 4 slots: B̄, Ē₁, Ē₂, H̄
SF_BASIS_M = 30         # 36 slots: (12 basis fns) × RGB, row-major k*3+c
SF_LEN = 72


def sky_scalar_pack(sky: SkyState, any_lights) -> torch.Tensor:
    """(SF_LEN,) f32 vector of per-frame sky/sun scalars, on the sky
    state's device (layout above).  any_lights: a 0-d bool tensor on that
    device (read there, not on the host) or a host bool."""
    cos_r = sky.cos_sun_radius
    pdf_sun = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_r), min=1e-9)
    inv_sin2r = 1.0 / torch.clamp(1.0 - cos_r * cos_r, min=1e-12)
    dev = cos_r.device
    lit = (any_lights.to(torch.float32)
           if isinstance(any_lights, torch.Tensor)
           else torch.full((), float(bool(any_lights)), device=dev))
    head = torch.stack([*sky.sun_dir, cos_r, pdf_sun, lit,
                        inv_sin2r, torch.zeros((), device=dev)])
    return torch.cat([head.to(torch.float32), sky.sun_poly.reshape(-1),
                      sky.basis_p.reshape(-1), sky.basis_m.reshape(-1),
                      torch.zeros(SF_LEN - 66, device=dev)])


def sky_radiance_scalars(d, sf, rcp=None, rsqrt=None):
    """sky_radiance over the packed scalar vector (the fused kernel's
    form: polynomial acos, basis constants read from `sf`)."""
    sun = (sf[SF_SUN_X], sf[SF_SUN_Y], sf[SF_SUN_Z])
    cos_t = torch.clamp(d[1], 0.0, 1.0)
    cos_g = torch.clamp(m.dot(d, sun), -1.0, 1.0)
    gamma = _acos_poly(cos_g)
    f = ss._features(cos_t, cos_g, gamma, sf[SF_BASIS_P], sf[SF_BASIS_P + 1],
                     sf[SF_BASIS_P + 2], sf[SF_BASIS_P + 3],
                     xp=torch, rcp=rcp, rsqrt=rsqrt, sqrt=m.sqrt)
    r = g = b = None
    for k in range(N_BASIS):
        mk = SF_BASIS_M + k * 3
        r = f[k] * sf[mk] if r is None else r + f[k] * sf[mk]
        g = f[k] * sf[mk + 1] if g is None else g + f[k] * sf[mk + 1]
        b = f[k] * sf[mk + 2] if b is None else b + f[k] * sf[mk + 2]
    hz = torch.where(d[1] < 0.0, 0.35, 1.0)
    return (torch.clamp(r, min=0.0) * hz, torch.clamp(g, min=0.0) * hz,
            torch.clamp(b, min=0.0) * hz)


def sun_radiance_scalars_cone(sin_t, sf):
    """Sun radiance of the fused kernel's cone candidate from the sampled
    sine of the cone angle: limb sample cosine √(1 − sin²γ·SF_INV_SIN2R),
    then the degree-5 RGB Horner over the packed polynomial."""
    s = m.sqrt(torch.clamp(1.0 - sin_t * sin_t * sf[SF_INV_SIN2R], 0.0, 1.0))
    r = sf[SF_SUN_POLY + 15]
    g = sf[SF_SUN_POLY + 16]
    b = sf[SF_SUN_POLY + 17]
    for i in (4, 3, 2, 1, 0):
        r = r * s + sf[SF_SUN_POLY + i * 3]
        g = g * s + sf[SF_SUN_POLY + i * 3 + 1]
        b = b * s + sf[SF_SUN_POLY + i * 3 + 2]
    return (torch.clamp(r, min=0.0), torch.clamp(g, min=0.0),
            torch.clamp(b, min=0.0))


def _acos_poly(x):
    """Branchless polynomial acos (Abramowitz–Stegun 4.4.45, |err| ≤ 7e-5
    rad); gamma only feeds exp(D·γ)."""
    ax = torch.abs(x)
    r = m.sqrt(torch.clamp(1.0 - ax, min=0.0)) * (
        1.5707963 + ax * (-0.2121144 + ax * (0.0742610 - 0.0187293 * ax)))
    return torch.where(x >= 0.0, r, math.pi - r)


def equal_area_dirs(w: int, h: int, device="cpu"):
    u = (torch.arange(w, dtype=torch.float32, device=device)[None, :] + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=device)[:, None] + 0.5) / h
    phi = 2.0 * math.pi * u
    cos_t = (1.0 - v).expand(h, w)
    sin_t = m.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = phi + 0 * cos_t
    return (sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))


def build_sky_map(sky: SkyState, w: int, h: int):
    d = equal_area_dirs(w, h, sky.env_pmf.device)
    r, g, b = sky_radiance(d, sky)
    lum = m.luminance(r, g, b)
    pdf = lum / torch.clamp(lum.sum(), min=1e-9)
    return torch.stack([r, g, b], dim=-1), pdf


def sky_env_sample(sky: SkyState, u1, u2, u3):
    """Draw a sky direction ∝ the env luminance map: (dir, pdf_sa)."""
    texel, pmf = at.sample(sky.env_prob, sky.env_alias, sky.env_pmf, u1)
    iu = (texel % ENV_W).to(torch.float32)
    iv = (texel // ENV_W).to(torch.float32)
    phi = 2.0 * math.pi * (iu + u2) / ENV_W
    cos_t = 1.0 - (iv + u3) / ENV_H
    sin_t = m.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    d = (sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
    return d, pmf / _ENV_OMEGA


def sky_env_pdf(sky: SkyState, d):
    phi = torch.atan2(d[2], d[0])
    u = torch.remainder(phi / (2.0 * math.pi), 1.0)
    iu = torch.clamp((u * ENV_W).to(torch.int32), 0, ENV_W - 1)
    iv = torch.clamp(((1.0 - d[1]) * ENV_H).to(torch.int32), 0, ENV_H - 1)
    pmf = at.take(sky.env_pmf, iv * ENV_W + iu)
    return torch.where(d[1] > 0.0, pmf / _ENV_OMEGA, 0.0)
