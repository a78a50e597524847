"""Procedural surface textures evaluated per shading point (port of
rtvb_tpu/assets/textures.py): hash value noise, stripes, bricks in the
world-grid triplanar UV space, contrast rolled off with the ray-cone lod."""
from __future__ import annotations

import torch

from ..ops import mathutil as m
from ..ops.rng import pcg_hash, to_unit_float

TEXTURE_NAMES = ["noise_fine", "noise_mid", "noise_coarse", "stripes", "bricks"]
TEXTURE_IDS = {n: i for i, n in enumerate(TEXTURE_NAMES)}


def _value_noise(u, v, freq, seed):
    x = u * freq
    y = v * freq
    xi = torch.floor(x)
    yi = torch.floor(y)
    xf = x - xi
    yf = y - yi
    xf = xf * xf * (3.0 - 2.0 * xf)
    yf = yf * yf * (3.0 - 2.0 * yf)
    xi = xi.to(torch.int64)
    yi = yi.to(torch.int64)

    def lattice(ix, iy):
        # int32 wrap-around arithmetic of the JAX package, done in int64
        h = pcg_hash(ix * 374761393 + iy * 668265263 + seed)
        return to_unit_float(h)

    n00 = lattice(xi, yi)
    n10 = lattice(xi + 1, yi)
    n01 = lattice(xi, yi + 1)
    n11 = lattice(xi + 1, yi + 1)
    nx0 = n00 + xf * (n10 - n00)
    nx1 = n01 + xf * (n11 - n01)
    return nx0 + yf * (nx1 - nx0)


def _fbm(u, v, freq, seed, octaves=2):
    total = torch.zeros_like(u)
    amp, f, norm = 1.0, freq, 0.0
    for o in range(octaves):
        total = total + amp * _value_noise(u, v, f, seed + 131 * o)
        norm += amp
        amp *= 0.5
        f *= 2.0
    return total / norm


def sample_scale(tex_id, u, v, lod=None):
    """Albedo multiplier in ~[0.7, 1.3] per texture id (-1 → 1.0)."""
    fine = _fbm(u, v, 9.0, 11)
    mid = _fbm(u, v, 5.0, 23)
    coarse = _fbm(u, v, 3.0, 47)

    band = torch.sin((v + 0.35 * _value_noise(u, v, 2.0, 61)) * 18.0)
    stripes = 0.5 + 0.5 * band * band

    bu = u * 3.0
    bv = v * 6.0
    row = torch.floor(bv)
    bu = bu + torch.where((row.to(torch.int32) & 1) == 1, 0.5, 0.0)
    fu = bu - torch.floor(bu)
    fv = bv - torch.floor(bv)
    mortar = (fu < 0.06) | (fu > 0.94) | (fv < 0.1) | (fv > 0.9)
    bricks = torch.where(mortar, 0.35,
                         0.9 + 0.2 * _value_noise(torch.floor(bu), row, 1.0, 77))

    pattern = torch.full_like(u, 0.5)
    for k, pat in reversed(list(enumerate((fine, mid, coarse, stripes,
                                           bricks)))):
        pattern = torch.where(tex_id == k, pat, pattern)
    contrast = 0.6
    if lod is not None:
        contrast = 0.6 / (1.0 + 2.0 * lod)
    scale = 1.0 + contrast * (pattern - 0.5)
    return torch.where(tex_id < 0, 1.0, scale)


def sample_normal_delta(tex_id, u, v, lod=None, eps: float = 0.004):
    s_up = sample_scale(tex_id, u + eps, v, lod)
    s_un = sample_scale(tex_id, u - eps, v, lod)
    s_vp = sample_scale(tex_id, u, v + eps, lod)
    s_vn = sample_scale(tex_id, u, v - eps, lod)
    du = (s_up - s_un) / (2.0 * eps)
    dv = (s_vp - s_vn) / (2.0 * eps)
    return du, dv


def perturb_normal(n, du, dv, strength: float = 0.06):
    nx, ny, nz = n
    ax = torch.abs(nx)
    ay = torch.abs(ny)
    on_x = ax > 0.5
    on_y = (~on_x) & (ay > 0.5)
    zero = torch.zeros_like(nx)
    tu = (torch.where(on_x, 0.0, 1.0), zero, torch.where(on_x, 1.0, 0.0))
    tv = (zero, torch.where(on_y, 0.0, 1.0), torch.where(on_y, 1.0, 0.0))
    bent = (nx - strength * (du * tu[0] + dv * tv[0]),
            ny - strength * (du * tu[1] + dv * tv[1]),
            nz - strength * (du * tu[2] + dv * tv[2]))
    return m.normalize(bent)


def triplanar_uv(px, py, pz, nx, ny, nz):
    ax = torch.abs(nx)
    ay = torch.abs(ny)
    u = torch.where(ax > 0.5, pz, px)
    v = torch.where(ax > 0.5, py, torch.where(ay > 0.5, pz, py))
    return u - torch.floor(u), v - torch.floor(v)
