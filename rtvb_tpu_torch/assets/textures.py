"""Procedural surface textures evaluated per shading point (port of
rtvb_tpu/assets/textures.py): hash value noise, stripes, bricks in the
world-grid triplanar UV space, contrast rolled off with the ray-cone lod.

`sample_scale` and `sample_normal_delta` launch ``csrc/proctex_kernel.cu``
for CUDA tensors: one thread a pixel evaluates, in registers, only the
pattern its texture id selects.  CPU tensors run the plain versions,
`_sample_scale_plain` and `_sample_normal_delta_plain`, which the kernel
matches to the bit."""
from __future__ import annotations

import torch

from .. import kernels as K
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


def _sample_scale_plain(tex_id, u, v, lod=None):
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


def _sample_normal_delta_plain(tex_id, u, v, lod=None, eps: float = 0.004):
    s_up = _sample_scale_plain(tex_id, u + eps, v, lod)
    s_un = _sample_scale_plain(tex_id, u - eps, v, lod)
    s_vp = _sample_scale_plain(tex_id, u, v + eps, lod)
    s_vn = _sample_scale_plain(tex_id, u, v - eps, lod)
    du = (s_up - s_un) / (2.0 * eps)
    dv = (s_vp - s_vn) / (2.0 * eps)
    return du, dv


PROCTEX = K.register(K.CudaKernel("proctex", "rtvb_proctex",
                                  [K.P] * 4 + [K.I, K.I, K.F, K.F]
                                  + [K.P] * 2))


def _proctex_cuda(tex_id, u, v, lod, eps=None):
    """Launch csrc/proctex_kernel.cu on planes of u's shape (tex_id int32,
    u, v, lod float32; lod may be None): (scale,), or (du, dv) at `eps`
    when it is given."""
    dev, shape = u.device, u.shape
    args = [K.as_input(name, t.contiguous(), dtype, shape, dev)
            for name, t, dtype in (("tex_id", tex_id, torch.int32),
                                   ("u", u, torch.float32),
                                   ("v", v, torch.float32))]
    args.append(None if lod is None else
                K.as_input("lod", lod.contiguous(), torch.float32, shape, dev))
    n = u.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{n} pixels: the kernel indexes them in int32")
    delta = eps is not None
    out = torch.empty((1 + delta, *shape), dtype=torch.float32, device=dev)
    # torch on the card divides by a Python float as a product with its
    # reciprocal, taken in double and rounded to float32 (csrc/common.cuh)
    PROCTEX.launch(dev, *args, n, int(delta), float(eps or 0.0),
                   1.0 / (2.0 * eps) if delta else 0.0, out[0],
                   out[1] if delta else None)
    return out.unbind(0)


def sample_scale(tex_id, u, v, lod=None):
    """Albedo multiplier in ~[0.7, 1.3] per texture id (-1 → 1.0): the
    kernel for CUDA tensors, `_sample_scale_plain` for CPU tensors."""
    if K.on_cuda(u):
        return _proctex_cuda(tex_id, u, v, lod)[0]
    return _sample_scale_plain(tex_id, u, v, lod)


def sample_normal_delta(tex_id, u, v, lod=None, eps: float = 0.004):
    """Central differences of `sample_scale` over ±eps in u and in v → (du,
    dv): the kernel for CUDA tensors, `_sample_normal_delta_plain` for CPU
    tensors."""
    if K.on_cuda(u):
        return _proctex_cuda(tex_id, u, v, lod, eps)
    return _sample_normal_delta_plain(tex_id, u, v, lod, eps)


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
