"""Denoiser passes: firefly filter, Poisson pre-pass, temporal
accumulation, history fix and clamp, à-trous wavelet (port of rtvb_tpu/ops/denoise/passes.py).

Images keep the JAX package's (H, W, C) layout.  Fixed-offset stencils
read edge-clamped neighbours (`shift`); the history fetch is the bilinear
warp (K5); the à-trous pass is `atrous_kernel.atrous_pass` (K6 on CUDA).
"""
from __future__ import annotations

import torch

from .. import mathutil as m
from ..pack import octa_decode, octa_encode, pack2
from ..warp_kernel import warp_bilinear

BIG = 1e30


def shift(img, dy: int, dx: int):
    """out[y, x] = img[clamp(y - dy), clamp(x - dx)] (static offsets)."""
    if not dy and not dx:
        return img
    H, W = img.shape[0], img.shape[1]
    dev = img.device
    rows = torch.clamp(torch.arange(H, device=dev) - dy, 0, H - 1)
    cols = torch.clamp(torch.arange(W, device=dev) - dx, 0, W - 1)
    return img.index_select(0, rows).index_select(1, cols)


def firefly_filter(rgb, depth, normal, depth_tol: float = 0.1,
                   normal_tol: float = 0.5):
    """Bilateral rank-conditioned rank selection: clamp each pixel's
    luminance into the range of its surface-compatible neighbours."""
    lum = m.luminance(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    nmax = torch.full_like(lum, -BIG)
    nmin = torch.full_like(lum, BIG)
    any_ok = torch.zeros(lum.shape, dtype=torch.bool, device=lum.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nl = shift(lum, dy, dx)
            nd = shift(depth, dy, dx)
            ok = torch.abs(nd - depth) <= depth_tol * torch.clamp(depth,
                                                                  min=1.0)
            nn = shift(normal, dy, dx)
            ok = ok & ((nn * normal).sum(-1) > normal_tol)
            any_ok = any_ok | ok
            nmax = torch.maximum(nmax, torch.where(ok, nl, -BIG))
            nmin = torch.minimum(nmin, torch.where(ok, nl, BIG))
    target = torch.minimum(torch.maximum(lum, nmin), nmax)
    scale = torch.where(any_ok & (lum > 1e-6),
                        target / torch.clamp(lum, min=1e-6), 1.0)
    return rgb * scale[..., None]


# 8-point Poisson-disk offsets (radius 3 px)
_POISSON_TAPS = ((-3, 0), (3, 1), (0, -3), (-1, 3),
                 (2, -2), (-2, -2), (2, 2), (-2, 3))


def pre_pass(illum, depth, normal, strength: float = 0.5):
    """Edge-stopping Poisson-disk blur mixed into the input at `strength`
    (before temporal accumulation: softens 1-spp shot noise)."""
    acc = illum
    wsum = torch.ones_like(depth)
    for dy, dx in _POISSON_TAPS:
        nd = shift(depth, dy, dx)
        nn = shift(normal, dy, dx)
        w = torch.exp(-torch.abs(nd - depth)
                      / torch.clamp(0.05 * depth, min=0.1))
        w = w * torch.clamp((nn * normal).sum(-1), min=0.0)
        w = torch.where((nd >= BIG) | (depth >= BIG), 0.0, w)
        acc = acc + shift(illum, dy, dx) * w[..., None]
        wsum = wsum + w
    blurred = acc / wsum[..., None]
    return illum + (blurred - illum) * strength


def temporal_accumulate(illum, moments_in, motion_u, motion_v, depth, normal,
                        slow_hist, fast_hist, moments_hist, hist_len,
                        prev_depth, prev_normal, max_slow: int, max_fast: int,
                        disocclusion_threshold: float):
    """Dual (slow/fast) exponential history with bilinear reprojection of
    the bf16-pair packed history (7 planes → 13 channels) and disocclusion
    tests.  Returns (slow, fast, moments, hist_len)."""
    H, W = depth.shape
    dev = depth.device
    u_cur = (torch.arange(W, device=dev) + 0.5)[None, :] / W
    v_cur = 1.0 - (torch.arange(H, device=dev) + 0.5)[:, None] / H
    valid_mv = (torch.abs(motion_u) < 1.5) & (torch.abs(motion_v) < 1.5)
    u_prev = u_cur + torch.where(valid_mv, motion_u, 0.0)
    v_prev = v_cur + torch.where(valid_mv, motion_v, 0.0)

    nu, nv = octa_encode((prev_normal[..., 0], prev_normal[..., 1],
                          prev_normal[..., 2]))
    prev_pack = torch.stack([
        pack2(slow_hist[..., 0], slow_hist[..., 1]),
        pack2(slow_hist[..., 2], fast_hist[..., 0]),
        pack2(fast_hist[..., 1], fast_hist[..., 2]),
        pack2(moments_hist[..., 0], moments_hist[..., 1]),
        pack2(nu, nv),
        pack2(hist_len, hist_len),
        prev_depth,
    ])
    sx = (u_prev * W - 0.5).contiguous()
    sy = ((1.0 - v_prev) * H - 0.5).contiguous()
    sampled, inb = warp_bilinear(prev_pack, sy, sx, pair_channels=6)
    s_slow = torch.stack([sampled[0], sampled[1], sampled[2]], -1)
    s_fast = torch.stack([sampled[3], sampled[4], sampled[5]], -1)
    s_mom = torch.stack([sampled[6], sampled[7]], -1)
    s_norm = torch.stack(octa_decode(sampled[8], sampled[9]), -1)
    s_len = sampled[10]
    s_depth = sampled[12]

    depth_ok = torch.abs(s_depth - depth) <= disocclusion_threshold * \
        torch.clamp(torch.maximum(s_depth, depth), min=1.0)
    ndot = (s_norm * normal).sum(-1)
    surf_ok = inb & valid_mv & depth_ok & (ndot > 0.5) & (depth < BIG)

    new_len = torch.where(surf_ok, torch.clamp(s_len + 1.0,
                                               max=float(max_slow)), 1.0)
    a_slow = 1.0 / torch.clamp(new_len, max=float(max_slow))
    a_fast = 1.0 / torch.clamp(new_len, max=float(max_fast))
    ok3 = surf_ok[..., None]
    slow = torch.where(ok3, s_slow + (illum - s_slow) * a_slow[..., None],
                       illum)
    fast = torch.where(ok3, s_fast + (illum - s_fast) * a_fast[..., None],
                       illum)
    mom = torch.where(ok3, s_mom + (moments_in - s_mom) * a_slow[..., None],
                      moments_in)
    return slow, fast, mom, new_len


def history_fix(slow, depth, hist_len, stride: int = 4):
    """Wide edge-aware blur where the history is short."""
    wide = torch.zeros_like(slow)
    wsum = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nd = shift(depth, dy * stride, dx * stride)
            w = torch.exp(-torch.abs(nd - depth)
                          / torch.clamp(depth * 0.1, min=0.3))
            wide = wide + shift(slow, dy * stride, dx * stride) * w[..., None]
            wsum = wsum + w
    wide = wide / torch.clamp(wsum, min=1e-6)[..., None]
    return torch.where((hist_len < 4.0)[..., None], wide, slow)


def history_clamp(slow, fast, sigma: float = 1.5):
    """Clamp the slow history into the fast history's local colour box."""
    mean = torch.zeros_like(fast)
    mean2 = torch.zeros_like(fast)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            f = shift(fast, dy, dx)
            mean = mean + f
            mean2 = mean2 + f * f
    mean = mean / 9.0
    mean2 = mean2 / 9.0
    std = m.sqrt(torch.clamp(mean2 - mean * mean, min=0.0))
    return torch.minimum(torch.maximum(slow, mean - sigma * std),
                         mean + sigma * std)


_W1D = {0: 0.375, 1: 0.25, 2: 0.0625}


def atrous_pass_plain(illum, var, depth, normal, step: int, phi_lum: float,
                      phi_normal: float, phi_depth: float):
    """One edge-stopping 5×5 à-trous iteration on (H, W, 3) illum + (H, W)
    variance — the plain version of K6 (any device)."""
    lum_c = m.luminance(illum[..., 0], illum[..., 1], illum[..., 2])
    sigma_l = phi_lum * m.sqrt(torch.clamp(var, min=1e-8)) + 1e-3
    w0 = 0.375 * 0.375
    acc = illum * w0
    acc_v = var * (w0 * w0)
    wsum = torch.full_like(depth, w0)
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            if dy == 0 and dx == 0:
                continue
            wk = _W1D[abs(dy)] * _W1D[abs(dx)]
            oy, ox = dy * step, dx * step
            n_illum = shift(illum, oy, ox)
            n_var = shift(var, oy, ox)
            n_depth = shift(depth, oy, ox)
            n_norm = shift(normal, oy, ox)
            n_lum = m.luminance(n_illum[..., 0], n_illum[..., 1],
                                n_illum[..., 2])
            e_z = torch.abs(n_depth - depth) / (
                phi_depth * torch.clamp(depth, min=1.0)
                * max(abs(dy) + abs(dx), 1))
            ndot = torch.clamp(n_norm[..., 0] * normal[..., 0]
                               + n_norm[..., 1] * normal[..., 1]
                               + n_norm[..., 2] * normal[..., 2], min=0.0)
            w_n = m.pow_weight(ndot, phi_normal)
            e_l = torch.abs(n_lum - lum_c) / sigma_l
            w = wk * torch.exp(-(e_z + e_l)) * w_n
            sky = (n_depth >= BIG) | (depth >= BIG)
            w = torch.where(sky, 0.0, w)
            acc = acc + n_illum * w[..., None]
            acc_v = acc_v + n_var * (w * w)
            wsum = wsum + w
    inv = 1.0 / torch.clamp(wsum, min=1e-6)
    return acc * inv[..., None], acc_v * inv * inv
