"""Per-pixel warped history gather (reprojection) — port of
rtvb_tpu/ops/warp_kernel.py.

`warp_nearest` serves ReSTIR's reservoir fetch: it moves 32-bit words
(the planes carry bitcast ints and bf16 pairs, which may be NaN patterns,
so nothing does float arithmetic on them).  `warp_bilinear` serves the
denoiser's history: a 2×2 blend, where the first `pair_channels` input
planes carry two bf16 values each and yield two output planes.

CUDA tensors launch ``csrc/warp_kernel.cu`` (K5), a direct gather with no
window, so it matches the plain versions (`warp_nearest_ref`,
`warp_bilinear_ref`) on every pixel, `valid` included.
"""
from __future__ import annotations

import torch

from .. import kernels as K
from .dda import floor_i32
from .pack import unpack2


def warp_nearest_ref(hist, sy, sx):
    """out[c, p] = hist[c, round(sy[p]), round(sx[p])] (edge-clamped read),
    valid where the source pixel is inside the image."""
    C, H, W = hist.shape
    y = floor_i32(sy + 0.5)
    x = floor_i32(sx + 0.5)
    valid = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    idx = (torch.clamp(y, 0, H - 1) * W + torch.clamp(x, 0, W - 1)).long()
    words = hist.reshape(C, H * W).view(torch.int32)
    out = words[:, idx.reshape(-1)].reshape(C, H, W).view(torch.float32)
    return out, valid


def warp_bilinear_ref(hist, sy, sx, pair_channels: int = 0):
    if pair_channels:
        parts = []
        for c in range(hist.shape[0]):
            if c < pair_channels:
                a, b = unpack2(hist[c])
                parts += [a, b]
            else:
                parts.append(hist[c])
        return warp_bilinear_ref(torch.stack(parts), sy, sx)
    C, H, W = hist.shape
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    fy = (sy - y0f)[None]
    fx = (sx - x0f)[None]
    y0 = floor_i32(y0f)
    x0 = floor_i32(x0f)
    valid = (y0 >= 0) & (y0 < H - 1) & (x0 >= 0) & (x0 < W - 1)
    idx = (torch.clamp(y0, 0, H - 2) * W + torch.clamp(x0, 0, W - 2)).long()
    flat = hist.reshape(C, H * W)

    def tap(off):
        return flat[:, (idx + off).reshape(-1)].reshape(C, H, W)

    v00, v01, v10, v11 = tap(0), tap(1), tap(W), tap(W + 1)
    out = ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
           + (v10 * (1 - fx) + v11 * fx) * fy)
    return out, valid


WARP = K.register(K.CudaKernel("warp", "rtvb_warp",
                               [K.P] * 3 + [K.I] * 5 + [K.P] * 2))


def _warp_cuda(hist, sy, sx, bilinear: bool, pair_channels: int):
    C, H, W = hist.shape
    dev = hist.device
    hist = K.as_input("hist", hist, torch.float32, (C, H, W), dev)
    sy = K.as_input("sy", sy, torch.float32, (H, W), dev)
    sx = K.as_input("sx", sx, torch.float32, (H, W), dev)
    pairs = pair_channels if bilinear else 0
    if not 0 <= pairs <= C:
        raise ValueError(f"pair_channels {pairs} out of range for {C} planes")
    if bilinear and (H < 2 or W < 2):
        raise ValueError("bilinear warp needs H, W >= 2")
    out = torch.empty((C + pairs, H, W), dtype=torch.float32, device=dev)
    valid = torch.empty((H, W), dtype=torch.bool, device=dev)
    WARP.launch(dev, hist, sy, sx, C, H, W, int(bilinear), pairs, out,
                valid)
    return out, valid


def warp_nearest(hist, sy, sx):
    """hist (C, H, W) f32 bit-carrier planes; sy, sx (H, W) source pixel
    coordinates.  Returns (out (C, H, W), valid (H, W) bool)."""
    if K.on_cuda(hist):
        return _warp_cuda(hist, sy, sx, False, 0)
    return warp_nearest_ref(hist, sy, sx)


def warp_bilinear(hist, sy, sx, pair_channels: int = 0):
    """Bilinear variant; out has C + pair_channels planes."""
    if K.on_cuda(hist):
        return _warp_cuda(hist, sy, sx, True, pair_channels)
    return warp_bilinear_ref(hist, sy, sx, pair_channels)
