"""EASU upscale (FSR-1 class) — port of rtvb_tpu/ops/easu_kernel.py and its
twin, rtvb_tpu/render/postprocess.py `easu(force_generic=True)`.

Per output pixel: a direction field (luma gradients and a feature length,
computed at input resolution and bilinearly blended at the sample point)
stretches a 12-tap negative-lobe kernel along the edge; the result is
clamped to the inner 2×2 quad's range (deringing).

`easu_plain` fixes the rules the CUDA kernel (K7, ``csrc/easu_kernel.cu``)
follows to the bit:
* source positions are exact rationals per axis: for output index o,
  num = (2o+1)·in − out, den = 2·out, base = floor(num / den) and
  frac = (num − base·den)·(1/den) — any ratio, the two axes independent;
* the border follows the twin: the field is computed at input resolution
  with edge-clamped neighbours, and both the colour taps and the field
  taps are clamped to the image (the TPU kernel instead builds the field
  from its edge-padded window, so its first and last output rows and
  columns differ from the twin's);
* the weight maths runs in the twin's order: the 12 taps in
  `_EASU_TAPS12` order, 1/sqrt, a true division by max(wsum, 1e-5), the
  inner-quad clamp; no division by a scalar (PyTorch on CUDA turns it
  into a product with 1/c, the kernel would not).

CUDA tensors launch K7; CPU tensors run `easu_plain`.
"""
from __future__ import annotations

import torch

from .. import kernels as K
from . import mathutil as m

TAPS12 = ((-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (0, 2),
          (1, -1), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1))
_QUAD = ((0, 0), (0, 1), (1, 0), (1, 1))


def source_axis(out_size: int, in_size: int, device="cpu"):
    """(base int64, frac f32) of each output index along one axis."""
    o = torch.arange(out_size, dtype=torch.int64, device=device)
    num = (2 * o + 1) * in_size - out_size
    den = 2 * out_size
    base = torch.div(num, den, rounding_mode="floor")
    return base, (num - base * den).to(torch.float32) * (1.0 / den)


def direction_field(img):
    """(dx, dy, length) of each input texel from edge-clamped luma
    neighbours: three (H, W) planes."""
    H, W = img.shape[:2]
    dev = img.device
    lum = 0.5 * img[..., 1] + 0.25 * (img[..., 0] + img[..., 2])
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    lA = lum[:, torch.clamp(xs - 1, 0, W - 1)]
    lB = lum[:, torch.clamp(xs + 1, 0, W - 1)]
    lD = lum[torch.clamp(ys - 1, 0, H - 1)]
    lE = lum[torch.clamp(ys + 1, 0, H - 1)]
    dx = lB - lA
    dy = lE - lD
    rng_x = torch.abs(lA - lum) + torch.abs(lB - lum)
    rng_y = torch.abs(lD - lum) + torch.abs(lE - lum)
    qx = torch.clamp(torch.abs(dx) / torch.clamp(rng_x, min=1e-4), 0.0, 1.0)
    qy = torch.clamp(torch.abs(dy) / torch.clamp(rng_y, min=1e-4), 0.0, 1.0)
    return dx, dy, qx * qx + qy * qy


def easu_plain(img, out_h: int, out_w: int):
    """(H, W, 3) f32 → (out_h, out_w, 3) f32 EASU upscale in plain PyTorch."""
    H, W = img.shape[:2]
    dev = img.device
    by, fy = source_axis(out_h, H, dev)
    bx, fx = source_axis(out_w, W, dev)
    fy = fy[:, None]
    fx = fx[None, :]
    rows = {d: torch.clamp(by + d, 0, H - 1) for d in (-1, 0, 1, 2)}
    cols = {d: torch.clamp(bx + d, 0, W - 1) for d in (-1, 0, 1, 2)}

    def tap(plane, dy, dx):
        return plane.index_select(0, rows[dy]).index_select(1, cols[dx])

    fields = direction_field(img)
    wf = (1 - fx) * (1 - fy)
    wg = fx * (1 - fy)
    wj = (1 - fx) * fy
    wk = fx * fy
    dirx, diry, length = (tap(f, 0, 0) * wf + tap(f, 0, 1) * wg
                          + tap(f, 1, 0) * wj + tap(f, 1, 1) * wk
                          for f in fields)
    dr2 = dirx * dirx + diry * diry
    has_dir = dr2 > 1e-8
    inv = torch.where(has_dir,
                      torch.reciprocal(m.sqrt(torch.clamp(dr2, min=1e-8))),
                      0.0)
    dirx_n = torch.where(has_dir, dirx * inv, 1.0)
    diry_n = diry * inv
    inv_along = torch.reciprocal(1.0 + length)

    acc = wsum = None
    quad = []
    for dy, dx in TAPS12:
        t = tap(img, dy, dx)
        if (dy, dx) in _QUAD:
            quad.append(t)
        vx = dx - fx
        vy = dy - fy
        along = vx * dirx_n + vy * diry_n
        across = -vx * diry_n + vy * dirx_n
        a = along * inv_along
        d2 = torch.clamp(a * a + across * across, max=4.0)
        b = 0.4 * d2 - 1.0
        w = torch.clamp(b * b * 1.5625 - 0.5625, min=0.0)[..., None]
        acc = t * w if acc is None else acc + t * w
        wsum = w if wsum is None else wsum + w
    out = acc / torch.clamp(wsum, min=1e-5)
    f_, g_, j_, k_ = quad
    qmin = torch.minimum(torch.minimum(f_, g_), torch.minimum(j_, k_))
    qmax = torch.maximum(torch.maximum(f_, g_), torch.maximum(j_, k_))
    return torch.clamp(out, min=qmin, max=qmax)


EASU = K.register(K.CudaKernel("easu", "rtvb_easu",
                               [K.P] + [K.I] * 4 + [K.F] * 2 + [K.P]))


def _easu_cuda(img, out_h: int, out_w: int):
    H, W = img.shape[:2]
    dev = img.device
    img = K.as_input("img", img, torch.float32, (H, W, 3), dev)
    if H < 1 or W < 1 or out_h < 1 or out_w < 1:
        raise ValueError(f"easu: empty image {H}x{W} -> {out_h}x{out_w}")
    out = torch.empty((out_h, out_w, 3), dtype=torch.float32, device=dev)
    EASU.launch(dev, img, H, W, out_h, out_w, 1.0 / (2 * out_h),
                1.0 / (2 * out_w), out)
    return out


def easu(img, out_h: int, out_w: int):
    """EASU upscale of an (H, W, 3) f32 image to (out_h, out_w, 3)."""
    if K.on_cuda(img):
        return _easu_cuda(img, out_h, out_w)
    return easu_plain(img, out_h, out_w)
