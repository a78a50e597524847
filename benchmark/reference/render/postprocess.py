"""Post-processing: auto-exposure → bloom → lens flare → vignette → tone
map → block highlight → upscale (EASU, K7, below render_scale 1) → RCAS
sharpen → crosshair → overlay (port of rtvb_tpu/render/postprocess.py).

Nothing here reads a device value on the host or uploads host data in the
frame: the histogram is a fixed 64-bin scatter, `dt` may be a device
scalar, and the constants (the lens flare's tints, the tone curve's white
point) are built once outside the frame (`frame_constants`)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import PostProcessingSettings, ToneMappingSettings

from ..ops import easu_kernel
from ..ops import mathutil as m


class PostState(NamedTuple):
    exposure: torch.Tensor     # () adapted log2 exposure


class PostConstants(NamedTuple):
    """Tensors the post chain needs that depend on the settings only."""
    flare_tints: torch.Tensor | None   # (3, 3): ghosts 1, 2, 3
    white_curve: torch.Tensor | None   # () Uncharted 2 curve at the white


FLARE_TINTS = ((0.35, 0.55, 0.9), (0.9, 0.6, 0.3), (0.8, 0.3, 0.8))


def frame_constants(pp: PostProcessingSettings, tm: ToneMappingSettings,
                    device) -> PostConstants:
    """The constants of `run` for these settings on `device`, built
    outside the frame (a host upload each, once)."""
    tints = None
    if pp.lens_flare:
        tints = torch.tensor(FLARE_TINTS, dtype=torch.float32,
                             device=device)
    white = None
    if tm.curve == "uncharted2":
        white = _uncharted2_curve(torch.tensor(
            tm.white_point, dtype=torch.float32, device=device))
    return PostConstants(flare_tints=tints, white_curve=white)


def initial_post_state(device="cpu") -> PostState:
    return PostState(exposure=torch.zeros((), dtype=torch.float32,
                                          device=device))


def _box_down4(img):
    """4×4 average pool of an (H, W, C) image with H, W multiples of 4."""
    h, w = img.shape[0] // 4, img.shape[1] // 4
    r = img.reshape(h, 4, w, 4, *img.shape[2:]).sum(dim=(1, 3))
    return r * (1.0 / 16.0)


def histogram(bins, nbins: int) -> torch.Tensor:
    """Counts of the int bins (each already in [0, nbins)) as nbins f32:
    a scatter into a fixed-size output, where torch.bincount on the card
    reads the input's maximum back to the host to size its output.  The
    counts are integers below 2²⁴, so the order of the adds is exact."""
    flat = bins.reshape(-1).long()
    return torch.zeros(nbins, dtype=torch.float32, device=bins.device
                       ).index_add_(0, flat, torch.ones(
                           flat.shape, dtype=torch.float32,
                           device=bins.device))


def auto_exposure(rgb, state: PostState, cfg: PostProcessingSettings, dt):
    """Histogram of 4×4-pooled log luminance → windowed-percentile mean →
    exponential adaptation toward mid grey.  dt: seconds, a 0-d f32
    tensor (the frame's, in device memory) or a host float."""
    h4 = (rgb.shape[0] // 4) * 4
    w4 = (rgb.shape[1] // 4) * 4
    small = _box_down4(rgb[:h4, :w4])
    lum = m.luminance(small[..., 0], small[..., 1], small[..., 2])
    log_lum = torch.log2(torch.clamp(lum, min=1e-6))
    lo, hi = cfg.exposure_min_log, cfg.exposure_max_log
    nbins = 64
    t = torch.clamp((log_lum - lo) / (hi - lo), 0.0, 1.0)
    bins = torch.clamp((t * nbins).to(torch.int32), 0, nbins - 1)
    hist = histogram(bins, nbins)
    cdf = torch.cumsum(hist, 0) / torch.clamp(hist.sum(), min=1.0)
    dev = rgb.device
    centers = lo + (torch.arange(nbins, device=dev) + 0.5) / nbins * (hi - lo)
    in_win = (cdf >= cfg.exposure_low_percentile) & \
        (cdf <= cfg.exposure_high_percentile)
    w = torch.where(in_win, hist, 0.0)
    avg_log = (w * centers).sum() / torch.clamp(w.sum(), min=1.0)
    target = -avg_log - 1.0
    if not isinstance(dt, torch.Tensor):
        dt = torch.full((), dt, dtype=torch.float32, device=dev)
    adapt = 1.0 - torch.exp(-cfg.exposure_adapt_speed * dt)
    return state.exposure + (target - state.exposure) * adapt


def _box_blur(img, radius: int, axis: int):
    acc = img
    for r in range(1, radius + 1):
        acc = acc + torch.roll(img, r, dims=axis) + torch.roll(img, -r,
                                                               dims=axis)
    return acc / (2 * radius + 1)


def bloom(rgb, cfg: PostProcessingSettings):
    rgb_c = torch.clamp(rgb, max=64.0)
    lum = m.luminance(rgb_c[..., 0], rgb_c[..., 1], rgb_c[..., 2])
    k = torch.clamp(lum - cfg.bloom_threshold, min=0.0) / \
        torch.clamp(lum, min=1e-6)
    bright = rgb_c * k[..., None]
    h, w = rgb.shape[:2]
    h4, w4 = h // 4, w // 4
    small = _box_down4(bright[:h4 * 4, :w4 * 4])
    small = _box_blur(_box_blur(small, 4, 0), 4, 1)
    small = _box_blur(_box_blur(small, 2, 0), 2, 1)
    up = small.repeat_interleave(4, dim=0).repeat_interleave(4, dim=1)
    if h > h4 * 4 or w > w4 * 4:
        rows = torch.clamp(torch.arange(h, device=rgb.device), max=h4 * 4 - 1)
        cols = torch.clamp(torch.arange(w, device=rgb.device), max=w4 * 4 - 1)
        up = up.index_select(0, rows).index_select(1, cols)
    return rgb + cfg.bloom_intensity * up


def lens_flare(rgb, cfg: PostProcessingSettings, tints=None):
    """Ghosts + chromatic halo: a centre-mirrored ghost, a half-scale and
    a quarter-scale mirrored ghost pasted at fixed offsets, and a ring per
    channel driven by the frame's mean flare energy.  tints: the (3, 3)
    ghost tints (`frame_constants`), built here when not given."""
    lum = m.luminance(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    k = torch.clamp(lum - cfg.bloom_threshold * 2.0, min=0.0)
    bright = rgb * k[..., None]
    h, w = rgb.shape[:2]
    dev = rgb.device

    if tints is None:
        tints = torch.tensor(FLARE_TINTS, dtype=rgb.dtype, device=dev)
    # ghost 1: full-size centre mirror, cool
    ghost1 = torch.flip(bright, (0, 1)) * tints[0]
    # ghost 2: half-scale, centre-offset, warm
    g2 = bright[::2, ::2] * tints[1]
    ghost2 = torch.zeros_like(rgb)
    ghost2[h // 4: h // 4 + g2.shape[0], w // 4: w // 4 + g2.shape[1]] = g2
    # ghost 3: quarter-scale mirrored (rows h-1, h-5, ...), magenta
    g3 = torch.flip(bright, (0, 1))[::4, ::4] * tints[2]
    ghost3 = torch.zeros_like(rgb)
    o3y, o3x = (3 * h) // 8, (3 * w) // 8
    ghost3[o3y: o3y + g3.shape[0], o3x: o3x + g3.shape[1]] = g3

    # chromatic halo: a ring per channel (radius shifted for dispersion)
    # weighted by the frame's mean flare energy
    yy = ((torch.arange(h, device=dev) + 0.5) / h - 0.5)[:, None] * 2.0
    xx = ((torch.arange(w, device=dev) + 0.5) / w - 0.5)[None, :] * 2.0
    r = m.sqrt(yy * yy + xx * xx)
    energy = torch.mean(bright, dim=(0, 1))
    halo = torch.stack([
        energy[0] * torch.exp(-torch.square((r - 0.42) / 0.05)),
        energy[1] * torch.exp(-torch.square((r - 0.46) / 0.05)),
        energy[2] * torch.exp(-torch.square((r - 0.50) / 0.05)),
    ], dim=-1) * 12.0

    return rgb + cfg.lens_flare_intensity * (
        0.5 * ghost1 + 0.3 * ghost2 + 0.25 * ghost3 + 0.8 * halo)


def vignette(rgb, cfg: PostProcessingSettings):
    h, w = rgb.shape[:2]
    dev = rgb.device
    y = (torch.arange(h, device=dev) / h - 0.5)[:, None] * 2.0
    x = (torch.arange(w, device=dev) / w - 0.5)[None, :] * 2.0
    r2 = x * x + y * y
    fall = 1.0 - cfg.vignette_strength * torch.clamp(r2 * 0.7, 0.0, 1.0)
    return rgb * fall[..., None]


def _aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _uncharted2_curve(v):
    A, Bc, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((v * (A * v + C * Bc) + D * E) / (v * (A * v + Bc) + D * F)) \
        - E / F


def _uncharted2(x, white: float, fw=None):
    """fw: the curve at the white point, a 0-d tensor (`frame_constants`),
    built here when not given."""
    if fw is None:
        fw = _uncharted2_curve(torch.tensor(white, dtype=torch.float32,
                                            device=x.device))
    return torch.clamp(_uncharted2_curve(x) / torch.clamp(fw, min=1e-6),
                       0.0, 1.0)


def tone_map(rgb, tm: ToneMappingSettings, exposure_log2, white_curve=None):
    x = rgb * torch.exp2(exposure_log2 + tm.exposure_compensation)
    if tm.curve == "aces":
        y = _aces(x)
    elif tm.curve == "uncharted2":
        y = _uncharted2(x, tm.white_point, white_curve)
    elif tm.curve == "reinhard":
        y = torch.clamp(x / (1.0 + x), 0.0, 1.0)
    else:
        y = torch.clamp(x, 0.0, 1.0)
    y = tm.lift + (tm.gain - tm.lift) * y
    y = torch.clamp(0.5 + (y - 0.5) * tm.contrast, 0.0, 1.0)
    grey = m.luminance(y[..., 0], y[..., 1], y[..., 2])[..., None]
    y = torch.clamp(grey + (y - grey) * tm.saturation, 0.0, 1.0)
    return torch.where(y <= 0.0031308, 12.92 * y,
                       1.055 * torch.pow(y, 1 / 2.4) - 0.055)


def easu(img, out_h: int, out_w: int):
    """Edge-adaptive spatial upsampling (FSR-1-EASU class) of an (H, W, 3)
    image: K7 on a CUDA tensor, its plain version on a CPU one."""
    if img.shape[0] == out_h and img.shape[1] == out_w:
        return img
    return easu_kernel.easu(img, out_h, out_w)


def _catmull_rom_1d(img, out_size: int, axis: int):
    in_size = img.shape[axis]
    dev = img.device
    pos = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) \
        * in_size / out_size - 0.5
    i1 = torch.clamp(torch.floor(pos).to(torch.int64), 0, in_size - 1)
    f = pos - i1
    i0 = torch.clamp(i1 - 1, 0, in_size - 1)
    i2 = torch.clamp(i1 + 1, 0, in_size - 1)
    i3 = torch.clamp(i1 + 2, 0, in_size - 1)
    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    sh = [1] * img.ndim
    sh[axis] = out_size

    def take(idx):
        return img.index_select(axis, idx)

    return (take(i0) * w0.reshape(sh) + take(i1) * w1.reshape(sh)
            + take(i2) * w2.reshape(sh) + take(i3) * w3.reshape(sh))


def upscale(img, out_h: int, out_w: int, mode: str = "easu"):
    """Resample to the output size: "easu" (edge-adaptive), any other mode
    Catmull-Rom bicubic (plain PyTorch, as the JAX package leaves it to
    XLA)."""
    if img.shape[0] == out_h and img.shape[1] == out_w:
        return img
    if mode == "easu":
        return easu(img, out_h, out_w)
    return _catmull_rom_1d(_catmull_rom_1d(img, out_h, 0), out_w, 1)


def sharpen(img, strength: float):
    """Contrast-adaptive sharpen (RCAS-style), wrap-around neighbours."""
    up = torch.roll(img, -1, 0)
    dn = torch.roll(img, 1, 0)
    lf = torch.roll(img, -1, 1)
    rt = torch.roll(img, 1, 1)
    mn = torch.minimum(torch.minimum(up, dn), torch.minimum(lf, rt))
    mn = torch.minimum(mn, img)
    mx = torch.maximum(torch.maximum(up, dn), torch.maximum(lf, rt))
    mx = torch.maximum(mx, img)
    amp = m.sqrt(torch.clamp(torch.minimum(mn, 1.0 - mx)
                                 / torch.clamp(mx, min=1e-4), 0.0, 1.0))
    a = amp * strength * 0.2
    return torch.clamp(img * (1.0 + 4.0 * a) - (up + dn + lf + rt) * a,
                       0.0, 1.0)


def draw_crosshair(img):
    """A white 13-pixel cross, 2 pixels wide, at the image centre (a new
    tensor; the input is not written)."""
    h, w = img.shape[:2]
    cy, cx = h // 2, w // 2
    img = img.clone()
    img[cy - 6: cy + 7, cx - 1: cx + 1].fill_(1.0)
    img[cy - 1: cy + 1, cx - 6: cx + 7].fill_(1.0)
    return img


def compose_overlay(rgb, overlay_u8):
    ov = overlay_u8.to(torch.float32) * (1.0 / 255.0)
    a = ov[..., 3:4]
    return rgb * (1.0 - a) + ov[..., :3] * a


def run(rgb_linear, state: PostState, pp: PostProcessingSettings,
        tm: ToneMappingSettings, dt, out_h: int, out_w: int,
        overlay_u8=None, highlight=None, consts: PostConstants | None = None):
    """(H, W, 3) linear HDR → (out_h, out_w, 3) display sRGB in [0, 1].
    dt: seconds (a 0-d f32 tensor or a host float).
    overlay_u8: optional (out_h, out_w, 4) u8 UI overlay (RGBA).
    highlight: optional (H, W) f32 mask of picked-block edge pixels,
    forced white after tone mapping at the internal size, so the upscale
    carries it to the output.  consts: `frame_constants(pp, tm, …)`; a
    frame that must not upload host data passes them."""
    if consts is None:
        consts = frame_constants(pp, tm, rgb_linear.device)
    exp = auto_exposure(rgb_linear, state, pp, dt) if pp.auto_exposure \
        else state.exposure
    x = rgb_linear
    if pp.bloom:
        x = bloom(x, pp)
    if pp.lens_flare:
        x = lens_flare(x, pp, consts.flare_tints)
    if pp.vignette:
        x = vignette(x, pp)
    y = tone_map(x, tm, exp, consts.white_curve)
    if highlight is not None:
        hl = highlight[..., None]
        y = y * (1.0 - hl) + hl
    if pp.upscale != "none":
        y = upscale(y, out_h, out_w, pp.upscale)
    if pp.sharpen:
        y = sharpen(y, pp.sharpen_strength)
    if pp.crosshair:
        y = draw_crosshair(y)
    if overlay_u8 is not None:
        y = compose_overlay(y, overlay_u8)
    return y, PostState(exposure=exp)
