"""Denoiser orchestration: the RELAX-style pass chain over G-buffers (port
of rtvb_tpu/render/denoiser.py).  Pass order: firefly → Poisson pre-pass
(off by default) → temporal accumulation (bootstrapped on the first
frame: a device bool selects, so the frame has no host branch on it) →
history fix → history clamp → à-trous × N (K6) → albedo remodulation."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import DenoisingSettings

from ..ops import mathutil as m
from ..ops.denoise import passes
from ..ops.denoise.atrous_kernel import atrous_pass

BIG = 1e30


class DenoiserState(NamedTuple):
    slow: torch.Tensor          # (H, W, 3) accumulated illumination
    fast: torch.Tensor          # (H, W, 3) fast history
    moments: torch.Tensor       # (H, W, 2) luminance moments
    hist_len: torch.Tensor      # (H, W)
    prev_depth: torch.Tensor    # (H, W)
    prev_normal: torch.Tensor   # (H, W, 3)
    bootstrapped: torch.Tensor  # () bool: history holds a real frame


def initial_denoiser_state(h: int, w: int, device="cpu") -> DenoiserState:
    z = dict(dtype=torch.float32, device=device)
    return DenoiserState(
        slow=torch.zeros((h, w, 3), **z), fast=torch.zeros((h, w, 3), **z),
        moments=torch.zeros((h, w, 2), **z), hist_len=torch.zeros((h, w), **z),
        prev_depth=torch.full((h, w), BIG, **z),
        prev_normal=torch.zeros((h, w, 3), **z),
        bootstrapped=torch.zeros((), dtype=torch.bool, device=device))


def denoise_frame(g, state: DenoiserState, cfg: DenoisingSettings):
    """The JAX package's _denoise_jit: (rgb (H, W, 3) linear, new state)."""
    illum_raw = torch.stack(g.illum, dim=-1)
    normal = torch.stack(g.normal, dim=-1)
    albedo = torch.stack(g.albedo, dim=-1)
    depth = g.depth

    illum = illum_raw
    if cfg.firefly_filter:
        illum = passes.firefly_filter(illum, depth, normal)
    if cfg.pre_pass:
        illum = passes.pre_pass(illum, depth, normal)

    lum = m.luminance(illum[..., 0], illum[..., 1], illum[..., 2])
    moments_in = torch.stack([lum, lum * lum], dim=-1)

    if cfg.temporal_accumulation:
        slow, fast, moments, hist_len = passes.temporal_accumulate(
            illum, moments_in, g.motion_u, g.motion_v, depth, normal,
            state.slow, state.fast, state.moments, state.hist_len,
            state.prev_depth, state.prev_normal,
            cfg.max_accumulated_frames, cfg.max_fast_accumulated_frames,
            cfg.disocclusion_threshold)
        # first frame: the history is empty — bootstrap from this frame
        boot = state.bootstrapped
        slow = torch.where(boot, slow, illum)
        fast = torch.where(boot, fast, illum)
        moments = torch.where(boot, moments, moments_in)
        hist_len = torch.where(boot, hist_len, torch.ones_like(hist_len))
    else:
        slow, fast, moments, hist_len = illum, illum, moments_in, \
            torch.ones_like(depth)

    if cfg.history_fix:
        slow = passes.history_fix(slow, depth, hist_len)
    if cfg.history_clamping:
        slow = passes.history_clamp(slow, fast)

    var = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)
    var = var * torch.clamp(4.0 / torch.clamp(hist_len, min=1.0), 1.0, 4.0)

    filtered = slow.contiguous()
    var = var.contiguous()
    depth_c = depth.contiguous()
    normal_c = normal.contiguous()
    for i in range(cfg.atrous_iterations):
        filtered, var = atrous_pass(filtered, var, depth_c, normal_c, 1 << i,
                                    cfg.phi_luminance, cfg.phi_normal,
                                    cfg.phi_depth)

    rgb = filtered * albedo
    raw = illum_raw * albedo
    rgb = torch.where(g.emissive_first[..., None], raw, rgb)
    new_state = DenoiserState(slow=slow, fast=fast, moments=moments,
                              hist_len=hist_len, prev_depth=depth,
                              prev_normal=normal,
                              bootstrapped=torch.ones_like(
                                  state.bootstrapped))
    return rgb, new_state
