"""The whole real-time frame of the port (Engine with `slice_settings()` at
64×64, device="cpu") against the JAX package's `_build_run` composition
with the same settings (render_frame → _denoise_jit → postprocess.run →
u8), both started from identical state carried across with
rtvb_tpu_torch.interop.

Why the whole-frame bars are statistical: the XLA reference on the CPU
evaluates rsqrt with an estimate plus a Newton step, fuses a*b + c into
FMAs when jitted, and its exp / log2 / sin / cos / acos / atan2 differ
from torch's in the last bit on 2-40% of inputs.  A primary ray that is
one ulp off can land on the other side of a voxel edge, a sun or sky
sample can flip a shadow ray at a concave corner or another RIS choice,
and the denoiser spreads each such pixel over its à-trous footprint.
About 0.4-1.2% of pixels' noisy illumination differ this way, also
against JAX run op by op or with XLA held to SSE4.2 (no FMA, rounded
rsqrt).  So:

* G-buffers of frame 1: equal to 1e-4 on ≥ 99.9% of pixels per plane;
* denoise + post on identical G-buffers (the deterministic half of the
  frame): u8 mean |Δ| ≤ 1.0 and ≥ 99% of pixels within 3/255;
* whole frames 1 and 2 (frame 2 from the JAX frame-1 state): u8 mean
  |Δ| ≤ 1.0 and ≥ 90% of pixels with every channel within 3/255
  (measured 95.9% and 92.8%, mean |Δ| 0.53 and 0.68).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.ops import dda as jdda
from rtvb_tpu.render import pathtracer as jpt
from rtvb_tpu.render import postprocess as jpp
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu.render.denoiser import _denoise_jit, initial_denoiser_state
from rtvb_tpu.render.renderer import Engine as JEngine, _commit
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.render import pathtracer as ppt
from rtvb_tpu_torch.render import postprocess as ppp
from rtvb_tpu_torch.render.denoiser import denoise_frame
from rtvb_tpu_torch.render.renderer import Engine, slice_settings

torch.set_num_threads(2)

H = W = 64


def jax_settings(port_settings):
    """The JAX package's Settings with the port settings' values."""
    return JSettings.from_dict(port_settings.to_dict())


def _jax_frame_fn(je):
    rs_cfg = dataclasses.replace(je.settings.rendering,
                                 local_light_candidates=je._n_local)
    tp = je._tp

    def run(world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            prev_restir, light_remap, dstate, post_state, dt, ent, atlas):
        def trace_fn(o, d, t_cap=None, any_hit=False):
            return jdda.trace(o, d, world.colmask, world.df_super[0], tp,
                              t_cap=t_cap, any_hit=any_hit,
                              maxh_row=world.maxh_super[0])
        g, new_restir = jpt.render_frame(
            je.cfg, world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            W, H, rs_cfg, trace_fn, prev_restir=prev_restir,
            light_remap=light_remap, entities=ent, atlas=atlas,
            shade_backend=None, half_res_gi=rs_cfg.half_res_gi)
        rgb, new_d = _denoise_jit(g, dstate, je.settings.denoising)
        out, new_p = jpp.run(rgb, post_state, je.settings.post_processing,
                             je.settings.tone_mapping, dt, H, W)
        u8 = (jnp.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
        return g, u8, new_restir, new_d, new_p

    return jax.jit(run)


@pytest.fixture(scope="module")
def frames():
    """Two JAX frames; after each, a port engine holding the state the JAX
    engine had BEFORE that frame."""
    je = JEngine(settings=jax_settings(slice_settings(W, H)), width=W,
                 height=H, backend="xla")
    je.restir_state = _commit(jrestir.initial_state(H, W))
    je.denoiser_state = _commit(initial_denoiser_state(H, W))
    fn = _jax_frame_fn(je)
    out = []
    for _ in range(2):
        pe = interop.engine_from_jax(
            je, Engine(settings=slice_settings(W, H), device="cpu"))
        g, u8, nr, nd, npost = fn(
            je.world, je.materials, je.lights, je.sky_state, je.camera,
            je.history_camera, je.frame_index, je.restir_state,
            je._light_remap, je.denoiser_state, je.post_state,
            jnp.float32(1 / 60), je.entity_buffers(), je.texture_atlas)
        out.append(dict(port=pe, g=g, u8=np.asarray(u8),
                        dstate=je.denoiser_state, post=je.post_state))
        je.restir_state, je.denoiser_state, je.post_state = nr, nd, npost
        je.frame_index += 1
        je.history_camera = je.camera
    return out


def _frac_close(a, b, tol=1e-4):
    return np.mean(np.isclose(np.asarray(a), b, rtol=tol, atol=tol))


def test_frame1_gbuffers_match(frames):
    f = frames[0]
    pg, _ = f["port"].render_gbuffers()
    jg = f["g"]
    jd = np.asarray(jg.depth)
    assert 0.3 < np.mean(jd < 1e30) < 1.0
    assert np.mean((jd < 1e30) == (pg.depth.numpy() < 1e30)) >= 0.999
    planes = [("depth", jg.depth, pg.depth),
              ("roughness", jg.roughness, pg.roughness),
              ("motion_u", jg.motion_u, pg.motion_u),
              ("motion_v", jg.motion_v, pg.motion_v)]
    for name in ("normal", "albedo"):
        for i in range(3):
            planes.append((f"{name}{i}", getattr(jg, name)[i],
                           getattr(pg, name)[i]))
    for name, a, b in planes:
        assert _frac_close(a, b.numpy()) >= 0.999, name
    assert np.mean(np.asarray(jg.emissive_first)
                   == pg.emissive_first.numpy()) >= 0.999


def _u8_stats(a, b):
    """(mean |Δ| over all values, fraction of pixels with every channel
    within 3/255)."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return d.mean(), np.mean(d.max(axis=-1) <= 3)


@pytest.mark.parametrize("frame", [0, 1])
def test_denoise_post_on_identical_gbuffers(frames, frame):
    f = frames[frame]
    pe = f["port"]
    jg = f["g"]
    T = lambda a: torch.from_numpy(np.array(a))
    g = ppt.GBuffers(
        illum=tuple(T(c) for c in jg.illum),
        albedo=tuple(T(c) for c in jg.albedo),
        normal=tuple(T(c) for c in jg.normal), depth=T(jg.depth),
        roughness=T(jg.roughness), motion_u=T(jg.motion_u),
        motion_v=T(jg.motion_v), emissive_first=T(jg.emissive_first))
    dstate = interop.denoiser_state(f["dstate"])
    rgb, _ = denoise_frame(g, dstate, pe.settings.denoising)
    out, _ = ppp.run(rgb, interop.post_state(f["post"]),
                     pe.settings.post_processing, pe.settings.tone_mapping,
                     1 / 60, H, W)
    u8 = (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).numpy()
    mean_d, frac3 = _u8_stats(u8, f["u8"])
    assert mean_d <= 1.0
    assert frac3 >= 0.99


@pytest.mark.parametrize("frame", [0, 1])
def test_whole_frame_u8_matches(frames, frame):
    f = frames[frame]
    u8 = f["port"].render_realtime()
    assert u8.shape == (H, W, 3) and u8.dtype == np.uint8
    mean_d, frac3 = _u8_stats(u8, f["u8"])
    print(f"whole frame {frame + 1}: mean |d| {mean_d:.4f}, "
          f"pixels within 3/255 {frac3:.4f}")
    assert mean_d <= 1.0
    assert frac3 >= 0.90
