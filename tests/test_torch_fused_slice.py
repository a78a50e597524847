"""The shipped-default real-time frame of the port (Engine with `Settings()`
at 64×64, device="cpu": fused shading through K4's plain version) against
the JAX package's `_build_run` composition with shade_backend="xla"
(render_frame → _denoise_jit → postprocess.run → u8), both started from
identical state carried across with rtvb_tpu_torch.interop; the same at
the 2/3 rung of a 96×96 output (64×64 inside, exact 3:2 on both axes: the
port's EASU against JAX's); and the port's fused frame against its own
in-line frame.  The JAX path trace + denoise at 64×64 compiles once and
serves both sizes' frames (only the post differs).  Whole frames at other
settings use this harness from their own files (each compiles its own JAX
frame, so they run beside this one): tests/test_torch_fused_norestir.py
and tests/test_torch_fused_widened.py.

Bars (why the whole-frame ones are statistical: tests/test_torch_slice.py):
* G-buffers of frame 1: equal to 1e-4 on ≥ 99.9% of pixels per plane;
* whole frames 1 and 2 (frame 2 from the JAX frame-1 state): u8 mean
  |Δ| ≤ 1.0 and ≥ 90% of pixels with every channel within 3/255;
* the port's fused against its in-line path, 3 frames: mean |Δ| of
  illum·albedo < 1e-4 and < 0.5% of pixels off by more than 1e-3 (the JAX
  package's own fused-vs-in-line bar, tests/test_ris_kernel.py).
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
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render.renderer import Engine, slice_settings

torch.set_num_threads(2)

H = W = 64
RUNG_OUT = 96                  # the 2/3 rung of a 96×96 output is 64×64


def _shipped(width, height):
    return Settings().replace(rendering={"render_width": width,
                                         "render_height": height})


def _jax_trace_denoise_fn(je):
    """render_frame → _denoise_jit at je's internal size, jitted."""
    rs_cfg = dataclasses.replace(je.settings.rendering,
                                 local_light_candidates=je._n_local)
    tp = je._tp

    def run(world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            prev_restir, light_remap, dstate, ent, atlas):
        def trace_fn(o, d, t_cap=None, any_hit=False):
            return jdda.trace(o, d, world.colmask, world.df_super[0], tp,
                              t_cap=t_cap, any_hit=any_hit,
                              maxh_row=world.maxh_super[0])
        g, new_restir = jpt.render_frame(
            je.cfg, world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            je.width, je.height, rs_cfg, trace_fn,
            prev_restir=prev_restir if rs_cfg.use_restir else None,
            light_remap=light_remap, entities=ent, atlas=atlas,
            shade_backend="xla", half_res_gi=rs_cfg.half_res_gi)
        rgb, new_d = _denoise_jit(g, dstate, je.settings.denoising)
        return g, rgb, new_restir, new_d

    return jax.jit(run)


def _jax_post_fn(je):
    """postprocess.run → u8 at je's output size, jitted."""
    def post(rgb, post_state, dt):
        out, new_p = jpp.run(rgb, post_state, je.settings.post_processing,
                             je.settings.tone_mapping, dt, je.out_height,
                             je.out_width)
        u8 = (jnp.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
        return u8, new_p

    return jax.jit(post)


def _two_frames(settings, trace_denoise, setup=None, step=None):
    """Two JAX frames of `settings` (trace + denoise through the shared
    jitted `trace_denoise`); after each, a port engine holding the state
    the JAX engine had BEFORE that frame.  setup(je), if given, runs on
    the new JAX engine (entities, camera), step(je) after each frame."""
    je = JEngine(settings=JSettings.from_dict(settings.to_dict()),
                 backend="xla")
    if setup is not None:
        setup(je)
    assert (je.width, je.height) == (W, H)
    assert je.settings.rendering.fused_shading
    je.restir_state = _commit(jrestir.initial_state(H, W))
    je.denoiser_state = _commit(initial_denoiser_state(H, W))
    post = _jax_post_fn(je)
    out = []
    for _ in range(2):
        pe = interop.engine_from_jax(je, Engine(settings=settings,
                                                device="cpu"))
        g, rgb, nr, nd = trace_denoise(
            je.world, je.materials, je.lights, je.sky_state, je.camera,
            je.history_camera, je.frame_index, je.restir_state,
            je._light_remap, je.denoiser_state, je.entity_buffers(),
            je.texture_atlas)
        u8, npost = post(rgb, je.post_state, jnp.float32(1 / 60))
        out.append(dict(port=pe, g=g, u8=np.asarray(u8)))
        je.restir_state, je.denoiser_state, je.post_state = nr, nd, npost
        je.frame_index += 1
        je.history_camera = je.camera
        if step is not None:
            step(je)
    return out


@pytest.fixture(scope="module")
def trace_denoise():
    je = JEngine(settings=JSettings.from_dict(_shipped(W, H).to_dict()),
                 backend="xla")
    return _jax_trace_denoise_fn(je)


@pytest.fixture(scope="module")
def frames(trace_denoise):
    """Two JAX fused frames at 64×64 and the port engines before each."""
    return _two_frames(_shipped(W, H), trace_denoise)


@pytest.fixture(scope="module")
def rung_frames(trace_denoise):
    """The same at the 2/3 rung of a 96×96 output: 64×64 inside."""
    return _two_frames(Settings().replace(rendering={
        "render_width": RUNG_OUT, "render_height": RUNG_OUT,
        "render_scale": 2.0 / 3.0}), trace_denoise)


def _frac_close(a, b, tol=1e-4):
    return np.mean(np.isclose(np.asarray(a), b, rtol=tol, atol=tol))


def _gbuffers_match(f):
    pg, _ = f["port"].render_gbuffers()
    jg = f["g"]
    jd = np.asarray(jg.depth)
    assert 0.3 < np.mean(jd < 1e30) < 1.0
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


def _u8_matches(f, out, label):
    u8 = f["port"].render_realtime()
    assert u8.shape == (out, out, 3) == f["u8"].shape
    assert u8.dtype == np.uint8
    d = np.abs(u8.astype(np.int32) - f["u8"].astype(np.int32))
    mean_d, frac3 = d.mean(), np.mean(d.max(axis=-1) <= 3)
    print(f"{label}: mean |d| {mean_d:.4f}, pixels within 3/255 "
          f"{frac3:.4f}")
    assert mean_d <= 1.0
    assert frac3 >= 0.90


def test_fused_frame1_gbuffers_match(frames):
    _gbuffers_match(frames[0])


@pytest.mark.parametrize("frame", [0, 1])
def test_fused_whole_frame_u8_matches(frames, frame):
    _u8_matches(frames[frame], W, f"fused whole frame {frame + 1}")


def test_rung_frame1_gbuffers_match(rung_frames):
    f = rung_frames[0]
    assert (f["port"].width, f["port"].height) == (W, H)
    assert (f["port"].out_width, f["port"].out_height) == (RUNG_OUT,
                                                           RUNG_OUT)
    _gbuffers_match(f)


@pytest.mark.parametrize("frame", [0, 1])
def test_rung_whole_frame_u8_matches(rung_frames, frame):
    _u8_matches(rung_frames[frame], RUNG_OUT,
                f"2/3-rung whole frame {frame + 1}")


def test_engine_from_jax_refuses_other_sizes(frames):
    class Sized:
        width, height, out_width, out_height = W, H, RUNG_OUT, RUNG_OUT
    with pytest.raises(ValueError):
        interop.engine_from_jax(Sized(), frames[0]["port"])


def _path_traced(settings, n=3):
    """illum·albedo of n frames (reservoirs and frame index advanced as
    the JAX Engine.path_trace does)."""
    eng = Engine(settings=settings, device="cpu")
    eng._ensure_states()
    out = []
    for _ in range(n):
        g, new_restir = eng.render_gbuffers()
        eng.restir_state = new_restir
        eng.frame_index += 1
        out.append(np.stack([(g.illum[i] * g.albedo[i]).numpy()
                             for i in range(3)], -1))
    return out


def test_fused_matches_inline_composition():
    fused = _path_traced(_shipped(W, H))
    inline = _path_traced(slice_settings(W, H))
    for i, (a, b) in enumerate(zip(inline, fused)):
        d = np.abs(a - b)
        assert d.mean() < 1e-4, (i, d.mean())
        assert (d.max(-1) > 1e-3).mean() < 0.005, i
