"""The gameplay frame of the port against the JAX package's: a night world
(time_of_day 0) with a lantern placed on the picked face, the camera
aimed at it and the picked block's highlight on (the interactive app's
config), 64×64.  The JAX side is `render_frame` with block_highlight →
`_denoise_jit` → `postprocess.run` with the overlay and the highlight, as
`_build_run` composes them (shade_backend "xla"); the lit frame streams
8 local-light candidates at bounce 0 and 2 at bounces 1–2, and its
first frame consumes the edit's light-slot remap.  Before each frame a
port engine takes the JAX engine's state (rtvb_tpu_torch.interop).  Then
the same two frames with the four dev-panel settings the port now runs
(denoising.pre_pass, post_processing.lens_flare and crosshair, sky.model
"preetham") and a UI overlay: the path trace compile is shared, only the
denoise and the post recompile.

Bars: those of tests/test_torch_fused_slice.py (why they are statistical:
tests/test_torch_slice.py): G-buffers of frame 1 equal to 1e-4 on ≥ 99.9%
of pixels per plane, the highlight mask included; whole frames 1 and 2:
u8 mean |Δ| ≤ 1.0 and ≥ 90% of pixels with every channel within 3/255.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.assets import blocks as JB
from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.ops import dda as jdda
from rtvb_tpu.render import pathtracer as jpt
from rtvb_tpu.render import postprocess as jpp
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu.render.denoiser import _denoise_jit, initial_denoiser_state
from rtvb_tpu.render.renderer import Engine as JEngine, _commit
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render.renderer import Engine
from test_torch_fused_slice import _frac_close, _u8_matches

torch.set_num_threads(2)

H = W = 64
POSE = dict(pos=(32.0, 14.0, 8.0), yaw=1.1, pitch=-0.9)
DEV_PANEL = dict(denoising={"pre_pass": True},
                 post_processing={"lens_flare": True, "crosshair": True},
                 sky={"model": "preetham"})


def _gameplay():
    return Settings().replace(rendering={"render_width": W,
                                         "render_height": H,
                                         "block_highlight": True})


def _jax_engine(settings, overlay=None):
    """A JAX engine at night, aimed at the ground, a lantern placed on the
    picked face (apps/interactive.py's right click)."""
    je = JEngine(settings=JSettings.from_dict(settings.to_dict()),
                 backend="xla")
    je.set_sky(time_of_day=0.0)
    je.set_camera(**POSE)
    hit, (x, y, z), n = je.pick_block()
    assert hit
    je.set_block(int(x + n[0]), int(y + n[1]), int(z + n[2]), JB.LANTERN)
    assert je._n_lights == 12
    if overlay is not None:
        je.set_ui_overlay(overlay)
    return je


def _jax_trace_fn(je):
    """render_frame with block_highlight, jitted; its n_local is the lit
    engine's (8)."""
    rs_cfg = dataclasses.replace(je.settings.rendering,
                                 local_light_candidates=je._n_local)
    tp, cfg = je._tp, je.cfg

    def run(world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            prev_restir, light_remap, ent, atlas):
        def trace_fn(o, d, t_cap=None, any_hit=False):
            return jdda.trace(o, d, world.colmask, world.df_super[0], tp,
                              t_cap=t_cap, any_hit=any_hit,
                              maxh_row=world.maxh_super[0])
        return jpt.render_frame(
            cfg, world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            je.width, je.height, rs_cfg, trace_fn,
            prev_restir=prev_restir, light_remap=light_remap, entities=ent,
            atlas=atlas, shade_backend="xla", half_res_gi=rs_cfg.half_res_gi,
            block_highlight=rs_cfg.block_highlight)
    return jax.jit(run)


def _jax_post_fn(je):
    """postprocess.run with the overlay and the highlight → u8, jitted."""
    def post(rgb, post_state, dt, overlay, highlight):
        out, new_p = jpp.run(rgb, post_state, je.settings.post_processing,
                             je.settings.tone_mapping, dt, je.out_height,
                             je.out_width, overlay_u8=overlay,
                             highlight=highlight)
        return (jnp.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8), \
            new_p
    return jax.jit(post)


def _full_remap(je):
    """The engine's light remap identity-extended to the table's size, as
    ris_kernel.pack_light_tables extends it inside the frame: the same
    frame, and one compile for the edit's (8,) remap and the later
    identity (16,)."""
    r = np.asarray(je._light_remap)
    k = je.lights.key.shape[0]
    return jnp.asarray(np.concatenate([r, np.arange(len(r), k)]).astype(
        np.int32)[:k])


def _two_frames(settings, trace, overlay=None):
    """Two JAX gameplay frames; before each, a port engine holding the
    JAX engine's state."""
    je = _jax_engine(settings, overlay)
    je.restir_state = _commit(jrestir.initial_state(H, W))
    je.denoiser_state = _commit(initial_denoiser_state(H, W))
    post = _jax_post_fn(je)
    out = []
    for _ in range(2):
        pe = interop.engine_from_jax(je, Engine(settings=settings,
                                                device="cpu"))
        g, nr = trace(je.world, je.materials, je.lights, je.sky_state,
                      je.camera, je.history_camera, je.frame_index,
                      je.restir_state, _full_remap(je), je.entity_buffers(),
                      je.texture_atlas)
        rgb, nd = _denoise_jit(g, je.denoiser_state, je.settings.denoising)
        u8, npost = post(rgb, je.post_state, jnp.float32(1 / 60),
                         je._ui_overlay, g.highlight)
        out.append(dict(port=pe, g=g, u8=np.asarray(u8)))
        je.restir_state, je.denoiser_state, je.post_state = nr, nd, npost
        je._light_remap = je._identity_remap()
        je.frame_index += 1
        je.history_camera = je.camera
    return out


@pytest.fixture(scope="module")
def trace():
    return _jax_trace_fn(_jax_engine(_gameplay()))


@pytest.fixture(scope="module")
def frames(trace):
    return _two_frames(_gameplay(), trace)


def _overlay():
    ov = np.zeros((H, W, 4), np.uint8)
    ov[4:14, 6:40] = (230, 230, 240, 160)       # a translucent panel
    ov[50:52, :] = (255, 200, 0, 255)
    return ov


@pytest.fixture(scope="module")
def dev_panel_frames(trace):
    return _two_frames(_gameplay().replace(**DEV_PANEL), trace, _overlay())


def _gbuffers_match(f):
    pe = f["port"]
    assert pe._n_local == 8 and pe.lights.count == 12
    pg, _ = pe.render_gbuffers()
    jg = f["g"]
    planes = [("depth", jg.depth, pg.depth),
              ("roughness", jg.roughness, pg.roughness),
              ("motion_u", jg.motion_u, pg.motion_u),
              ("motion_v", jg.motion_v, pg.motion_v),
              ("highlight", jg.highlight, pg.highlight)]
    for name in ("normal", "albedo"):
        for i in range(3):
            planes.append((f"{name}{i}", getattr(jg, name)[i],
                           getattr(pg, name)[i]))
    for name, a, b in planes:
        assert _frac_close(a, b.numpy()) >= 0.999, name
    assert np.mean(np.asarray(jg.emissive_first)
                   == pg.emissive_first.numpy()) >= 0.999
    hl = np.asarray(jg.highlight)
    assert 10 < hl.sum() < 0.2 * hl.size       # the picked face's outline


def test_lit_frame1_gbuffers_match(frames):
    # frame 1 consumes the edit's remap: 8 slots of the lightless table
    assert frames[0]["port"]._light_remap.tolist() == [-1] * 8
    _gbuffers_match(frames[0])


@pytest.mark.parametrize("frame", [0, 1])
def test_lit_whole_frame_u8_matches(frames, frame):
    _u8_matches(frames[frame], W, f"lit gameplay frame {frame + 1}")
    # the lantern lights its surroundings at night
    assert frames[frame]["u8"].mean() > 2.0


def test_dev_panel_frame1_gbuffers_match(dev_panel_frames):
    _gbuffers_match(dev_panel_frames[0])


@pytest.mark.parametrize("frame", [0, 1])
def test_dev_panel_whole_frame_u8_matches(dev_panel_frames, frame):
    f = dev_panel_frames[frame]
    assert f["port"].sky_state.sun_poly[2:].abs().max() == 0   # Preetham
    _u8_matches(f, W, f"dev-panel gameplay frame {frame + 1}")
    # the crosshair and the opaque overlay row
    assert (f["u8"][H // 2, W // 2 - 1: W // 2 + 1] == 255).all()
    assert (f["u8"][50] == (255, 200, 0)).all()
