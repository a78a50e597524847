"""The port's `render_frame(y0, rows)` — one band of a 32×32 image, rows
7..22 and 8..23 — against the JAX package's `render_frame` with the same
band (shade_backend "xla", the shipped settings but two bounces: fused
shading, temporal ReSTIR from a fresh state, blue noise, and the second
bounce at half res, so every place the band's rows enter runs), both
started from identical state carried across with rtvb_tpu_torch.interop.
One JAX compile serves both bands (y0 is traced, as in the JAX package's
band step); it lives in a file of its own so xdist runs it beside the
others, and the third bounce, which adds no use of the band's rows, is
left out to cut that compile by about a third.

Bars: the G-buffers at the slice bars (each plane equal to 1e-4 on ≥ 99.9%
of pixels; tests/test_torch_fused_slice.py).  And against the port's own
whole frame: every G-buffer plane of the band equals the frame's rows to
the bit, and at the even offset (the band's 2x2 GI quads on the frame's)
so does the illumination."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.ops import dda as jdda
from rtvb_tpu.render import pathtracer as jpt
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu.render.renderer import Engine as JEngine
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render import pathtracer
from rtvb_tpu_torch.render import restir as restir_mod
from rtvb_tpu_torch.render.renderer import Engine

torch.set_num_threads(2)

H = W = 32
ROWS = 16
BANDS = (7, 8)

PLANES = ["depth", "roughness", "motion_u", "motion_v"] + \
    [f"{name}{i}" for name in ("normal", "albedo") for i in range(3)]


def _plane(g, name):
    if name[-1].isdigit():
        return getattr(g, name[:-1])[int(name[-1])]
    return getattr(g, name)


def _settings():
    return Settings().replace(rendering={"render_width": W,
                                         "render_height": H,
                                         "total_bounce_limit": 2})


@pytest.fixture(scope="module")
def engines():
    je = JEngine(settings=JSettings.from_dict(_settings().to_dict()),
                 backend="xla")
    pe = interop.engine_from_jax(je, Engine(settings=_settings(),
                                            device="cpu"))
    return je, pe


@pytest.fixture(scope="module")
def jax_bands(engines):
    """JAX's G-buffers of each band, from one jitted band function."""
    je, _ = engines
    rs_cfg = dataclasses.replace(je.settings.rendering,
                                 local_light_candidates=je._n_local)
    assert rs_cfg.half_res_gi and rs_cfg.fused_shading and rs_cfg.use_restir
    tp = je._tp

    @jax.jit
    def band(world, mats, lights, sky_state, cam, hist_cam, frame_idx,
             prev_restir, light_remap, ent, atlas, y0):
        def trace_fn(o, d, t_cap=None, any_hit=False):
            return jdda.trace(o, d, world.colmask, world.df_super[0], tp,
                              t_cap=t_cap, any_hit=any_hit,
                              maxh_row=world.maxh_super[0])
        g, _ = jpt.render_frame(
            je.cfg, world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            W, H, rs_cfg, trace_fn, y0=y0, rows=ROWS,
            prev_restir=prev_restir, light_remap=light_remap, entities=ent,
            atlas=atlas, shade_backend="xla", half_res_gi=True)
        return g

    restir = jrestir.initial_state(ROWS, W)
    return {y0: band(je.world, je.materials, je.lights, je.sky_state,
                     je.camera, je.history_camera, je.frame_index, restir,
                     je._light_remap, je.entity_buffers(), je.texture_atlas,
                     jnp.int32(y0))
            for y0 in BANDS}


def _port_frame(pe, y0=0, rows=None):
    rs_cfg = dataclasses.replace(pe.settings.rendering,
                                 local_light_candidates=pe._n_local)
    g, _ = pathtracer.render_frame(
        pe.cfg, pe._tables, pe._tp, pe.materials, pe.lights, pe.sky_state,
        pe.camera, pe.history_camera, pe.frame_index, W, H, rs_cfg,
        prev_restir=restir_mod.initial_state(H if rows is None else rows,
                                             W),
        light_remap=pe._light_remap, entities=pe.entity_buffers(),
        atlas=pe.texture_atlas, half_res_gi=True, y0=y0, rows=rows)
    return g


@pytest.fixture(scope="module")
def port_bands(engines):
    _, pe = engines
    return {y0: _port_frame(pe, y0, ROWS) for y0 in BANDS}


@pytest.mark.parametrize("y0", BANDS)
def test_band_gbuffers_match_jax(jax_bands, port_bands, y0):
    jg, pg = jax_bands[y0], port_bands[y0]
    assert pg.depth.shape == (ROWS, W)
    hit = np.mean(np.asarray(jg.depth) < 1e30)
    assert 0.2 < hit < 1.0
    for name in PLANES:
        a = np.asarray(_plane(jg, name))
        b = _plane(pg, name).numpy()
        assert a.shape == b.shape == (ROWS, W), name
        frac = np.mean(np.isclose(a, b, rtol=1e-4, atol=1e-4))
        assert frac >= 0.999, (name, frac)
    assert np.mean(np.asarray(jg.emissive_first)
                   == pg.emissive_first.numpy()) >= 0.999


@pytest.mark.parametrize("y0", BANDS)
def test_band_equals_full_frame_rows(engines, port_bands, y0):
    _, pe = engines
    full = _port_frame(pe)
    band = port_bands[y0]
    rows = slice(y0, y0 + ROWS)
    for name in PLANES:
        assert torch.equal(_plane(band, name), _plane(full, name)[rows]), \
            name
    assert torch.equal(band.emissive_first, full.emissive_first[rows])
    if y0 % 2 == 0:      # the band's GI quads are the frame's
        for i in range(3):
            assert torch.equal(band.illum[i], full.illum[i][rows]), i
