"""ablate_pt's variants of the port's path trace against the JAX
package's: `ablate_pt.variant_trace_fn` at 64×64 (the shipped settings:
fused shading, half-res GI, the atlas) against
`rtvb_tpu.render.pathtracer.render_frame` with the same variant, as the
JAX tool builds it off the TPU (its XLA `dda.trace` branch, here with the
fused body traced by XLA, `shade_backend="xla"`, the engine's own
configuration), both from the same state carried across by
rtvb_tpu_torch.interop.  Bars of the slice tests: each G-buffer plane
equal to 1e-4 on ≥ 99.9% of pixels; and the variant's illumination
(where the bounces differ) within 1e-3 on ≥ 98.5% of pixels: the slice
tests find 0.4-1.2% of a frame's illumination off by last-bit
differences of XLA and torch (measured here: 99.8% for b1, 99.3% for
b2).  Each variant costs one JAX compile (cold: b1 ≈ 45 s, b2 ≈ 80 s,
notex ≈ 100 s), so b2 and notex (the textures' patch applied to both
packages and restored) have files of their own that use this harness:
tests/test_torch_tools_jax_b2.py and tests/test_torch_tools_jax_notex.py."""
import contextlib
import dataclasses

import jax
import numpy as np
import torch

from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.ops import dda as jdda
from rtvb_tpu.render import pathtracer as jpt
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu.render.renderer import Engine as JEngine, _commit
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render.renderer import Engine
from rtvb_tpu_torch.tools import ablate_pt

torch.set_num_threads(2)

SIZE = 64


def _settings():
    return Settings().replace(rendering={"render_width": SIZE,
                                         "render_height": SIZE})


def jax_variant_fn(je, variant):
    """render_frame of the JAX package with `variant`'s settings (b1, b2:
    the bounce limit; notex: the settings as they are, the patch applied
    by the caller while this traces), jitted."""
    rs = je.settings.rendering
    rs_cfg = dataclasses.replace(rs, local_light_candidates=je._n_local)
    if variant in ("b1", "b2"):
        rs_cfg = dataclasses.replace(rs_cfg,
                                     total_bounce_limit=int(variant[1]))
    tp = je._tp

    def run(world, mats, lights, sky_state, cam, hist_cam, frame_idx,
            prev_restir, light_remap, ent, atlas):
        def trace_fn(o, d, t_cap=None, any_hit=False):
            return jdda.trace(o, d, world.colmask, world.df_super[0], tp,
                              t_cap=t_cap, any_hit=any_hit,
                              maxh_row=world.maxh_super[0])
        return jpt.render_frame(
            je.cfg, world, mats, lights, sky_state, cam, hist_cam,
            frame_idx, je.width, je.height, rs_cfg, trace_fn,
            prev_restir=prev_restir if rs_cfg.use_restir else None,
            light_remap=light_remap, entities=ent, atlas=atlas,
            shade_backend="xla", half_res_gi=rs.half_res_gi,
            block_highlight=rs.block_highlight)
    return jax.jit(run)


def variant_pair(variant, jax_patch=None):
    """(port G-buffers, JAX G-buffers) of `variant` from one state: a
    fresh JAX engine with initial reservoirs, carried to a port engine.
    jax_patch: a context manager in which the JAX side traces."""
    je = JEngine(settings=JSettings.from_dict(_settings().to_dict()),
                 backend="xla")
    assert je.settings.rendering.fused_shading
    je.restir_state = _commit(jrestir.initial_state(SIZE, SIZE))
    pe = interop.engine_from_jax(je, Engine(settings=_settings(),
                                            device="cpu"))
    with jax_patch or contextlib.nullcontext():
        jg, _ = variant_fn_call(je, variant)
    with ablate_pt.patched(variant):
        pg, _ = ablate_pt.variant_trace_fn(pe, variant)(
            *ablate_pt.trace_args(pe, pe.restir_state))
    return pg, jg


def variant_fn_call(je, variant):
    fn = jax_variant_fn(je, variant)
    return jax.block_until_ready(fn(
        je.world, je.materials, je.lights, je.sky_state, je.camera,
        je.history_camera, je.frame_index, je.restir_state, je._light_remap,
        je.entity_buffers(), je.texture_atlas))


def _frac_close(a, b, tol=1e-4):
    return np.mean(np.isclose(np.asarray(a), b, rtol=tol, atol=tol))


def gbuffers_match(pg, jg):
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


def variant_matches_jax(variant, jax_patch=None):
    pg, jg = variant_pair(variant, jax_patch)
    gbuffers_match(pg, jg)
    for i in range(3):
        assert _frac_close(jg.illum[i], pg.illum[i].numpy(), 1e-3) >= 0.985


def test_ablate_b1_matches_jax():
    variant_matches_jax("b1")
