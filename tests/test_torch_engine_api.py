"""The Engine's settings and offline calls of the port against the JAX
package's Engine:
* `apply_settings`: the states each edit resets (ReSTIR on a rendering
  edit, the denoiser history on a denoising edit, the sky through
  `set_sky`, the sizes on an output edit), and the trace parameters kept
  (an edit of max_trace_steps takes no effect, as in the reference);
* `set_sky`: the port's counterpart of tests/test_render.py
  test_set_sky_resets_restir_cache, and the rebuilt sky state against
  JAX's to 1e-5 relative (tests/test_torch_world.py's bar);
* `path_trace` / `render_accumulated` over 3 calls, each started from the
  JAX engine's state (the accumulation carried by interop): the display
  frames quantised to u8 under the whole-frame bars of
  tests/test_torch_fused_slice.py (mean |Δ| ≤ 1.0, ≥ 90% of pixels within
  3/255), the running mean's count equal; `reset_accumulation` and
  `set_render_scale` clearing it;
* `warm_light_variant_async`: None under the reference's conditions, and
  otherwise a thread that runs the lit variant and leaves every live
  state bit-identical;
* `set_ui_overlay`: the shape check and the clear.
"""
import numpy as np
import pytest
import torch

from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu.render.denoiser import initial_denoiser_state as jinit_dn
from rtvb_tpu.render.renderer import Engine as JEngine, _commit
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.assets import blocks as PB
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render import restir as prestir
from rtvb_tpu_torch.render import ris_kernel
from rtvb_tpu_torch.render.denoiser import initial_denoiser_state
from rtvb_tpu_torch.render.renderer import Engine

torch.set_num_threads(2)

SIZE = 32


def _settings(size=SIZE):
    return Settings().replace(rendering={"render_width": size,
                                         "render_height": size})


def _pair(settings):
    je = JEngine(settings=JSettings.from_dict(settings.to_dict()),
                 backend="xla")
    pe = Engine(settings=settings, device="cpu")
    return je, pe


def _fill_states(je, pe):
    """Non-None feedback states and accumulation on both engines."""
    je.restir_state = _commit(jrestir.initial_state(je.height, je.width))
    je.denoiser_state = _commit(jinit_dn(je.height, je.width))
    je._accum, je._accum_n = "a", 2
    pe.restir_state = prestir.initial_state(pe.height, pe.width)
    pe.denoiser_state = initial_denoiser_state(pe.height, pe.width)
    pe._accum, pe._accum_n = "a", 2


def _assert_same_sky(je, pe):
    assert pe.settings.to_dict()["sky"] == je.settings.to_dict()["sky"]
    cs = interop.sky(je.sky_state)
    for f in ("env_prob", "env_pmf", "basis_p", "basis_m", "sun_poly"):
        np.testing.assert_allclose(getattr(pe.sky_state, f).numpy(),
                                   getattr(cs, f).numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f)


def _assert_same_state(je, pe):
    assert pe.settings.to_dict() == je.settings.to_dict()
    assert (pe.width, pe.height, pe.out_width, pe.out_height,
            pe.render_scale) == (je.width, je.height, je.out_width,
                                 je.out_height, je.render_scale)
    for f in ("restir_state", "denoiser_state", "_accum"):
        assert (getattr(pe, f) is None) == (getattr(je, f) is None), f
    assert pe._accum_n == je._accum_n
    assert tuple(pe._tp) == tuple(int(v) for v in je._tp)
    _assert_same_sky(je, pe)


EDITS = {
    "unchanged": {},
    "denoising": dict(denoising={"pre_pass": True}),
    "post": dict(post_processing={"lens_flare": True}),
    "rendering": dict(rendering={"max_trace_steps": 64}),
    "sky": dict(sky={"time_of_day": 18.5, "model": "preetham"}),
    "output size": dict(rendering={"render_width": 48,
                                   "render_height": 40}),
}


@pytest.mark.parametrize("edit", list(EDITS))
def test_apply_settings_resets_as_jax(edit):
    je, pe = _pair(_settings(16))
    _fill_states(je, pe)
    new = pe.settings.replace(**EDITS[edit])
    je.apply_settings(JSettings.from_dict(new.to_dict()))
    pe.apply_settings(new)
    _assert_same_state(je, pe)
    if edit == "rendering":      # the reference keeps its trace params
        assert pe._tp.max_steps != 64
    if edit == "sky" and pe.restir_state is not None:
        np.testing.assert_array_equal(
            pe.restir_state.data.numpy(),
            interop.restir_state(je.restir_state).data.numpy())


def test_set_render_scale_clears_accumulation_as_jax():
    je, pe = _pair(_settings(48))
    for scale in (1.0, 0.5, 0.5):
        _fill_states(je, pe)
        je.set_render_scale(scale)
        pe.set_render_scale(scale)
        _assert_same_state(je, pe)


def test_set_sky_resets_restir_cache():
    """The port's counterpart of tests/test_render.py
    test_set_sky_resets_restir_cache, on a 64×64 frame."""
    eng = Engine(settings=_settings(64), device="cpu")
    eng.render_realtime()
    assert eng.restir_state is not None
    old_sun = float(eng.sky_state.sun_dir[1])
    eng.set_sky(time_of_day=18.5)
    assert float(eng.sky_state.sun_dir[1]) != old_sun
    m, _ = prestir.unpack2(eng.restir_state.data[4])
    assert float(m.max()) == 0.0
    assert torch.equal(eng.restir_state.data,
                       prestir.initial_state(64, 64).data)
    je = JEngine(settings=JSettings.from_dict(_settings(64).to_dict()))
    je.set_sky(time_of_day=18.5)
    _assert_same_sky(je, eng)


@pytest.fixture(scope="module")
def accumulated():
    """3 render_accumulated calls of the JAX engine; before each, a port
    engine holding the JAX engine's state."""
    je = JEngine(settings=JSettings.from_dict(_settings().to_dict()),
                 backend="xla")
    out = []
    for _ in range(3):
        pe = interop.engine_from_jax(je, Engine(settings=_settings(),
                                                device="cpu"))
        hist = tuple(c.clone() for c in pe.history_camera)
        ref = je.render_accumulated()
        got = pe.render_accumulated()
        # the history camera is a view of the engine's input buffer: its
        # values are what path_trace must keep
        kept = all(torch.equal(a, b)
                   for a, b in zip(hist, pe.history_camera))
        out.append(dict(ref=ref, got=got, n=(je._accum_n, pe._accum_n),
                        frame=(je.frame_index, pe.frame_index),
                        hist_kept=kept, port=pe))
    return je, out


@pytest.mark.parametrize("call", [0, 1, 2])
def test_render_accumulated_matches_jax(accumulated, call):
    _, out = accumulated
    c = out[call]
    assert c["n"] == (call + 1, call + 1)
    assert c["frame"][0] == c["frame"][1]
    assert c["hist_kept"]             # path_trace keeps the history camera
    assert c["got"].shape == c["ref"].shape == (SIZE, SIZE, 3)
    q = lambda a: (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)
    d = np.abs(q(c["got"]) - q(np.asarray(c["ref"])))
    mean_d, frac3 = d.mean(), np.mean(d.max(axis=-1) <= 3)
    print(f"render_accumulated call {call + 1}: mean |d| {mean_d:.4f}, "
          f"pixels within 3/255 {frac3:.4f}")
    assert mean_d <= 1.0
    assert frac3 >= 0.90


def test_reset_accumulation_as_jax(accumulated):
    je, out = accumulated
    pe = out[-1]["port"]
    assert pe._accum is not None and je._accum is not None
    je.reset_accumulation()
    pe.reset_accumulation()
    assert (pe._accum, pe._accum_n) == (je._accum, je._accum_n) == (None, 0)
    pe.render_accumulated()
    assert pe._accum_n == 1


def test_warm_light_variant_returns_none_as_jax():
    je, pe = _pair(_settings(16))
    # not rendered yet: no reservoirs
    assert je.warm_light_variant_async() is None
    assert pe.warm_light_variant_async() is None
    # the variant already live: a light in the world
    _fill_states(je, pe)
    je.set_block(32, 20, 32, je.block_registry.emissive_ids[0])
    pe.set_block(32, 20, 32, pe.block_registry.emissive_ids[0])
    assert pe._n_local == je._n_local > 0
    assert je.warm_light_variant_async() is None
    assert pe.warm_light_variant_async() is None


def _snapshot(eng):
    t = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
    return dict(restir=eng.restir_state.data.clone(),
                denoiser={f: t(getattr(eng.denoiser_state, f))
                          for f in eng.denoiser_state._fields},
                exposure=eng.post_state.exposure.clone(),
                frame=eng.frame_index, remap=eng._light_remap.clone(),
                camera=tuple(c.clone() for c in eng.camera),
                hist=tuple(c.clone() for c in eng.history_camera),
                lights=eng.lights.key.clone())


def test_warm_light_variant_leaves_live_states():
    eng = Engine(settings=_settings(), device="cpu")
    eng.render_realtime()
    before = _snapshot(eng)
    seen = []
    orig = ris_kernel.fused_shade

    def spy(cfg, *a, **kw):
        seen.append(cfg.n_local)
        return orig(cfg, *a, **kw)
    ris_kernel.fused_shade = spy
    try:
        t = eng.warm_light_variant_async()
        assert t is not None
        t.join(timeout=600)
    finally:
        ris_kernel.fused_shade = orig
    assert not t.is_alive()
    # the lit variant ran: 8 candidates at bounce 0, 2 at bounces 1-2
    assert seen == [8, 2, 2]
    after = _snapshot(eng)
    for k, v in before.items():
        if k == "denoiser":
            for f, x in v.items():
                y = after[k][f]
                assert torch.equal(x, y) if isinstance(x, torch.Tensor) \
                    else x == y, f
        elif isinstance(v, torch.Tensor):
            assert torch.equal(v, after[k]), k
        elif k in ("camera", "hist"):
            assert all(torch.equal(a, b) for a, b in zip(v, after[k])), k
        else:
            assert v == after[k], k
    # then the first lit frame renders
    eng.set_block(32, 20, 32, PB.LANTERN)
    assert eng._n_local == 8
    assert eng.render_realtime().shape == (SIZE, SIZE, 3)


def test_set_ui_overlay():
    eng = Engine(settings=_settings(16), device="cpu")
    ov = np.zeros((16, 16, 4), np.uint8)
    ov[2:5, 3:9] = (255, 0, 0, 255)
    eng.set_ui_overlay(ov)
    assert torch.equal(eng._ui_overlay, torch.from_numpy(ov))
    u8 = eng.render_realtime()
    assert (u8[2:5, 3:9] == (255, 0, 0)).all()
    with pytest.raises(ValueError):
        eng.set_ui_overlay(np.zeros((8, 16, 4), np.uint8))
    eng.set_ui_overlay(None)
    assert int(eng._ui_overlay.abs().sum()) == 0
