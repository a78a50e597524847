"""The dev panel's settings that the port now runs, against the JAX
package, each on inputs made from a numpy seed:
* `passes.pre_pass`, `postprocess.lens_flare` (even and odd sizes: h // 4
  and (3h) // 8 are offsets), `draw_crosshair`, and `postprocess.run`
  with the block highlight and the UI overlay, native and at the 2/3
  rung: to 1e-5 relative, 1e-6 absolute (the JAX side runs op by op under
  jax.disable_jit, so neither side fuses multiply-adds; transcendentals
  may differ in the last bit);
* the Preetham sky at three times of day: the fit equal from the same
  sun, `make_sky_state` to 1e-5 relative (its radiance to 1e-4: reason
  at the test);
* `pathtracer._picked_face_edges` on the same traced primary hits: the
  mask equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.core.config import PostProcessingSettings as JPost
from rtvb_tpu.core.config import SkySettings as JSky
from rtvb_tpu.core.config import ToneMappingSettings as JTone
from rtvb_tpu.core.camera import camera_rays as jcamera_rays
from rtvb_tpu.core.camera import make_camera as jmake_camera
from rtvb_tpu.ops import dda as jdda
from rtvb_tpu.ops.denoise import passes as jpasses
from rtvb_tpu.render import pathtracer as jpt
from rtvb_tpu.render import postprocess as jpp
from rtvb_tpu.render import sky as jsky
from rtvb_tpu.world import gen as jgen
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.core.config import PostProcessingSettings
from rtvb_tpu_torch.core.config import SkySettings
from rtvb_tpu_torch.core.config import ToneMappingSettings
from rtvb_tpu_torch.ops.dda import HitRecord
from rtvb_tpu_torch.ops.denoise import passes as ppasses
from rtvb_tpu_torch.render import pathtracer as ppt
from rtvb_tpu_torch.render import postprocess as ppp
from rtvb_tpu_torch.render import sky as psky

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
BIG = 1e30


def _hdr(rng, h, w):
    """A linear HDR frame with a few very bright pixels (flare sources)."""
    img = rng.gamma(1.0, 0.4, (h, w, 3)).astype(np.float32)
    hot = rng.random((h, w)) < 0.02
    img[hot] *= 200.0
    return img


def _guides(rng, h, w):
    depth = rng.uniform(2.0, 40.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = BIG          # sky pixels
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    # patches of one normal, so neighbours pass the normal test
    normal[:, : w // 2] = np.array([0.0, 1.0, 0.0], np.float32)
    return depth, normal


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(40, 56), (37, 61)])
def test_pre_pass_matches_jax(shape):
    rng = np.random.default_rng(11)
    h, w = shape
    illum = _hdr(rng, h, w)
    depth, normal = _guides(rng, h, w)
    with jax.disable_jit():
        ref = jpasses.pre_pass(jnp.asarray(illum), jnp.asarray(depth),
                               jnp.asarray(normal))
    out = ppasses.pre_pass(torch.from_numpy(illum), torch.from_numpy(depth),
                           torch.from_numpy(normal))
    _close(out, ref)


@pytest.mark.parametrize("shape", [(48, 64), (37, 61), (9, 7)])
def test_lens_flare_matches_jax(shape):
    rng = np.random.default_rng(12)
    img = _hdr(rng, *shape)
    src = torch.from_numpy(img.copy())
    with jax.disable_jit():
        ref = jpp.lens_flare(jnp.asarray(img), JPost(lens_flare=True))
    out = ppp.lens_flare(src, PostProcessingSettings(lens_flare=True))
    _close(out, ref)
    assert np.array_equal(src.numpy(), img)        # the input is not written


@pytest.mark.parametrize("shape", [(48, 64), (37, 61)])
def test_draw_crosshair_matches_jax(shape):
    img = np.random.default_rng(13).random(shape + (3,)).astype(np.float32)
    src = torch.from_numpy(img.copy())
    ref = np.asarray(jpp.draw_crosshair(jnp.asarray(img)))
    out = ppp.draw_crosshair(src)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.array_equal(src.numpy(), img)


@pytest.mark.parametrize("case", ["native", "rung_2_3"])
def test_post_run_with_highlight_and_overlay_matches_jax(case):
    """postprocess.run with every dev-panel post setting on, the highlight
    mask and a half-transparent overlay: the highlight is forced white
    before the upscale, the crosshair and overlay after it."""
    rng = np.random.default_rng(14)
    h, w = 32, 48
    out_h, out_w = (h, w) if case == "native" else (48, 72)
    img = _hdr(rng, h, w)
    hl = (rng.random((h, w)) < 0.05).astype(np.float32)
    ov = np.zeros((out_h, out_w, 4), np.uint8)
    ov[4:12, 6:30] = (255, 40, 0, 128)
    ov[20:22, :] = (0, 0, 255, 255)
    kw = dict(lens_flare=True, crosshair=True)
    with jax.disable_jit():
        ref, rstate = jpp.run(jnp.asarray(img), jpp.initial_post_state(),
                              JPost(**kw), JTone(), 1.0 / 60.0, out_h, out_w,
                              overlay_u8=jnp.asarray(ov),
                              highlight=jnp.asarray(hl))
    out, state = ppp.run(torch.from_numpy(img), ppp.initial_post_state(),
                         PostProcessingSettings(**kw), ToneMappingSettings(),
                         1.0 / 60.0, out_h, out_w,
                         overlay_u8=torch.from_numpy(ov),
                         highlight=torch.from_numpy(hl))
    assert tuple(out.shape) == (out_h, out_w, 3)
    _close(state.exposure, rstate.exposure)
    # EASU's direction grows as 1/|dir| where the luma gradient cancels
    # (tests/test_torch_easu.py): the rung case takes that file's 2e-4
    tol = TOL if case == "native" else dict(rtol=0.0, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    if case == "native":       # highlighted pixels are white, under ov
        hit = (hl > 0) & (ov[..., 3] == 0)
        np.testing.assert_array_equal(out.numpy()[hit], 1.0)


@pytest.mark.parametrize("time_of_day", [7.0, 12.0, 17.5])
def test_preetham_fit_matches_jax(time_of_day):
    """_fit_sky_basis for model "preetham" from the same sun direction:
    the same float64 numpy on both sides, so equal."""
    js = JSky(model="preetham", time_of_day=time_of_day)
    sun = np.array([float(v) for v in jsky.sun_direction(
        jnp.float32(time_of_day), jnp.float32(js.sun_axis_angle))])
    ref = jsky._fit_sky_basis(js, sun)
    out = psky._fit_sky_basis(SkySettings(model="preetham",
                                          time_of_day=time_of_day), sun)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the Preetham sun is a degree-1 limb polynomial
    assert float(np.abs(out[2][2:]).max()) == 0.0


@pytest.mark.parametrize("time_of_day", [7.0, 12.0, 17.5])
def test_preetham_sky_state_matches_jax(time_of_day):
    """make_sky_state with model "preetham": the scalars equal, the tables
    to 1e-5 relative as tests/test_torch_world.py holds the Hosek sky.
    The sun direction may differ in its last bit (torch's and XLA's cos;
    it does at 7.0), which the least squares amplify to ~5e-4 relative in
    single basis coefficients: the coefficients are held through the sky
    radiance they give, to 1e-4 relative (measured 1.8e-5)."""
    js = jsky.make_sky_state(JSky(model="preetham", time_of_day=time_of_day))
    ps = psky.make_sky_state(SkySettings(model="preetham",
                                         time_of_day=time_of_day))
    cs = interop.sky(js)
    for f in ("turbidity", "sky_intensity", "sun_intensity",
              "cos_sun_radius", "env_alias"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      getattr(cs, f).numpy(), err_msg=f)
    for f in ("env_prob", "env_pmf", "basis_p", "sun_poly"):
        np.testing.assert_allclose(getattr(ps, f).numpy(),
                                   getattr(cs, f).numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose([float(v) for v in ps.sun_dir],
                               [float(v) for v in cs.sun_dir], rtol=1e-6)
    d = np.random.default_rng(15).normal(size=(3, 64, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dirs = tuple(torch.from_numpy(c) for c in d)
    for a, b in zip(psky.sky_radiance(dirs, ps), psky.sky_radiance(dirs, cs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-7)
    hosek = psky.make_sky_state(SkySettings(time_of_day=time_of_day))
    assert not torch.allclose(ps.basis_m, hosek.basis_m)


@pytest.mark.parametrize("pose", [((32.0, 14.0, 8.0), 1.1, -0.9),
                                  ((10.3, 9.5, 20.4), 0.0, -0.15)])
def test_picked_face_edges_matches_jax(pose):
    """The highlight mask from the same voxel hits: the centre pixel's hit
    is the pick; JAX's trace carried across to the port's record."""
    h, w = 45, 64
    cfg, world = jgen.generate_world()
    pos, yaw, pitch = pose
    cam = jmake_camera(pos=pos, yaw=yaw, pitch=pitch, aspect=w / h)
    tp = jdda.TraceParams(x=cfg.x, y=cfg.y, z=cfg.z,
                          super_size=cfg.super_size, super_z=cfg.super_z,
                          max_steps=cfg.x + cfg.z + 8)

    @jax.jit
    def primary():
        o, d = jcamera_rays(cam, w, h)
        rec = jdda.trace(o, d, world.colmask, world.df_super[0], tp,
                         maxh_row=world.maxh_super[0])
        p = tuple(oc + dc * rec.t for oc, dc in zip(o, d))
        return rec, p
    rec, p = primary()
    assert bool(rec.hit[h // 2, w // 2]) and float(rec.t[h // 2, w // 2]) < 8
    spread = float(cam.pixel_cone_spread(h))
    with jax.disable_jit():
        ref = jpt._picked_face_edges(rec, p, rec.t, rec.hit, spread, h, w)
    T = lambda a: torch.from_numpy(np.array(a))
    prec = HitRecord(hit=T(rec.hit), t=T(rec.t), ix=T(rec.ix), iy=T(rec.iy),
                     iz=T(rec.iz), nx=T(rec.nx), ny=T(rec.ny), nz=T(rec.nz),
                     mi=None)
    out = ppt._picked_face_edges(prec, tuple(T(c) for c in p), prec.t,
                                 prec.hit, torch.tensor(spread), h, w)
    ref = np.asarray(ref)
    assert ref.sum() > 20            # the face's outline is drawn
    np.testing.assert_array_equal(out.numpy(), ref)
