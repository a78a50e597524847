"""The port's EASU upscale (`ops/easu_kernel.easu_plain`, K7's plain
version) and the post pipeline's other upscale modes against the JAX
package, on random [0, 1) images made with numpy.

Bars:
* (a) against the XLA twin `postprocess.easu(force_generic=True)` at 2:1,
  3:2, 4:3 and a mixed per-axis ratio, every pixel, borders included:
  |Δ| ≤ max(2e-4, 1e-5 / |dir|), |dir| the length of the blended
  direction field at the pixel.  The twin's source fractions are f32
  positions at output-index magnitude (up to 6e-6 off the exact rationals
  at 214→320), and XLA contracts the field blend into FMAs; where the
  blended gradient nearly cancels, the kernel's direction turns by
  |δdir| / |dir|, so the difference grows as 1/|dir|: max |Δ|·|dir| is
  4.6e-6 over 8 random images at 3:2 and the mixed ratio, 1.8e-7 at 2:1
  and 4:3.  Where |dir| ≥ 0.05 (nearly every pixel) the bar is 2e-4;
* (b) against `easu()` at 2:1 (the `_easu_2x` specialisation): 1e-5;
* (c) against the Pallas kernel itself, run in interpret mode: 1e-5 on all
  but the first and last output row and column.  The kernel builds the
  direction field from its edge-padded window, the twin (and the port)
  from edge-clamped neighbours at input resolution, so the border
  differs by up to 0.063 (printed);
* (d) Catmull-Rom bicubic: 1e-5; the whole post pipeline in each upscale
  mode at a rung's internal size whose height is 2 mod 4 (the crop of
  auto-exposure and the edge pad of bloom run): 1e-4 (XLA's and torch's
  exp2 / pow differ in the last bit, and RCAS sharpen's
  sqrt(min / max) amplifies that near dark texels: 1.3e-5 measured).
"""
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.core.config import PostProcessingSettings as JPost
from rtvb_tpu.core.config import ToneMappingSettings as JTone
from rtvb_tpu.ops import easu_kernel as jek
from rtvb_tpu.render import postprocess as jpp
from rtvb_tpu_torch.core.config import PostProcessingSettings, \
    ToneMappingSettings
from rtvb_tpu_torch.ops.easu_kernel import direction_field, easu_plain, \
    source_axis
from rtvb_tpu_torch.render import postprocess as ppp

torch.set_num_threads(2)

# (in_h, in_w, out_h, out_w): 2:1, 3:2, 4:3 and 2/3 of 320×180 (214×120)
RATIOS = {"2:1": (16, 256, 32, 512), "3:2": (32, 256, 48, 384),
          "4:3": (24, 384, 32, 512), "mixed": (120, 214, 180, 320)}


def _img(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


def _plain(img, oh, ow):
    return easu_plain(torch.from_numpy(img), oh, ow).numpy()


def _dir_length(img, oh, ow):
    """|(dirx, diry)| of the field blended at each output sample."""
    t = torch.from_numpy(img)
    H, W = img.shape[:2]
    by, fy = source_axis(oh, H)
    bx, fx = source_axis(ow, W)
    fy, fx = fy[:, None], fx[None, :]

    def tap(p, dy, dx):
        return p.index_select(0, torch.clamp(by + dy, 0, H - 1)) \
            .index_select(1, torch.clamp(bx + dx, 0, W - 1))
    dirx, diry = (tap(f, 0, 0) * (1 - fx) * (1 - fy)
                  + tap(f, 0, 1) * fx * (1 - fy)
                  + tap(f, 1, 0) * (1 - fx) * fy + tap(f, 1, 1) * fx * fy
                  for f in direction_field(t)[:2])
    return torch.sqrt(dirx * dirx + diry * diry).numpy()


@pytest.mark.parametrize("ratio", list(RATIOS))
def test_easu_plain_matches_generic_twin(ratio):
    h, w, oh, ow = RATIOS[ratio]
    img = _img(h, w)
    twin = jax.jit(functools.partial(jpp.easu, out_h=oh, out_w=ow,
                                     force_generic=True))
    d = np.abs(_plain(img, oh, ow) - np.asarray(twin(img))).max(-1)
    length = _dir_length(img, oh, ow)
    print(f"{ratio}: max |d| against the twin {d.max():.3g}, max "
          f"|d|*|dir| {(d * length).max():.3g}, pixels over 2e-4 "
          f"{int((d > 2e-4).sum())} of {d.size}")
    assert (d <= np.maximum(2e-4, 1e-5 / np.maximum(length, 1e-30))).all()
    assert d[length >= 0.05].max() <= 2e-4


def test_easu_plain_matches_2x_specialisation():
    h, w, oh, ow = RATIOS["2:1"]
    img = _img(h, w, seed=1)
    ref = jax.jit(functools.partial(jpp.easu, out_h=oh, out_w=ow))(img)
    assert np.abs(_plain(img, oh, ow) - np.asarray(ref)).max() <= 1e-5


@pytest.mark.parametrize("ratio", ["2:1", "3:2", "4:3"])
def test_easu_plain_matches_interpreted_pallas_kernel(ratio, monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    h, w, oh, ow = RATIOS[ratio]
    img = _img(h, w, seed=2)
    k = np.asarray(jek.easu_tpu(jnp.asarray(img), oh, ow))
    d = np.abs(_plain(img, oh, ow) - k)
    print(f"{ratio}: interior max |d| {d[1:-1, 1:-1].max():.3g}, border "
          f"max |d| {d.max():.3g} (the TPU kernel's padded-window field)")
    assert d[1:-1, 1:-1].max() <= 1e-5


@pytest.mark.parametrize("out_size,in_size", [(32, 16), (48, 32), (32, 24),
                                              (320, 214), (1080, 540)])
def test_source_axis_is_exact(out_size, in_size):
    """base = floor(pos) exactly, frac = f32(rem)·f32(1/den), within one
    f32 rounding of the exact fraction pos − base."""
    base, frac = source_axis(out_size, in_size)
    den = 2 * out_size
    for o in range(out_size):
        pos = Fraction((2 * o + 1) * in_size - out_size, den)
        b = pos.numerator // pos.denominator
        assert int(base[o]) == b
        rem = (2 * o + 1) * in_size - out_size - b * den
        assert float(frac[o]) == float(np.float32(rem)
                                       * np.float32(1.0 / den))
        assert abs(float(frac[o]) - float(pos - b)) <= 2.0 ** -24


@pytest.mark.parametrize("axis", [0, 1])
def test_catmull_rom_matches_jax(axis):
    img = _img(24, 40, seed=3)
    out = (36, 60)[axis]
    ref = np.asarray(jax.jit(functools.partial(
        jpp._catmull_rom_1d, out_size=out, axis=axis))(img))
    got = ppp._catmull_rom_1d(torch.from_numpy(img), out, axis).numpy()
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("mode", ["easu", "bicubic", "none"])
def test_post_run_at_a_rung_matches_jax(mode):
    """postprocess.run on a 162×288 HDR frame (the 3/4 rung of 384×216,
    height 2 mod 4) to 216×384; "none" keeps the internal size."""
    h, w, oh, ow = 162, 288, 216, 384
    rgb = (np.random.default_rng(4).random((h, w, 3), dtype=np.float32)
           ** 4 * 8.0).astype(np.float32)
    pp = PostProcessingSettings(upscale=mode)
    tm = ToneMappingSettings()
    jout, jstate = jax.jit(
        lambda x: jpp.run(x, jpp.initial_post_state(), JPost(upscale=mode),
                          JTone(), 1.0 / 60.0, oh, ow))(rgb)
    out, state = ppp.run(torch.from_numpy(rgb), ppp.initial_post_state(), pp,
                         tm, 1.0 / 60.0, oh, ow)
    want = (h, w, 3) if mode == "none" else (oh, ow, 3)
    assert tuple(out.shape) == want == np.asarray(jout).shape
    assert abs(float(state.exposure) - float(jstate.exposure)) <= 1e-5
    d = np.abs(out.numpy() - np.asarray(jout)).max()
    print(f"post run, upscale {mode}: max |d| {d:.3g}")
    assert d <= 1e-4
