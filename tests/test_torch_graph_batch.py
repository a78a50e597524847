"""The batched frame and the frame's capture-safe parts, on the CPU.

`Engine.render_realtime_device_batch(nb)` of the port against nb
sequential `_eager_frame`s, bit for bit, with the history-camera rule and
one light remap for every frame of the batch (the JAX package's
`_frame_batch_fn`, `rtvb_tpu/render/renderer.py:620-680`, and
`tests/test_render.py:258`); the engine's state after it as the JAX
package leaves it.  Then the pieces that now take the frame from device
memory, each against the JAX package: the RNG with tensor frames (frames
0-300, bit for bit), the ReSTIR tap offsets and shifted planes (frame
indices 0-9, bit for bit), the denoiser's bootstrap as a device bool
(`_denoise_jit`, frames 1 and 2: the states to 1e-5, the filtered frame
to 1e-5 on 99.9% of its values), the 64-bin histogram against
`torch.bincount`, and the port's flythrough path on an engine.  No JAX
whole frame is compiled here."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.core.camera import make_camera as jmake_camera
from rtvb_tpu.core.config import DenoisingSettings as JDenoising
from rtvb_tpu.ops import rng as jrng
from rtvb_tpu.render import denoiser as jden
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu.render.pathtracer import GBuffers as JG
from rtvb_tpu.utils import flypath as jfly

from rtvb_tpu_torch.assets import blocks as PB
from rtvb_tpu_torch.core.config import DenoisingSettings, Settings
from rtvb_tpu_torch.ops import rng as prng
from rtvb_tpu_torch.render import denoiser as pden
from rtvb_tpu_torch.render import postprocess as ppost
from rtvb_tpu_torch.render import restir as prestir
from rtvb_tpu_torch.render.pathtracer import GBuffers as PG
from rtvb_tpu_torch.render.renderer import Engine
from rtvb_tpu_torch.utils import flypath as pfly

SIZE = 64


@pytest.fixture(scope="module")
def rendered():
    """A 64×64 engine with the shipped settings after one frame (its
    states hold a real frame: the denoiser is bootstrapped)."""
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": SIZE, "render_height": SIZE}), device="cpu")
    eng.render_realtime_device()
    return eng


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _states_equal(a, b):
    assert torch.equal(_bits(a.restir_state.data), _bits(b.restir_state.data))
    for f in pden.DenoiserState._fields:
        assert torch.equal(_bits(getattr(a.denoiser_state, f)),
                           _bits(getattr(b.denoiser_state, f))), f
    assert torch.equal(_bits(a.post_state.exposure),
                       _bits(b.post_state.exposure))
    assert a.frame_index == b.frame_index


def test_batch_equals_sequential_frames(rendered):
    eng = copy.copy(rendered)
    assert eng.restir_state.data is not rendered.restir_state.data
    eng.set_camera(pos=(33.0, 18.5, 9.0), yaw=1.15)  # history ≠ camera
    ref, same_hist = copy.copy(eng), copy.copy(eng)
    out = eng.render_realtime_device_batch(2)
    seq = [ref._eager_frame(), ref._eager_frame()]
    assert out.shape == (2, SIZE, SIZE, 3) and out.dtype == torch.uint8
    for k in range(2):
        assert torch.equal(out[k], seq[k]), k
    _states_equal(eng, ref)
    # the rule mattered: frame 0 against the history camera
    same_hist.set_camera(keep_history=False)
    assert not torch.equal(same_hist._eager_frame(), seq[0])


def test_batch_leaves_the_engine_as_jax(rendered):
    """After a batch the frame index has grown by nb, the history camera
    is the camera and the remap is the identity; every frame of the
    batch took the edit's remap (the JAX package's caveat)."""
    eng = copy.copy(rendered)
    x, z = 33, 11
    h = int(eng.world.blocks[x, :, z].nonzero().max())
    remap = eng.set_block(x, h + 1, z, PB.LANTERN)
    assert eng._light_remap is remap and (remap < 0).all()
    ref = copy.copy(eng)
    f0 = eng.frame_index
    out = eng.render_realtime_device_batch(2)
    first = ref._eager_frame()
    ref._light_remap = remap             # the batch's second frame's remap
    second = ref._eager_frame()
    assert torch.equal(out[0], first) and torch.equal(out[1], second)
    _states_equal(eng, ref)
    assert eng.frame_index == f0 + 2
    for a, b in zip(eng.history_camera, eng.camera):
        assert torch.equal(a, b)
    assert torch.equal(eng._light_remap,
                       torch.arange(eng.lights.key.shape[0],
                                    dtype=torch.int32))
    assert eng._light_remap is eng._identity_remap()


def test_flythrough_moves_the_engine_as_jax(rendered):
    """The port's apply_flythrough on an engine against the JAX one on a
    stand-in of the JAX engine's camera calls: the same cameras, to the
    bit, at every step."""
    eng = copy.copy(rendered)

    class JCam:
        camera = jmake_camera(pos=eng.scene.camera_pos,
                              yaw=eng.scene.camera_yaw,
                              pitch=eng.scene.camera_pitch,
                              aspect=eng.out_width / eng.out_height)

        def set_camera(self, pos=None, yaw=None, pitch=None):
            c = self.camera
            self.camera = jmake_camera(
                pos=pos, yaw=yaw,
                pitch=float(c.pitch) if pitch is None else pitch,
                aspect=eng.out_width / eng.out_height)
    jc = JCam()
    p0 = y0 = q0 = z0 = None
    for i in range(6):
        p0, y0 = pfly.apply_flythrough(eng, i, 6, p0, y0)
        q0, z0 = jfly.apply_flythrough(jc, i, 6, q0, z0)
        assert (p0, y0) == (q0, z0)
        for f, a in zip(jc.camera._fields, eng.camera):
            assert np.float32(a) == np.float32(getattr(jc.camera, f)), f


FRAMES = np.arange(301, dtype=np.uint32)
DIMS = tuple(range(0, 256, 5)) + (255,)


def _jax_rng(bn, px, py):
    def one(f):
        sob = jnp.stack([jrng.bn_sobol_scalar(f, d) for d in DIMS])
        term = jnp.stack([jrng.to_unit_float_scalar(
            jrng.bn_sobol_scalar(f, d)) for d in DIMS])
        rs = jrng.RandState(px, py, f, 8, bn=bn)
        draws = jnp.stack([rs.next() for _ in range(20)])
        ws = jrng.RandState(px, py, f, 72)
        white = jnp.stack([ws.next() for _ in range(6)])
        r = jnp.stack([jrng.rand(px, py, f, d) for d in (0, 1, 7)])
        return sob, term, draws, white, r
    return jax.jit(jax.vmap(one))(jnp.asarray(FRAMES))


def test_rng_tensor_frames_match_jax():
    H, W = 6, 10
    px = np.broadcast_to(np.arange(W, dtype=np.uint32)[None], (H, W))
    py = np.broadcast_to(np.arange(H, dtype=np.uint32)[:, None] + 5, (H, W))
    ref = [np.asarray(a) for a in _jax_rng(
        jrng.bn_packed(H, W), jnp.asarray(px), jnp.asarray(py))]
    bn = prng.bn_packed(H, W)
    tpx = torch.from_numpy(px.astype(np.int64))
    tpy = torch.from_numpy(py.astype(np.int64))
    for i, f in enumerate(FRAMES):
        frame = torch.tensor(int(f), dtype=torch.int64)
        sob = [int(prng.bn_sobol_scalar(frame, d)) for d in DIMS]
        assert sob == ref[0][i].tolist(), f
        terms = prng.bn_sobol_terms(frame)[list(DIMS)]
        assert np.array_equal(terms.numpy().view(np.int32),
                              ref[1][i].view(np.int32)), f
        rs = prng.RandState(tpx, tpy, frame, 8, bn=bn)
        draws = torch.stack([rs.next() for _ in range(20)])
        assert np.array_equal(draws.numpy().view(np.int32),
                              ref[2][i].view(np.int32)), f
        ws = prng.RandState(tpx, tpy, frame, 72)
        white = torch.stack([ws.next() for _ in range(6)])
        assert np.array_equal(white.numpy().view(np.int32),
                              ref[3][i].view(np.int32)), f
        r = torch.stack([prng.rand(tpx, tpy, frame, d) for d in (0, 1, 7)])
        assert np.array_equal(r.numpy().view(np.int32),
                              ref[4][i].view(np.int32)), f


def test_restir_tap_offsets_match_jax():
    H, W, n_taps = 24, 32, 6
    g = np.random.default_rng(3)
    data = g.normal(size=(8, H, W)).astype(np.float32)
    mu = g.uniform(-0.04, 0.04, (H, W)).astype(np.float32)
    mv = g.uniform(-0.04, 0.04, (H, W)).astype(np.float32)
    mu[::5, ::3] = 2.0                        # out of the screen
    taps_j = jax.jit(lambda d, u, v, f: jrestir.warp_taps(
        jrestir.ReSTIRState(data=d), u, v, f, n_taps))
    prev = prestir.ReSTIRState(data=torch.from_numpy(data))
    tu, tv = torch.from_numpy(mu), torch.from_numpy(mv)
    moved = set()
    for f in range(10):
        ref = taps_j(jnp.asarray(data), jnp.asarray(mu), jnp.asarray(mv),
                     jnp.int32(f))
        got = prestir.warp_taps(prev, tu, tv,
                                torch.tensor(f, dtype=torch.int64), n_taps)
        assert len(got) == len(ref) == n_taps
        for t, ((pp, pv), (jp, jv)) in enumerate(zip(got, ref)):
            assert np.array_equal(pp.numpy().view(np.int32),
                                  np.asarray(jp).view(np.int32)), (f, t)
            assert np.array_equal(pv.numpy(), np.asarray(jv)), (f, t)
        offs = [int(o) for o in prestir.tap_offsets(
            torch.tensor(f, dtype=torch.int64), n_taps)]
        assert all(-2 <= o <= 2 for o in offs)
        moved.add(tuple(offs))
    assert len(moved) > 1                     # the offsets follow the frame


def _gbuffers(seed, H, W):
    g = np.random.default_rng(seed)
    f32 = lambda *s: g.uniform(size=s).astype(np.float32)
    depth = (2.0 + 30.0 * f32(H, W)).astype(np.float32)
    depth[:3, :5] = 1e30                      # sky pixels
    n = g.normal(size=(3, H, W)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    planes = dict(illum=tuple(g.gamma(1.0, 0.5, (3, H, W)).astype(np.float32)),
                  albedo=tuple(0.1 + 0.9 * f32(3, H, W)), normal=tuple(n),
                  depth=depth, roughness=f32(H, W),
                  motion_u=((f32(H, W) - 0.5) * 0.02).astype(np.float32),
                  motion_v=((f32(H, W) - 0.5) * 0.02).astype(np.float32),
                  emissive_first=(depth >= 1e30))
    conv = lambda a, fn: tuple(fn(x) for x in a) if isinstance(a, tuple) \
        else fn(a)
    return (JG(**{k: conv(v, jnp.asarray) for k, v in planes.items()}),
            PG(**{k: conv(v, lambda x: torch.from_numpy(np.array(x)))
                  for k, v in planes.items()}))


def test_denoiser_bootstrap_matches_jax():
    H, W = 32, 32
    jcfg, pcfg = JDenoising(), DenoisingSettings()
    js = jden.initial_denoiser_state(H, W)
    ps = pden.initial_denoiser_state(H, W)
    assert ps.bootstrapped.dtype == torch.bool and not bool(ps.bootstrapped)
    for frame in range(2):
        jg, pg = _gbuffers(frame, H, W)
        jrgb, js = jden._denoise_jit(jg, js, jcfg)
        prgb, ps = pden.denoise_frame(pg, ps, pcfg)
        # the states the bootstrap selects: to 1e-5
        for f in ("slow", "fast", "moments", "hist_len", "prev_depth",
                  "prev_normal"):
            np.testing.assert_allclose(getattr(ps, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        # the filtered frame after four chained à-trous steps (each held to
        # 1e-5 in test_torch_atrous.py): a few edge-stopping weights of
        # random G-buffers sit where XLA's FMA contraction moves them
        a, b = prgb.numpy(), np.asarray(jrgb)
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert close.mean() >= 0.999, close.mean()
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
        assert bool(ps.bootstrapped) == bool(js.bootstrapped) is True
        if frame == 0:       # the bootstrap: the history is this frame
            assert torch.equal(ps.hist_len, torch.ones(H, W))


def test_histogram_matches_bincount():
    g = torch.Generator().manual_seed(7)
    bins = torch.randint(0, 64, (270, 480), generator=g, dtype=torch.int32)
    bins[0, :7] = 0
    bins[1, :3] = 63
    bins[2:40] = 17                           # a heavy bin
    got = ppost.histogram(bins, 64)
    want = torch.bincount(bins.reshape(-1).long(), minlength=64).to(
        torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    empty = ppost.histogram(torch.zeros((0,), dtype=torch.int32), 64)
    assert torch.equal(empty, torch.zeros(64))
