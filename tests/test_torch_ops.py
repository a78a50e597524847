"""Parity of the port's elementwise base (rtvb_tpu_torch.ops) with the JAX
package: RNG and bit packing bit-exact, BSDF to 1e-5, camera to 1e-6.

Inputs are made with numpy from fixed seeds and fed to both sides.  The JAX
float references run op by op (jax.disable_jit) so neither side fuses
multiply-adds; what remains is the last-bit difference of XLA's rsqrt,
which the GGX peak of near-mirror lobes amplifies (see the BSDF test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.core import camera as jcam
from rtvb_tpu.ops import bsdf as jB
from rtvb_tpu.ops import pack as jpack
from rtvb_tpu.ops import rng as jrng
from rtvb_tpu_torch.core import camera as pcam
from rtvb_tpu_torch.ops import bsdf as pB
from rtvb_tpu_torch.ops import pack as ppack
from rtvb_tpu_torch.ops import rng as prng

torch.set_num_threads(2)


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def test_pcg_hash_and_unit_float_bit_exact():
    x = _u32(np.random.default_rng(0), (4096,))
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    jh = np.asarray(jrng.pcg_hash(jnp.asarray(x)))
    ph = prng.pcg_hash(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(ph.numpy().astype(np.uint32), jh)
    ju = np.asarray(jrng.to_unit_float(jnp.asarray(x)))
    pu = prng.to_unit_float(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(_bits(pu), ju.view(np.uint32))


@pytest.mark.parametrize("blue_noise", [False, True])
def test_rand_state_stream_bit_exact(blue_noise):
    H, W, frame = 24, 40, 77
    py, px = np.mgrid[0:H, 0:W].astype(np.uint32)
    jbn = jrng.bn_packed(H, W) if blue_noise else None
    pbn = prng.bn_packed(H, W) if blue_noise else None
    js = jrng.RandState(jnp.asarray(px), jnp.asarray(py),
                        jnp.uint32(frame), 5, bn=jbn)
    ps = prng.RandState(torch.from_numpy(px.astype(np.int64)),
                        torch.from_numpy(py.astype(np.int64)), frame, 5,
                        bn=pbn)
    for _ in range(20):
        a = np.asarray(js.next())
        b = ps.next()
        np.testing.assert_array_equal(_bits(b), a.view(np.uint32))


def test_bn_draw_half_res_planes_bit_exact():
    frame = 300
    jbn = jrng.bn_packed(12, 20, 0, step=2)
    pbn = prng.bn_packed(12, 20, 0, step=2)
    for c in range(4):
        np.testing.assert_array_equal(
            pbn[c].numpy().view(np.uint32), np.asarray(jbn[c]))
    for dim in (0, 3, 17, 64, 200):
        a = np.asarray(jrng.bn_draw(jbn, jnp.uint32(frame), dim))
        b = prng.bn_draw(pbn, frame, dim)
        np.testing.assert_array_equal(_bits(b), a.view(np.uint32))


def test_pack2_unpack2_pack_int_bit_exact():
    rng = np.random.default_rng(3)
    a = rng.normal(size=4096).astype(np.float32) * 100
    b = rng.normal(size=4096).astype(np.float32)
    a[:6] = [0.0, -0.0, np.inf, -np.inf, 1e-40, 3.0e38]
    jp = np.asarray(jpack.pack2(jnp.asarray(a), jnp.asarray(b)))
    pp = ppack.pack2(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(pp), jp.view(np.uint32))
    ja, jb = jpack.unpack2(jnp.asarray(jp))
    pa, pb = ppack.unpack2(pp)
    np.testing.assert_array_equal(_bits(pa), np.asarray(ja).view(np.uint32))
    np.testing.assert_array_equal(_bits(pb), np.asarray(jb).view(np.uint32))
    k = rng.integers(0, 4, 4096).astype(np.int32)
    s = rng.integers(0, 1 << 29, 4096).astype(np.int32)
    ji = np.asarray(jpack.pack_int(jnp.asarray(k), jnp.asarray(s), 2))
    pi = ppack.pack_int(torch.from_numpy(k), torch.from_numpy(s), 2)
    np.testing.assert_array_equal(_bits(pi), ji.view(np.uint32))
    uk, us = ppack.unpack_int(pi, 2)
    np.testing.assert_array_equal(uk.numpy(), k)
    np.testing.assert_array_equal(us.numpy(), s)


def _unit(rng, n):
    v = rng.normal(size=(3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _materials(rng, n):
    rough = rng.uniform(0.0, 1.0, n).astype(np.float32)
    rough[:n // 8] = 0.01          # mirror lobe
    rough[n // 8:n // 4] = 0.05    # smooth transmission
    metal = (rng.uniform(size=n) < 0.3).astype(np.float32)
    trans = np.where(rng.uniform(size=n) < 0.3,
                     rng.uniform(0, 1, n), 0).astype(np.float32)
    alb = rng.uniform(0.05, 1.0, (3, n)).astype(np.float32)
    vals = (alb[0], alb[1], alb[2], rough, metal, trans)
    return (jB.Material(*(jnp.asarray(v) for v in vals)),
            pB.Material(*(torch.from_numpy(v) for v in vals)))


def test_bsdf_evaluate_eval_lum_sample():
    rng = np.random.default_rng(5)
    n_px = 4096
    jm, pm = _materials(rng, n_px)
    n = _unit(rng, n_px)
    wo = _unit(rng, n_px)
    wo = np.where((n * wo).sum(0) < 0, -wo, wo)
    wi = _unit(rng, n_px)
    u = rng.uniform(size=(3, n_px)).astype(np.float32)
    J = lambda a: tuple(jnp.asarray(x) for x in a)
    P = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)
    tol = dict(rtol=1e-5, atol=1e-5)

    with jax.disable_jit():
        jf, jpdf = jB.evaluate(jm, J(n), J(wo), J(wi))
        jl, jlp = jB.eval_lum(jm, J(n), J(wo), J(wi))
        js = jB.sample(jm, J(n), J(wo), *J(u))
    pf, ppdf = pB.evaluate(pm, P(n), P(wo), P(wi))
    pl, plp = pB.eval_lum(pm, P(n), P(wo), P(wi))
    ps = pB.sample(pm, P(n), P(wo), *P(u))

    # GGX's D = α²/(π·den²) with den = cos²h·(α²−1)+1 is small at a lobe's
    # peak; there one last-bit difference of the half vector (XLA's rsqrt
    # is an estimate + Newton step) moves D by ≈ 4·2⁻²³/den relative.
    # Every value agrees to 1e-5 off the peaks (den ≥ 0.05), and to 1e-3 on
    # them.
    h = wo + wi
    h /= np.linalg.norm(h, axis=0, keepdims=True)
    cos_h = np.maximum((n * h).sum(0), 0)
    alpha2 = np.maximum(np.asarray(jm.roughness), 0.02) ** 4
    peak = cos_h ** 2 * (alpha2 - 1) + 1 < 0.05
    assert peak.mean() < 0.05

    def close(b, a):
        np.testing.assert_allclose(b.numpy()[~peak], np.asarray(a)[~peak],
                                   **tol)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-5)

    for a, b in zip(jf, pf):
        close(b, a)
    close(ppdf, jpdf)
    close(pl, jl)
    close(plp, jlp)

    np.testing.assert_array_equal(ps.is_delta.numpy(), np.asarray(js.is_delta))
    np.testing.assert_array_equal(ps.is_transmission.numpy(),
                                  np.asarray(js.is_transmission))
    # sampled directions agree everywhere (the port's sqrt is correctly
    # rounded, like XLA's)
    for a, b in zip(js.wi, ps.wi):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)
    # weights and pdfs are evaluated at the sampled direction, which GGX
    # puts near its lobe's peak (a quarter of the samples): the peak rule
    # above at its half vector, where the pdf's relative gap reaches 1e-2
    wi_s = np.stack([np.asarray(a) for a in js.wi])
    h_s = wo + wi_s
    h_s /= np.maximum(np.linalg.norm(h_s, axis=0, keepdims=True), 1e-12)
    cos_hs = np.maximum((n * h_s).sum(0), 0)
    ok = cos_hs ** 2 * (alpha2 - 1) + 1 >= 0.05
    assert ok.mean() > 0.7
    for a, b in list(zip(js.weight, ps.weight)) + [(js.pdf, ps.pdf)]:
        np.testing.assert_allclose(b.numpy()[ok], np.asarray(a)[ok],
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-2,
                                   atol=1e-3)


def test_camera_rays_and_reprojection():
    kw = dict(pos=(32.0, 18.0, 8.0), yaw=1.1, pitch=-0.35, aspect=1.5)
    jc = jcam.make_camera(**kw)
    pc = pcam.make_camera(**kw)
    H, W = 16, 24
    rng = np.random.default_rng(2)
    ju = rng.uniform(size=(H, W)).astype(np.float32)
    jv = rng.uniform(size=(H, W)).astype(np.float32)
    jo, jd = jcam.camera_rays(jc, W, H, jnp.asarray(ju), jnp.asarray(jv))
    po, pd = pcam.camera_rays(pc, W, H, torch.from_numpy(ju),
                              torch.from_numpy(jv))
    for a, b in zip(jd + jo, pd + po):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    pts = rng.uniform(0, 64, (3, H, W)).astype(np.float32)
    ju2, jv2, jok = jc.point_to_uv(tuple(jnp.asarray(p) for p in pts))
    pu2, pv2, pok = pc.point_to_uv(tuple(torch.from_numpy(p) for p in pts))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    np.testing.assert_allclose(pu2.numpy()[ok], np.asarray(ju2)[ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pv2.numpy()[ok], np.asarray(jv2)[ok],
                               rtol=1e-5, atol=1e-5)
