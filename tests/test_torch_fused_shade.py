"""The fused shading estimator (K4's plain version, render/ris_kernel.py)
against the JAX package's `fused_shade(..., backend="xla")` run op by op
(`jax.disable_jit`), at 16×32 on the same numpy inputs, the tables carried
across with `interop.shade_tables`; plus the packed sky scalars and the
table packing.

Bars: the four int outputs equal on ≥ 99% of pixels, the 22 float
outputs within rtol 2e-5 / atol 2e-5 on the pixels where they are (the
JAX package's own Pallas-vs-XLA bar, tests/test_ris_kernel.py).  The last
bits differ because XLA's rsqrt, exp, sin and cos round differently from
torch's on the CPU; an output that evaluates the GGX lobe at a direction
on its narrow peak amplifies such a bit by ≈ 4·2⁻²³/den relative (den =
cos²h·(α²−1)+1, the rule of tests/test_torch_ops.py), so there — on the
pixels with den < 0.05, 14–19% of them for the continuation's outputs
and 2.5–3.5% for the winner's — the relative bar is 2e-5 + 16·2⁻²³/den.
The largest error seen on those pixels is 6·2⁻²³/den (2e-3 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.core.config import SkySettings as JSkySettings
from rtvb_tpu.ops import rng as jrng
from rtvb_tpu.render import restir as jrestir
from rtvb_tpu.render import ris_kernel as JRK
from rtvb_tpu.render import sky as jsky
from rtvb_tpu.world.lighting import LightTable as JLightTable
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.ops import alias_table
from rtvb_tpu_torch.render import ris_kernel as PRK
from rtvb_tpu_torch.render import sky as psky

torch.set_num_threads(2)

H, W = 16, 32


@pytest.fixture(scope="module")
def sky():
    return jsky.make_sky_state(JSkySettings())


def _light_arrays(k, n_lit, seed):
    """numpy LightTable fields: n_lit random emissive triangles in K
    slots (alias table over luminance × area, random entity flags)."""
    r = np.random.default_rng(seed)
    f = {}
    v0 = np.zeros((k, 3), np.float32)
    e1 = np.zeros((k, 3), np.float32)
    e2 = np.zeros((k, 3), np.float32)
    nrm = np.zeros((k, 3), np.float32)
    area = np.zeros(k, np.float32)
    rad = np.zeros((k, 3), np.float32)
    w = np.zeros(k)
    for s in range(n_lit):
        v0[s] = r.uniform([0, 2, 0], [64, 24, 64])
        e1[s] = r.normal(size=3) * 0.6
        e2[s] = r.normal(size=3) * 0.6
        c = np.cross(e1[s], e2[s])
        nrm[s] = c / max(np.linalg.norm(c), 1e-12)
        area[s] = 0.5 * np.linalg.norm(c)
        rad[s] = r.uniform(0.5, 20.0, 3)
        w[s] = (0.2126 * rad[s, 0] + 0.7152 * rad[s, 1]
                + 0.0722 * rad[s, 2]) * area[s]
    tab = alias_table.build(w)
    for i, c in enumerate("xyz"):
        f[f"v0{c}"], f[f"e1{c}"], f[f"e2{c}"] = v0[:, i], e1[:, i], e2[:, i]
        f[f"n{c}"] = nrm[:, i]
    f.update(area=area, rad_r=rad[:, 0], rad_g=rad[:, 1], rad_b=rad[:, 2],
             key=np.arange(k, dtype=np.int32), ent=r.random(k) < 0.4,
             active=np.arange(k) < n_lit, count=np.int32(n_lit),
             prob=tab.prob, alias=tab.alias, pmf=tab.pmf)
    return f


def _jax_lights(f):
    return JLightTable(**{k: jnp.asarray(v) for k, v in f.items()})


# (name, K, lit triangles, n_local, n_taps, ent_unreachable, blue noise, y0)
CASES = [
    ("canonical_bounce0", 8, 0, 0, 3, False, True, 0),
    ("canonical_taps1_white", 8, 0, 0, 1, False, False, 0),
    ("lights200_taps1_white", 200, 150, 4, 1, True, False, 5),
    ("lights200_taps3_bn", 200, 150, 4, 3, True, True, 0),
    # counts past the compile-time instances' (K4's generic instance)
    ("lights200_cand24_taps6_bn", 200, 150, 24, 6, True, True, 0),
]


def _inputs(seed, n_taps, k):
    r = np.random.default_rng(seed)
    u = lambda lo=0.0, hi=1.0: r.uniform(lo, hi, (H, W)).astype(np.float32)

    def unit(v):
        v = np.stack(v)
        return tuple((v / np.linalg.norm(v, axis=0)).astype(np.float32))
    p = (u(0, 64), u(1, 22), u(0, 64))
    n = unit((u(-0.5, 0.5), u(0.3, 1.0), u(-0.5, 0.5)))
    wo = unit((u(-0.5, 0.5), u(-0.2, 0.9), u(-0.5, 0.5)))
    alb = (u(), u(), u())
    rough = u(0.0, 1.0)
    rough[:2] = 0.01                        # mirrors
    rough[2:4] = 0.05                       # smooth transmission
    metal = np.where(r.random((H, W)) < 0.3, u(), 0.0).astype(np.float32)
    trans = np.where(r.random((H, W)) < 0.3, u(), 0.0).astype(np.float32)
    depth = u(1, 40)
    depth[:, :2] = 1e30
    taps = []
    for t in range(n_taps):
        near = r.random((H, W)) < 0.7
        pdepth = np.where(near, depth * u(0.95, 1.05), u(1, 40))
        pn = unit((n[0] + u(-0.2, 0.2), n[1], n[2] + u(-0.2, 0.2)))
        st = jrestir.pack_state(
            kind=jnp.asarray(r.integers(0, 4, (H, W)), jnp.int32),
            slot=jnp.asarray(r.integers(0, k, (H, W)), jnp.int32),
            fa=jnp.asarray(u(0, 0.5)), fb=jnp.asarray(u(0, 0.5)),
            dir3=tuple(jnp.asarray(c) for c in unit(
                (u(-1, 1), u(0.1, 1), u(-1, 1)))),
            W=jnp.asarray(u(0, 3)), M=jnp.asarray(u(0, 30)),
            depth=jnp.asarray(pdepth.astype(np.float32)),
            n3=tuple(jnp.asarray(c) for c in pn),
            le=(jnp.asarray(u(0, 5)), jnp.asarray(u(0, 5)),
                jnp.asarray(u(0, 5))))
        taps.append((np.asarray(st.data),
                     r.integers(0, 2, (H, W)).astype(np.int32)))
    return dict(p=p, n=n, wo=wo, alb=alb, rough=rough, metal=metal,
                trans=trans, depth=depth, taps=taps)


# outputs that evaluate the GGX lobe at the BSDF continuation direction
# (weight, prev_cos_pdf) and at the winner's direction (phat, W, nee)
_AT_WI = (20, 21, 22, 25)
_AT_WINNER = (11, 13, 14, 15, 16)
PEAK_DEN = 0.05         # den below this: a GGX peak
PEAK_ULPS = 16          # relative bar there, in units of 2⁻²³/den


def _ggx_den(x, wi):
    """GGX's D = α²/(π·den²), den = cos²h·(α²−1)+1, for the half vector
    of wo and wi; den is small at a lobe's peak."""
    n, wo = np.stack(x["n"]), np.stack(x["wo"])
    h = wo + np.stack(wi)
    h /= np.maximum(np.linalg.norm(h, axis=0, keepdims=True), 1e-12)
    cos_h = np.maximum((n * h).sum(0), 0)
    alpha2 = np.maximum(x["rough"], 0.02) ** 4
    return cos_h ** 2 * (alpha2 - 1) + 1


def _compare(jo, po, x):
    """Ints equal on ≥ 99% of pixels; floats within 2e-5 there, off the
    GGX peaks, and within 2e-5 + PEAK_ULPS·2⁻²³/den relative on them.
    Returns the int agreement and the largest share of its bar that an
    error on a peak used."""
    js = [np.asarray(a) for a in JRK._flatten_out(jo)]
    ps = [a.numpy() for a in PRK.flatten_out(po)]
    agree = np.ones((H, W), bool)
    for k in PRK.OUT_I32:
        agree &= js[k].astype(np.int64) == ps[k].astype(np.int64)
    assert agree.mean() >= 0.99, agree.mean()
    den_wi, den_win = _ggx_den(x, js[17:20]), _ggx_den(x, js[4:7])
    peak_share = ((den_wi < PEAK_DEN).mean(), (den_win < PEAK_DEN).mean())
    assert peak_share[0] < 0.25 and peak_share[1] < 0.05, peak_share
    used = 0.0
    for k, (a, b) in enumerate(zip(js, ps)):
        if k in PRK.OUT_I32:
            continue
        den = den_wi if k in _AT_WI else (
            den_win if k in _AT_WINNER else np.ones((H, W)))
        peak = den < PEAK_DEN
        rtol = np.where(peak, 2e-5 + PEAK_ULPS * 2.0 ** -23
                        / np.maximum(den, 1e-7), 2e-5)
        a, b = a.astype(np.float64), b.astype(np.float64)
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        lim = 2e-5 + rtol * np.abs(a)
        err = np.where(same, 0.0, np.abs(b - a))
        bad = agree & ~(err <= lim)
        assert not bad.any(), (
            f"output #{k}: {int(bad.sum())} values over the bar "
            f"({int((bad & peak).sum())} on GGX peaks), worst error "
            f"{float(err[bad].max())}")
        if (agree & peak).any():
            used = max(used, float((err / lim)[agree & peak].max()))
    return agree.mean(), peak_share, used


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_shade_plain_matches_jax(sky, case):
    name, k, n_lit, n_local, n_taps, ent, bn_on, y0 = case
    f = _light_arrays(k, n_lit, seed=len(name))
    jl = _jax_lights(f)
    remap = None
    if n_lit:
        rr = np.random.default_rng(3).permutation(k).astype(np.int32)
        rr[::7] = -1
        remap = jnp.asarray(rr)
    x = _inputs(11 + n_taps, n_taps, k)
    frame = 37
    sf = jsky.sky_scalar_pack(sky, jl.count > 0)
    lf, li = JRK.pack_light_tables(jl, remap)
    envf, envi = JRK.pack_env_tables(sky)
    bn_j = jrng.bn_packed(H, W, y0) if bn_on else None
    jcfg = JRK.ShadeConfig(n_local=n_local, n_taps=n_taps, k_slots=k,
                           base_dim=8, ent_unreachable=ent, m_cap=20.0,
                           dis_thr=0.2, approx=False, blue_noise=bn_on)
    J = lambda a: jnp.asarray(a)
    with jax.disable_jit():
        jo = JRK.fused_shade(
            jcfg, frame, y0, sf, lf, li, envf, envi,
            tuple(map(J, x["p"])), tuple(map(J, x["n"])),
            tuple(map(J, x["wo"])), tuple(map(J, x["alb"])), J(x["rough"]),
            J(x["metal"]), J(x["trans"]),
            depth=J(x["depth"]) if n_taps else None,
            taps=[([J(tp[c]) for c in range(8)], J(tv))
                  for tp, tv in x["taps"]],
            backend="xla", bn=bn_j)

    plf, pli, penvf, penvi = interop.shade_tables(lf, li, envf, envi, k)
    T = lambda a: torch.from_numpy(np.array(a))
    pcfg = PRK.ShadeConfig(n_local=n_local, n_taps=n_taps, k_slots=k,
                           base_dim=8, ent_unreachable=ent, m_cap=20.0,
                           dis_thr=0.2, blue_noise=bn_on)
    bn_p = tuple(T(np.asarray(b).view(np.int32)) for b in bn_j) \
        if bn_on else None
    po = PRK.fused_shade(
        pcfg, frame, y0, T(np.asarray(sf)), plf, pli, penvf, penvi,
        tuple(map(T, x["p"])), tuple(map(T, x["n"])), tuple(map(T, x["wo"])),
        tuple(map(T, x["alb"])), T(x["rough"]), T(x["metal"]), T(x["trans"]),
        depth=T(x["depth"]) if n_taps else None,
        taps=[(T(tp.view(np.int32)).view(torch.float32), T(tv))
              for tp, tv in x["taps"]], bn=bn_p)
    frac, peak_share, used = _compare(jo, po, x)
    print(f"{name}: int outputs agree on {frac:.4f} of pixels; GGX peaks "
          f"{peak_share[0]:.4f} (continuation) / {peak_share[1]:.4f} "
          f"(winner) of pixels, largest error there {used:.3f} of its bar")
    # the estimator did something: some winners and some taps taken
    kinds = po.kind.numpy()
    assert (kinds != 0).mean() > 0.5
    if n_lit and n_local:
        assert (kinds == PRK.KIND_LOCAL).any()


@pytest.mark.parametrize("remap_len", [None, 150, 200, 260])
def test_pack_tables_match_jax(sky, remap_len):
    k = 200
    f = _light_arrays(k, 150, seed=9)
    jl = _jax_lights(f)
    remap = None
    if remap_len is not None:
        rr = np.random.default_rng(4).integers(-1, k, remap_len)
        remap = rr.astype(np.int32)
    lf, li = JRK.pack_light_tables(jl, None if remap is None
                                   else jnp.asarray(remap))
    envf, envi = JRK.pack_env_tables(sky)
    want = interop.shade_tables(lf, li, envf, envi, k)
    pl = interop.lights(jl)
    got = PRK.pack_light_tables(pl, None if remap is None
                                else torch.from_numpy(remap))
    got += PRK.pack_env_tables(interop.sky(sky))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sky_scalars_match_jax(sky):
    ps = interop.sky(sky)
    for any_lights in (False, True):
        want = np.asarray(jsky.sky_scalar_pack(sky, any_lights))
        got = psky.sky_scalar_pack(ps, any_lights).numpy()
        assert got.shape == (psky.SF_LEN,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    sf_j = jsky.sky_scalar_pack(sky, True)
    sf_p = torch.from_numpy(np.asarray(sf_j))
    r = np.random.default_rng(2)
    d = r.normal(size=(3, 40, 30)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[1, :5] = -np.abs(d[1, :5])           # below the horizon
    with jax.disable_jit():
        js = jsky.sky_radiance_scalars(tuple(jnp.asarray(c) for c in d),
                                       sf_j, rsqrt=jax.lax.rsqrt)
        sin_t = r.uniform(0.0, 0.01, (40, 30)).astype(np.float32)
        jsun = jsky.sun_radiance_scalars_cone(jnp.asarray(sin_t), sf_j)
        jac = jsky._acos_poly(jnp.asarray(d[0]))
    ps_ = psky.sky_radiance_scalars(tuple(torch.from_numpy(c) for c in d),
                                    sf_p, rsqrt=torch.rsqrt)
    psun = psky.sun_radiance_scalars_cone(torch.from_numpy(sin_t), sf_p)
    pac = psky._acos_poly(torch.from_numpy(d[0]))
    for a, b in zip(list(js) + list(jsun) + [jac],
                    list(ps_) + list(psun) + [pac]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
