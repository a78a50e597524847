"""K2's plain version (rtvb_tpu_torch.ops.triangles, run by the wrapper on
CPU tensors) against the JAX package's XLA intersector
`intersect_packed_xla`, on the canonical flower soup plus random
triangles, padded with the zero rows that must never hit.

The JAX reference runs op by op (jax.disable_jit): jitted XLA on the CPU
contracts a*b + c into fused multiply-adds, which the port's separately
rounded ops (and its kernels, built with --fmad=false) do not.
Triangle index and hit exact; t, u, v to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.assets import decorations as jdeco
from rtvb_tpu.ops import triangles as jtri
from rtvb_tpu_torch.ops import triangles as ptri

torch.set_num_threads(2)


def _soup(seed):
    v0, v1, v2 = jdeco.flower_mesh()
    parts = [(v0 + p, v1 + p, v2 + p)
             for p in np.array([[20, 9, 50], [22, 9, 48], [45, 8, 20],
                                [50, 10, 36]], np.float32)]
    rng = np.random.default_rng(seed)
    a = rng.uniform(10, 50, (12, 3)).astype(np.float32)
    parts.append((a, a + rng.normal(0, 3, (12, 3)).astype(np.float32),
                  a + rng.normal(0, 3, (12, 3)).astype(np.float32)))
    v0 = np.concatenate([p[0] for p in parts])
    v1 = np.concatenate([p[1] for p in parts])
    v2 = np.concatenate([p[2] for p in parts])
    packed = np.concatenate([v0, v1 - v0, v2 - v0], axis=-1)
    pad = np.zeros((64 - len(packed), 9), np.float32)      # pow2 soup
    return np.concatenate([packed, pad]).astype(np.float32)


def _rays(seed, shape):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform([15, 7, 15], [55, 12, 55], shape + (3,))
    o = rng.uniform([0, 10, 0], [64, 25, 64], shape + (3,))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (tuple(o[..., i].astype(np.float32) for i in range(3)),
            tuple(d[..., i].astype(np.float32) for i in range(3)))


@pytest.mark.parametrize("with_cap", [False, True])
def test_intersect_matches_jax(with_cap):
    tri = _soup(0)
    o, d = _rays(1, (96, 128))
    cap = np.random.default_rng(2).uniform(5, 40, (96, 128)).astype(
        np.float32) if with_cap else None
    with jax.disable_jit():
        jh = jtri.intersect_packed_xla(
            tuple(jnp.asarray(a) for a in o), tuple(jnp.asarray(a) for a in d),
            jnp.asarray(tri), None if cap is None else jnp.asarray(cap))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ph = ptri.intersect_packed(tuple(T(a) for a in o),
                               tuple(T(a) for a in d), T(tri),
                               None if cap is None else T(cap))
    hit = np.asarray(jh.hit)
    assert 0.005 < hit.mean() < 0.9
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(jh.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ph, f).numpy(),
                                   np.asarray(getattr(jh, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    # padding rows never win
    assert ph.tri.numpy().max() < 4 * 4 + 12


def _torch_rays(o, d):
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return tuple(T(a) for a in o), tuple(T(a) for a in d)


def test_wrapper_contract_on_cpu():
    """On CPU tensors the wrapper runs the plain version: a torch.bool hit,
    no cap the same records as a cap plane of BIG, an explicit cap the
    plain version's records; the CUDA path refuses CPU tensors and counts
    no launch."""
    tri = torch.from_numpy(_soup(0))
    o, d = _torch_rays(*_rays(1, (24, 40)))
    none = ptri.intersect_packed(o, d, tri)
    assert none.hit.dtype == torch.bool
    full = ptri.intersect_packed(o, d, tri, torch.full((24, 40), ptri.BIG))
    cap = torch.from_numpy(np.random.default_rng(3).uniform(
        5, 40, (24, 40)).astype(np.float32))
    capped = ptri.intersect_packed(o, d, tri, cap)
    plain = ptri.intersect_packed_plain(o, d, tri, cap)
    for f in ptri.TriHit._fields:
        assert torch.equal(getattr(none, f), getattr(full, f)), f
        assert torch.equal(getattr(capped, f), getattr(plain, f)), f
    assert 0 < int(capped.hit.sum()) < int(none.hit.sum())
    before = ptri.TRI.launches
    with pytest.raises(ValueError):
        ptri.intersect_packed_cuda(o, d, tri, cap)
    assert ptri.TRI.launches == before


@pytest.mark.parametrize("with_cap", [False, True])
def test_probe_rays_match_jax(with_cap):
    """The plain version against the XLA intersector on the rays that probe
    K2's box cull: the padded box's face planes, the box's corners, edges
    and faces and points just off them, the triangles' vertices and edges,
    origins inside the box, zero direction components, parked rays, caps at
    a hit's t and one float either side."""
    from torch_tri_probes import probe_rays
    tri = _soup(0)
    o, d, cap = probe_rays(tri, seed=4, n=96)
    cap = cap if with_cap else None
    with jax.disable_jit():
        jh = jtri.intersect_packed_xla(
            tuple(jnp.asarray(a) for a in o), tuple(jnp.asarray(a) for a in d),
            jnp.asarray(tri), None if cap is None else jnp.asarray(cap))
    to, td = _torch_rays(o, d)
    ph = ptri.intersect_packed(to, td, torch.from_numpy(tri),
                               None if cap is None else torch.from_numpy(cap))
    hit = np.asarray(jh.hit)
    assert 100 < hit.sum() < hit.size // 2
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(jh.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ph, f).numpy(),
                                   np.asarray(getattr(jh, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_in_plane_rays_match_jax(seed):
    """The plain version against the XLA intersector on rays in, or a few
    ulps off, the planes of tilted triangles (tests/torch_tri_probes.py
    `in_plane_rays`), where the determinant is mostly rounding: the hits,
    the triangle and t, u, v as for the other probes."""
    from torch_tri_probes import in_plane_rays, in_plane_soup
    tri = in_plane_soup(seed)
    o, d = in_plane_rays(tri, seed)
    with jax.disable_jit():
        jh = jtri.intersect_packed_xla(
            tuple(jnp.asarray(a) for a in o), tuple(jnp.asarray(a) for a in d),
            jnp.asarray(tri))
    to, td = _torch_rays(o, d)
    ph = ptri.intersect_packed(to, td, torch.from_numpy(tri))
    hit = np.asarray(jh.hit)
    assert hit.sum() >= 10
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    np.testing.assert_array_equal(ph.tri.numpy(), np.asarray(jh.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ph, f).numpy(),
                                   np.asarray(getattr(jh, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_plane_ray_hit_lies_outside_the_padded_box():
    """PLANE_RAY: the plain version reports a hit at t = 2, u = 0, v = 1
    on PLANE_ROW, and the ray passes the triangle's box padded by 1e-3
    (a box cull with a fixed margin drops this hit)."""
    from torch_tri_probes import PAD, PLANE_RAY, PLANE_ROW, soup_box
    o, d = (tuple(torch.tensor(a[i:i + 1]) for i in range(3))
            for a in PLANE_RAY)
    h = ptri.intersect_packed(o, d, torch.from_numpy(PLANE_ROW[None]))
    assert bool(h.hit[0]) and int(h.tri[0]) == 0
    assert (float(h.t[0]), float(h.u[0]), float(h.v[0])) == (2.0, 0.0, 1.0)
    lo, hi = soup_box(PLANE_ROW[None])
    lo, hi = lo.astype(np.float64) - PAD, hi.astype(np.float64) + PAD
    ro, rd = (a.astype(np.float64) for a in PLANE_RAY)
    with np.errstate(divide="ignore"):
        t0, t1 = (lo - ro) / rd, (hi - ro) / rd
    assert np.minimum(t0, t1).max() > np.maximum(t0, t1).min()
