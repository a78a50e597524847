"""World, asset and sky state of the port against the JAX package: every
voxel, material, decoration and light table equal exactly; the sky state
and the per-direction sky / sun evaluations to 1e-5 relative (the JAX side
runs op by op, jax.disable_jit, so neither side fuses multiply-adds)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.assets import decorations as jdeco
from rtvb_tpu.assets import textures as jtex
from rtvb_tpu.assets.blocks import BlockRegistry
from rtvb_tpu.assets.materials import MaterialRegistry as JMatReg
from rtvb_tpu.core.config import SkySettings
from rtvb_tpu.render import sky as jsky
from rtvb_tpu.world import gen as jgen
from rtvb_tpu.world import lighting as jlight
from rtvb_tpu.world import voxel as jvoxel
from rtvb_tpu_torch import interop
from rtvb_tpu_torch import kernels as K
from rtvb_tpu_torch.assets import textures as ptex
from rtvb_tpu_torch.assets.blocks import BlockRegistry as PBlockRegistry
from rtvb_tpu_torch.assets.decorations import DecorationMeshes
from rtvb_tpu_torch.assets.materials import MaterialRegistry as PMatReg
from rtvb_tpu_torch.core.config import SkySettings as PSkySettings
from rtvb_tpu_torch.render import sky as psky
from rtvb_tpu_torch.world import gen as pgen
from rtvb_tpu_torch.world import lighting as plight
from rtvb_tpu_torch.world import voxel as pvoxel

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "data", "assets")


def _registry():
    return BlockRegistry.from_yaml(os.path.join(ASSETS, "blocks.yaml"))


def _port_registry():
    return PBlockRegistry.from_yaml(os.path.join(ASSETS, "blocks.yaml"))


def _assert_tables_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f)
        else:
            assert x == y, f


def test_canonical_world_tables_equal():
    reg = _registry()
    nonsolid = tuple(b.id for b in reg.blocks if b.instanced)
    jcfg, jw = jgen.generate_world(nonsolid_ids=nonsolid)
    pcfg, pw = pgen.generate_world(nonsolid_ids=nonsolid)
    assert (jcfg.x, jcfg.y, jcfg.z, jcfg.super_size) == \
        (pcfg.x, pcfg.y, pcfg.z, pcfg.super_size)
    _assert_tables_equal(interop.world(jw), pw)
    # four flowers sit in the world as exceptions
    assert int((pw.exc_key < pvoxel.EXC_EMPTY).sum()) >= 4


def test_edited_world_tables_equal():
    """Overhangs, floating blocks and a long exception list."""
    jcfg, jw = jgen.generate_world()
    blocks = np.asarray(jw.blocks).copy()
    rng = np.random.default_rng(7)
    for _ in range(50):
        x, y, z = rng.integers(0, 64), rng.integers(0, 30), rng.integers(0, 64)
        blocks[x, y, z] = rng.integers(0, 20)
    cfg_j = jvoxel.WorldConfig(max_exceptions=256)
    jw2 = jvoxel.build_tables(cfg_j, jnp.asarray(blocks), jw.schema)
    cfg_p = pvoxel.WorldConfig(max_exceptions=256)
    pw2 = pvoxel.build_tables(cfg_p, blocks,
                              np.asarray(jw.schema).reshape(-1))
    _assert_tables_equal(interop.world(jw2), pw2)
    ix, iy, iz = (rng.integers(-2, 66, 500) for _ in range(3))
    jb = np.asarray(jvoxel.block_id_at(cfg_j, jw2, jnp.asarray(ix),
                                       jnp.asarray(iy), jnp.asarray(iz)))
    pb = pvoxel.block_id_at(cfg_p, pw2, torch.from_numpy(ix),
                            torch.from_numpy(iy), torch.from_numpy(iz))
    np.testing.assert_array_equal(pb.numpy(), jb)


def test_material_table_equal():
    reg = _registry()
    path = os.path.join(ASSETS, "materials.yaml")
    names = {n: i for i, n in enumerate(["character_albedo", "bark", "brick",
                                         "grass", "stone"])}
    jm = JMatReg.from_yaml(path).build_table(reg, jtex.TEXTURE_IDS, names)
    pm = PMatReg.from_yaml(path).build_table(_port_registry(),
                                             ptex.TEXTURE_IDS, names)
    _assert_tables_equal(interop.materials(jm), pm)


def test_decoration_triangles_equal():
    meshes = DecorationMeshes()
    pos = np.array([[3, 4, 5], [10, 2, 7]], np.float32)
    for name in ("flower", "torch", "lantern"):
        ja = jdeco.decoration_triangles(name, pos)
        pa = meshes.decoration_triangles(name, pos)
        for a, b in zip(ja, pa):
            np.testing.assert_array_equal(b, a, err_msg=name)


def _lit_world(reg):
    """Lanterns, torches and (with a modified registry) emissive cubes."""
    jcfg, jw = jgen.generate_world()
    blocks = np.asarray(jw.blocks).copy()
    lantern, torch_id = reg.id_of("lantern"), reg.id_of("torch")
    brick = reg.id_of("brick")
    for i, (x, z) in enumerate([(10, 10), (30, 40), (50, 12), (5, 60)]):
        blocks[x, 20, z] = (lantern, torch_id, brick, lantern)[i]
    nonsolid = tuple(b.id for b in reg.blocks if b.instanced)
    jw = jvoxel.build_tables(jcfg, jnp.asarray(blocks), jw.schema, nonsolid)
    return jcfg, jw


def test_light_table_equal():
    reg, preg = _registry(), _port_registry()
    for r in (reg, preg):
        r.blocks[r.id_of("brick")] = dataclasses.replace(
            r.blocks[r.id_of("brick")], emissive=True)
    jcfg, jw = _lit_world(reg)
    path = os.path.join(ASSETS, "materials.yaml")
    jm = JMatReg.from_yaml(path).build_table(reg, jtex.TEXTURE_IDS)
    pm = PMatReg.from_yaml(path).build_table(preg, ptex.TEXTURE_IDS)
    jl = jlight.build_light_table(jcfg, jw, jm, reg)
    pcfg = pvoxel.WorldConfig()
    pl = plight.build_light_table(pcfg, interop.world(jw), pm, preg,
                                  DecorationMeshes())
    assert pl.count == int(jl.count) == 12 * 3 + 12
    _assert_tables_equal(interop.lights(jl), pl)
    jk = np.asarray(jl.key)
    assert (np.diff(jk) >= 0).all()         # sorted: searchable by key


@pytest.fixture(scope="module")
def skies():
    return (jsky.make_sky_state(SkySettings()),
            psky.make_sky_state(PSkySettings()))


def test_sky_state_close(skies):
    js, ps = skies
    cs = interop.sky(js)
    for f in ("turbidity", "sky_intensity", "sun_intensity",
              "cos_sun_radius", "env_alias"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      getattr(cs, f).numpy(), err_msg=f)
    for f in ("env_prob", "env_pmf", "basis_p", "basis_m", "sun_poly"):
        np.testing.assert_allclose(getattr(ps, f).numpy(),
                                   getattr(cs, f).numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose([float(v) for v in ps.sun_dir],
                               [float(v) for v in js.sun_dir], rtol=1e-6)


def test_sky_radiance_functions(skies):
    js, _ = skies
    ps = interop.sky(js)      # identical state: compare the evaluations
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3, 64, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    sun = np.array([float(v) for v in js.sun_dir], np.float32)
    d[:, :4, :] = sun[:, None, None]           # inside the sun disk
    u = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    J = lambda a: tuple(jnp.asarray(x) for x in a)
    P = lambda a: tuple(torch.from_numpy(x) for x in a)
    tol = dict(rtol=1e-5, atol=1e-6)
    with jax.disable_jit():
        pairs = [
            (jsky.sky_radiance(J(d), js), psky.sky_radiance(P(d), ps)),
            (jsky.sun_radiance(J(d), js), psky.sun_radiance(P(d), ps)),
            (jsky.sun_radiance_cone(jnp.asarray(u[0]), js),
             psky.sun_radiance_cone(torch.from_numpy(u[0]), ps)),
            ((jsky.sky_env_pdf(js, J(d)),), (psky.sky_env_pdf(ps, P(d)),)),
        ]
        jd, jp = jsky.sky_env_sample(js, *J(u))
        pd, pp = psky.sky_env_sample(ps, *P(u))
    pairs.append((tuple(jd) + (jp,), tuple(pd) + (pp,)))
    for ja, pa in pairs:
        for a, b in zip(ja, pa):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


def test_procedural_textures():
    rng = np.random.default_rng(1)
    shape = (48, 64)
    tid = rng.integers(-1, 5, shape).astype(np.int32)
    u = rng.uniform(0, 4, shape).astype(np.float32)
    v = rng.uniform(0, 4, shape).astype(np.float32)
    lod = rng.uniform(0, 2, shape).astype(np.float32)
    n = np.zeros((3,) + shape, np.float32)
    axis = rng.integers(0, 3, shape)
    for k in range(3):
        n[k][axis == k] = 1.0
    p = rng.uniform(0, 64, (3,) + shape).astype(np.float32)
    T = torch.from_numpy
    with jax.disable_jit():
        j1 = jtex.sample_scale(jnp.asarray(tid), jnp.asarray(u),
                               jnp.asarray(v), jnp.asarray(lod))
        jdu, jdv = jtex.sample_normal_delta(jnp.asarray(tid), jnp.asarray(u),
                                            jnp.asarray(v), jnp.asarray(lod))
        jn = jtex.perturb_normal(tuple(jnp.asarray(x) for x in n), jdu, jdv)
        juv = jtex.triplanar_uv(*(jnp.asarray(x) for x in p),
                                *(jnp.asarray(x) for x in n))
    p1 = ptex.sample_scale(T(tid), T(u), T(v), T(lod))
    pdu, pdv = ptex.sample_normal_delta(T(tid), T(u), T(v), T(lod))
    pn = ptex.perturb_normal(tuple(T(x) for x in n), pdu, pdv)
    puv = ptex.triplanar_uv(*(T(x) for x in p), *(T(x) for x in n))
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=1e-5,
                               atol=1e-6)
    # finite differences over eps = 0.004 amplify the last-bit noise 125×
    for a, b in ((jdu, pdu), (jdv, pdv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=2e-3)
    for a, b in zip(jn + juv, pn + puv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("with_lod", [False, True])
def test_procedural_textures_cpu_dispatch(monkeypatch, with_lod):
    """On CPU tensors `sample_scale` and `sample_normal_delta` load no
    kernel library and launch nothing, and match JAX's for every id from -1
    through 5 (past the last pattern: the flat 0.5 pattern), with the lod
    and without it (contrast 0.6); u and v reach below 0."""
    def no_library():
        raise AssertionError("a CPU call loaded the kernel library")
    monkeypatch.setattr(K.LIBRARY, "get", no_library)
    rng = np.random.default_rng(2)
    shape = (7, 30)
    tid = np.repeat(np.arange(-1, 6, dtype=np.int32), shape[1]).reshape(shape)
    u = rng.uniform(-0.5, 3.5, shape).astype(np.float32)
    v = rng.uniform(-0.5, 3.5, shape).astype(np.float32)
    lod = rng.uniform(0, 2, shape).astype(np.float32) if with_lod else None
    T = torch.from_numpy
    before = ptex.PROCTEX.launches
    p1 = ptex.sample_scale(T(tid), T(u), T(v), None if lod is None else T(lod))
    pdu, pdv = ptex.sample_normal_delta(T(tid), T(u), T(v),
                                        None if lod is None else T(lod))
    assert ptex.PROCTEX.launches == before
    jlod = None if lod is None else jnp.asarray(lod)
    with jax.disable_jit():
        j1 = jtex.sample_scale(jnp.asarray(tid), jnp.asarray(u),
                               jnp.asarray(v), jlod)
        jdu, jdv = jtex.sample_normal_delta(jnp.asarray(tid), jnp.asarray(u),
                                            jnp.asarray(v), jlod)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), rtol=1e-5,
                               atol=1e-6)
    # finite differences over eps = 0.004 amplify the last-bit noise 125×
    for a, b in ((jdu, pdu), (jdv, pdv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=2e-3)
    # -1 is the identity and 5 the flat pattern; 0-4 vary over the plane
    assert (p1[0] == 1.0).all() and not pdu[0].any() and not pdv[0].any()
    assert (p1[6] == p1[6, 0]).all() and not pdu[6].any()
    assert all(p1[k].unique().numel() > 1 for k in range(1, 6))
