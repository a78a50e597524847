"""K1's plain version (rtvb_tpu_torch.ops.dda.trace_plain, which the
wrapper runs on CPU tensors) against the JAX package's XLA tracer
`dda.trace` + its block-id / material resolve, on a world with carved
overhangs, floating blocks and exceptions.

The JAX reference runs op by op (jax.disable_jit): jitted XLA on the CPU
contracts a*b + c into fused multiply-adds, and a face choice on a voxel
edge then follows the extra rounding; the port's ops (and its kernels,
built with --fmad=false) round every product.
Hit, voxel, normal and material index exact; t to 1e-5 (relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.ops import dda as jdda
from rtvb_tpu.render.pathtracer import resolve_block_id
from rtvb_tpu.world import gen as jgen
from rtvb_tpu.world import voxel as jvoxel
from rtvb_tpu.assets.blocks import BlockRegistry
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.ops import dda as pdda

torch.set_num_threads(2)

MAX_STEPS = 96


def _carved_world():
    """Canonical terrain with caves, overhangs, floating blocks and many
    exception voxels (ids the schema does not predict)."""
    cfg, w = jgen.generate_world()
    blocks = np.asarray(w.blocks).copy()
    rng = np.random.default_rng(11)
    for _ in range(40):                           # carve caves / overhangs
        x, z = rng.integers(2, 62, 2)
        y = rng.integers(1, 7)
        blocks[x:x + 3, y:y + 2, z:z + 2] = 0
    for _ in range(30):                           # floating / exception blocks
        x, y, z = rng.integers(0, 64), rng.integers(8, 30), rng.integers(0, 64)
        blocks[x, y, z] = rng.integers(1, 20)
    cfg = jvoxel.WorldConfig(max_exceptions=512)
    jw = jvoxel.build_tables(cfg, jnp.asarray(blocks), w.schema)
    return cfg, jw


@pytest.fixture(scope="module")
def world():
    cfg, jw = _carved_world()
    reg = BlockRegistry.builtin()
    b2m = np.arange(len(reg.blocks), dtype=np.int32)[::-1].copy() % 7
    tables = pdda.trace_tables(interop.world(jw),
                               type("M", (), {"block_to_mat":
                                              torch.from_numpy(b2m)})())
    tp = jdda.TraceParams(x=cfg.x, y=cfg.y, z=cfg.z,
                          super_size=cfg.super_size, super_z=cfg.super_z,
                          max_steps=MAX_STEPS)
    return cfg, jw, tables, tp, b2m


def _rays(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "camera":
        o = np.tile(np.array([[32.0], [18.0], [8.0]], np.float32), (1, n))
        d = rng.normal(size=(3, n)).astype(np.float32)
        d[1] = -np.abs(d[1]) * 0.6
        d[2] = np.abs(d[2]) + 0.5
    else:
        o = rng.uniform([-8, 0, -8], [72, 34, 72], (n, 3)).T.astype(np.float32)
        d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    # axis-aligned and exactly horizontal rays exercise the degenerate slabs
    d[:, :8] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0],
                         [0.6, 0, 0.8], [0, 1, 0], [0, 0, -1],
                         [0.8, 0, -0.6]], np.float32).T
    return o.reshape(3, 64, n // 64), d.reshape(3, 64, n // 64)


def _jax_trace(jw, tp, o, d, t_cap, any_hit):
    with jax.disable_jit():
        return _jax_trace_jit(jw, tp, o, d, t_cap, any_hit)


def _jax_trace_jit(jw, tp, o, d, t_cap, any_hit):
    return jdda.trace(tuple(jnp.asarray(a) for a in o),
                      tuple(jnp.asarray(a) for a in d), jw.colmask,
                      jw.df_super[0], tp,
                      t_cap=None if t_cap is None else jnp.asarray(t_cap),
                      any_hit=any_hit, maxh_row=jw.maxh_super[0])


def _port_trace(tables, tp, o, d, t_cap, any_hit):
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return pdda.trace(tuple(T(a) for a in o), tuple(T(a) for a in d), tables,
                      pdda.TraceParams(*tp),
                      t_cap=None if t_cap is None else T(t_cap),
                      any_hit=any_hit)


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_closest_hit_matches_jax(world, kind):
    cfg, jw, tables, tp, b2m = world
    o, d = _rays(1, 64 * 64, kind)
    jr = _jax_trace(jw, tp, o, d, None, False)
    pr = _port_trace(tables, tp, o, d, None, False)
    hit = np.asarray(jr.hit)
    assert 0.2 < hit.mean() < 0.99
    np.testing.assert_array_equal(pr.hit.numpy(), hit)
    for f in ("ix", "iy", "iz", "nx", "ny", "nz"):
        np.testing.assert_array_equal(getattr(pr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    np.testing.assert_allclose(pr.t.numpy(), np.asarray(jr.t), rtol=1e-5)
    # epilogue: block id (schema + exception search) → material index
    with jax.disable_jit():
        bid = np.asarray(resolve_block_id(cfg, jw, jr))
    mi = b2m[np.clip(bid, 0, len(b2m) - 1)]
    np.testing.assert_array_equal(pr.mi.numpy(), mi)
    # the carved world really exercises the exception list
    assert np.asarray(jw.exc_key < jvoxel.EXC_EMPTY).sum() > 20


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_any_hit_matches_jax(world, kind):
    cfg, jw, tables, tp, b2m = world
    o, d = _rays(2, 64 * 64, kind)
    cap = np.random.default_rng(3).uniform(0.5, 60, o.shape[1:]).astype(
        np.float32)
    jr = _jax_trace(jw, tp, o, d, cap, True)
    pr = _port_trace(tables, tp, o, d, cap, True)
    np.testing.assert_array_equal(pr.hit.numpy(), np.asarray(jr.hit))
    np.testing.assert_allclose(pr.t.numpy(), np.asarray(jr.t), rtol=1e-5)


def test_odd_step_cap_runs_one_extra_substep(world):
    """An odd max_steps runs max_steps + 1 sub-steps in both tracers."""
    cfg, jw, tables, tp, b2m = world
    tp7 = tp._replace(max_steps=7)
    o, d = _rays(4, 64 * 64, "random")
    jr = _jax_trace(jw, tp7, o, d, None, False)
    pr = _port_trace(tables, tp7, o, d, None, False)
    np.testing.assert_array_equal(pr.hit.numpy(), np.asarray(jr.hit))
    np.testing.assert_array_equal(pr.iy.numpy(), np.asarray(jr.iy))


def _pillar_world():
    """A 64×32×64 world with a floor (y < 5) under every column and a
    pillar to the top at z = 0 for every x: no column is empty and every
    supercolumn along z < 8 reaches the top, so neither the distance field
    nor the height envelope lets a ray at y = 10.5 skip a column there."""
    from rtvb_tpu_torch.world import voxel as pvoxel
    cfg = pvoxel.WorldConfig()
    blocks = np.zeros((cfg.x, cfg.y, cfg.z), np.uint8)
    blocks[:, :5, :] = 1
    blocks[:, :, 0] = 1
    schema = pvoxel.pack_schema(np.full(cfg.n_cols, 5), 5, 1, 1, 1)
    world = pvoxel.build_tables(cfg, blocks, schema)
    mats = type("M", (), {"block_to_mat": torch.zeros(2, dtype=torch.int32)})
    return (pdda.trace_tables(world, mats),
            pdda.trace_params(cfg, MAX_STEPS))


def _one_ray(o, d):
    return (tuple(torch.tensor([v], dtype=torch.float32) for v in o),
            tuple(torch.tensor([v], dtype=torch.float32) for v in d))


@pytest.mark.parametrize("cap,columns", [(None, 64), (20.0, 21)])
def test_substeps_count_the_columns_crossed(cap, columns):
    """An axis-aligned ray along +x at y = 10.5 above the floor crosses the
    columns x = 0 … 63 one sub-step each (64), or x = 0 … 20 when capped at
    t = 20 (the column it is in at the cap is the last)."""
    tables, tp = _pillar_world()
    o, d = _one_ray((0.5, 10.5, 2.5), (1.0, 0.0, 0.0))
    t_cap = None if cap is None else torch.tensor([cap])
    assert pdda.substeps(o, d, tables, tp, t_cap) == columns
    assert not bool(pdda.trace(o, d, tables, tp, t_cap).hit[0])


def test_substeps_zero_for_a_ray_that_misses_from_the_start():
    tables, tp = _pillar_world()
    o, d = _one_ray((-5.0, 10.0, 10.0), (-1.0, 0.0, 0.0))
    assert pdda.substeps(o, d, tables, tp) == 0
    assert pdda.substeps(o, d, tables, tp, any_hit=True) == 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_substeps_sum_over_the_rays(world, any_hit):
    """A ray set's count is the sum of its rays' counts, one ray at a time."""
    cfg, jw, tables, tp, b2m = world
    o, d = _rays(5, 64, "random")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).reshape(-1)
    o, d = tuple(T(a) for a in o), tuple(T(a) for a in d)
    ptp = pdda.TraceParams(*tp)
    total = pdda.substeps(o, d, tables, ptp, any_hit=any_hit)
    each = [pdda.substeps(tuple(a[i:i + 1] for a in o),
                          tuple(a[i:i + 1] for a in d), tables, ptp,
                          any_hit=any_hit) for i in range(64)]
    assert total == sum(each)
    assert 64 < total < 64 * MAX_STEPS
