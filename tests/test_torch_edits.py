"""World edits of the port against the JAX package: the tables after
`set_block` / `set_blocks` equal to the bit (the JAX package's (R, 128)
rows flattened), `exception_count`, the exception list's power-of-two
growth, the light-slot remap through a lantern's placement, an unrelated
edit and the lantern's removal, the decoration soup after an edit, and
the camera-centre pick.  Every comparison is exact: the edit path is
integer work, and the soup's vertices are the same float32 sums on both
sides."""
import numpy as np
import pytest
import torch

from rtvb_tpu.assets import blocks as JB
from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.render.renderer import Engine as JEngine
from rtvb_tpu.world import gen as jgen
from rtvb_tpu.world import voxel as jvoxel
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.assets import blocks as PB
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render.renderer import Engine
from rtvb_tpu_torch.world import voxel as pvoxel

torch.set_num_threads(2)

SIZE = 32
LANTERN_XZ = (40, 40)


def _settings():
    return Settings().replace(rendering={"render_width": SIZE,
                                         "render_height": SIZE,
                                         "use_restir": False})


def _engines():
    st = _settings()
    je = JEngine(settings=JSettings.from_dict(st.to_dict()), width=SIZE,
                 height=SIZE)
    pe = Engine(settings=st, device="cpu")
    return je, pe


def _assert_world_equal(jw, pw):
    """Every table of the port's world equal to the JAX world's, bits."""
    ref = interop.world(jw)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(pw, f).numpy(),
                                      getattr(ref, f).numpy(), err_msg=f)


def _assert_soup_equal(je, pe):
    jb, pb = je.entity_buffers(), pe.entity_buffers()
    for f in ("tri_packed", "normals", "mat_index", "light_slot"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def test_block_ids_agree():
    assert (PB.LANTERN, PB.BRICK, PB.SAND) == (JB.LANTERN, JB.BRICK,
                                                 JB.SAND)


@pytest.mark.parametrize("edit", ["lantern_in_air", "sand_on_ground",
                                  "dig_terrain"])
def test_set_block_tables_match_jax(edit):
    cfg, jw = jgen.generate_world()
    pcfg = pvoxel.WorldConfig()
    pw = interop.world(jw)
    h = int(np.asarray(jw.blocks[20, :, 30]).nonzero()[0].max())
    x, y, z, bid = {"lantern_in_air": (10, 20, 10, JB.LANTERN),
                    "sand_on_ground": (20, h + 1, 30, JB.SAND),
                    "dig_terrain": (20, h, 30, 0)}[edit]
    jw2 = jvoxel.set_block(cfg, jw, x, y, z, bid)
    pw2 = pvoxel.set_block(pcfg, pw, x, y, z, bid)
    _assert_world_equal(jw2, pw2)
    assert pvoxel.exception_count(pcfg, pw2) == \
        jvoxel.exception_count(cfg, jw2)


def test_set_block_roundtrip():
    """The port's counterpart of tests/test_world.py
    test_set_block_roundtrip: a lantern in the air is an occupied
    exception, and deleting it restores the tables."""
    cfg, jw = jgen.generate_world()
    pcfg = pvoxel.WorldConfig()
    pw = interop.world(jw)
    pw2 = pvoxel.set_block(pcfg, pw, 10, 20, 10, PB.LANTERN)
    assert int(pw2.blocks[10, 20, 10]) == PB.LANTERN
    assert (int(pw2.colmask[10 * pcfg.z + 10]) >> 20) & 1
    keys = [int(k) for k in pw2.exc_key if k < pvoxel.EXC_EMPTY]
    assert (10 * pcfg.z + 10) * pcfg.y + 20 in keys
    pw3 = pvoxel.set_block(pcfg, pw2, 10, 20, 10, 0)
    for f in pw._fields:
        assert torch.equal(getattr(pw3, f), getattr(pw, f)), f


def test_set_blocks_bulk_matches_jax():
    cfg, jw = jgen.generate_world()
    pcfg = pvoxel.WorldConfig()
    rng = np.random.default_rng(3)
    n = 40
    xyz = np.stack([rng.integers(0, cfg.x, n), rng.integers(12, cfg.y, n),
                    rng.integers(0, cfg.z, n)], 1).astype(np.int32)
    ids = rng.choice([JB.BRICK, JB.SAND, JB.LANTERN, 0], n).astype(np.uint8)
    jw2 = jvoxel.set_blocks(cfg, jw, xyz, ids)
    pw2 = pvoxel.set_blocks(pcfg, interop.world(jw), xyz, ids)
    _assert_world_equal(jw2, pw2)


@pytest.fixture(scope="module")
def grown():
    """500 bricks placed in one bulk edit on both engines (the JAX
    package's tests/test_world.py test_exception_table_grows_on_overflow
    placement)."""
    je, pe = _engines()
    xs, zs = np.meshgrid(np.arange(5, 55), np.arange(5, 15))
    n = xs.size
    xyz = np.stack([xs.ravel(), np.full(n, 28), zs.ravel()], axis=1)
    ids = np.full(n, JB.BRICK, np.uint8)
    base_cap = pe.cfg.max_exceptions
    je.set_blocks(xyz, ids)
    pe.set_blocks(xyz, ids)
    return je, pe, xyz, base_cap


def test_exception_list_grows_as_jax(grown):
    """The port's counterpart of test_exception_table_grows_on_overflow:
    the list grows to the same power-of-two bucket and holds every
    placement, tables equal to JAX's."""
    je, pe, xyz, base_cap = grown
    n_exc = pvoxel.exception_count(pe.cfg, pe.world)
    assert n_exc == jvoxel.exception_count(je.cfg, je.world) >= len(xyz)
    assert pe.cfg == pvoxel.WorldConfig(
        **{f: getattr(je.cfg, f) for f in ("chunks_x", "chunks_y",
                                            "chunks_z", "chunk_size",
                                            "max_exceptions")})
    assert pe.cfg.max_exceptions >= n_exc > base_cap
    _assert_world_equal(je.world, pe.world)
    keys = {int(k): int(i) for k, i in zip(pe.world.exc_key,
                                           pe.world.exc_id)
            if k < pvoxel.EXC_EMPTY}
    assert len(keys) == n_exc
    for x, y, z in xyz:
        assert keys[(int(x) * pe.cfg.z + int(z)) * pe.cfg.y + int(y)] \
            == PB.BRICK
    assert pe._tables.exc_key.shape[0] == pe.cfg.max_exceptions


@pytest.fixture(scope="module")
def lantern_edits():
    """The edits of tests/test_lights.py test_light_id_remap_tracks_edit
    on both engines: a lantern on the ground, an unrelated sand block,
    then the lantern deleted.  Records each remap and checks the world
    and the soup after each edit."""
    je, pe = _engines()
    x, z = LANTERN_XZ
    h = int(np.asarray(je.world.blocks[x, :, z]).nonzero()[0].max())
    steps = []

    def record(label, jr, pr):
        steps.append(dict(label=label, j_remap=np.asarray(jr),
                          p_remap=pr.numpy(),
                          j_keys=np.asarray(je.lights.key).copy(),
                          p_keys=pe.lights.key.numpy().copy(),
                          j_remap_live=np.asarray(je._light_remap),
                          p_remap_live=pe._light_remap.numpy()))
        _assert_world_equal(je.world, pe.world)
        _assert_soup_equal(je, pe)
    record("lantern", je.set_block(x, h + 1, z, JB.LANTERN),
           pe.set_block(x, h + 1, z, PB.LANTERN))
    record("sand", je.set_block(10, 20, 10, JB.SAND),
           pe.set_block(10, 20, 10, PB.SAND))
    record("delete", je.delete_block(x, h + 1, z),
           pe.delete_block(x, h + 1, z))
    return steps


@pytest.mark.parametrize("step", [0, 1, 2])
def test_light_id_remap_matches_jax(lantern_edits, step):
    s = lantern_edits[step]
    np.testing.assert_array_equal(s["p_remap"], s["j_remap"])
    np.testing.assert_array_equal(s["p_keys"], s["j_keys"])
    # the remap waits for the next frame
    np.testing.assert_array_equal(s["p_remap_live"], s["j_remap_live"])


def test_light_id_remap_tracks_edit(lantern_edits):
    """The port's counterpart of test_light_id_remap_tracks_edit."""
    lantern, sand, delete = lantern_edits
    for s0 in range(12):
        s1 = sand["p_remap"][s0]
        assert s1 >= 0
        assert sand["p_keys"][s1] == lantern["p_keys"][s0]
    assert (delete["p_remap"][:12] == -1).all()


def test_frame_consumes_the_remap():
    """An edit's remap feeds the next frame, which then resets it to the
    identity, as the JAX engine does after each frame.  The frame reads it
    from the engine's fixed input buffer: the remap's slots, then the
    identity (past the remap's slots no stored reservoir points)."""
    st = _settings().replace(rendering={"render_width": 16,
                                        "render_height": 16})
    pe = Engine(settings=st, device="cpu")
    x, z = LANTERN_XZ
    h = int(pe.world.blocks[x, :, z].nonzero().max())
    pe.set_block(x, h + 1, z, PB.LANTERN)
    remap = pe.delete_block(x, h + 1, z)
    assert pe._light_remap is remap
    seen = []
    from rtvb_tpu_torch.render import pathtracer
    orig = pathtracer.render_frame

    def spy(*a, **kw):
        seen.append(kw["light_remap"])
        return orig(*a, **kw)
    pathtracer.render_frame = spy
    try:
        pe.render_realtime()
    finally:
        pathtracer.render_frame = orig
    n = remap.shape[0]
    assert torch.equal(seen[0][:n], remap)
    assert torch.equal(seen[0][n:], torch.arange(n, seen[0].shape[0],
                                                 dtype=torch.int32))
    assert torch.equal(pe._light_remap,
                       torch.arange(pe.lights.key.shape[0],
                                    dtype=torch.int32))


def test_lantern_soup_matches_jax():
    """A lantern grows the soup (16 flower rows → 64 slots), the port's
    rows, materials and light slots equal to JAX's entity_buffers()."""
    je, pe = _engines()
    n0 = pe.entity_buffers().tri_packed.shape[0]
    x, z = LANTERN_XZ
    h = int(np.asarray(je.world.blocks[x, :, z]).nonzero()[0].max())
    je.set_block(x, h + 1, z, JB.LANTERN)
    pe.set_block(x, h + 1, z, PB.LANTERN)
    _assert_soup_equal(je, pe)
    assert pe.entity_buffers().tri_packed.shape[0] > n0
    assert (pe.entity_buffers().light_slot >= 0).sum() == 12


@pytest.mark.parametrize("pose,hits", [
    (((32.0, 14.0, 8.0), 1.1, -0.9), True),
    (((20.0, 12.0, 30.0), 0.3, -1.3), True),
    (((32.0, 18.0, 8.0), 1.1, -0.35), False)])     # past max_dist
def test_pick_block_matches_jax(pose, hits):
    je, pe = _engines()
    pos, yaw, pitch = pose
    je.set_camera(pos=pos, yaw=yaw, pitch=pitch)
    pe.set_camera(pos=pos, yaw=yaw, pitch=pitch)
    jp, pp = je.pick_block(), pe.pick_block()
    assert jp[0] == pp[0] == hits
    if hits:
        assert pp[1] == jp[1]
        assert pp[2] == jp[2]


# ---------------------------------------------------------------------------
# edits in place: the graph's key stands unless a shape changes
# ---------------------------------------------------------------------------

def _graph_key(pe):
    """What a captured frame is keyed by (Engine._graph_frames): the
    identity of every tensor it reads (addresses, shapes, and the value
    of every non-tensor leaf), the world configuration, the trace
    parameters and the local-light count."""
    from rtvb_tpu_torch.render import frame_graph
    pe._ensure_states()
    pe.entity_buffers()
    pe._stage()
    return (frame_graph.identity(pe._graph_inputs()), pe.cfg, pe._tp,
            pe._n_local)


def _assert_tables_fresh(pe):
    """Every device table equals a fresh rebuild from the device's own
    block grid, bit for bit: the world's tables, the trace tables, the
    light table, the soup's static rows."""
    from rtvb_tpu_torch.ops.dda import trace_tables
    from rtvb_tpu_torch.render import soup as soup_mod
    from rtvb_tpu_torch.world import lighting as plight
    blocks = pe.world.blocks.numpy()
    fresh = pvoxel.build_tables_np(pe.cfg, blocks, pe.world.schema.numpy(),
                                   pe._nonsolid_ids())
    for f in pvoxel.VoxelWorld._fields:
        np.testing.assert_array_equal(getattr(pe.world, f).numpy(),
                                      fresh[f], err_msg=f)
    fresh_world = pvoxel.world_from_numpy(fresh)
    for f, a, b in zip(pe._tables._fields, pe._tables,
                       trace_tables(fresh_world, pe.materials)):
        assert torch.equal(a, b), f
    lights = plight.build_light_table(pe.cfg, fresh_world, pe.materials,
                                      pe.block_registry, pe.decor)
    for f, a, b in zip(lights._fields, pe.lights, lights):
        assert torch.equal(a, b), f
    ent = pe.entity_buffers()
    decor = pe._decoration_triangles()
    rebuilt = Engine(settings=_settings(), device="cpu")
    rebuilt.world = fresh_world
    rebuilt._tables = trace_tables(fresh_world, rebuilt.materials)
    rebuilt.lights = lights
    for a, b in zip(decor, rebuilt._decoration_triangles()):
        np.testing.assert_array_equal(a, b)
    want = soup_mod.static_arrays(ent.tri_packed.shape[0], decor, [])
    for f in want:
        np.testing.assert_array_equal(getattr(ent, f).numpy(), want[f],
                                      err_msg=f)


@pytest.mark.parametrize("edit", ["dirt block", "dig terrain",
                                  "flower removed"])
def test_edit_keeping_shapes_keeps_the_graph_key(edit):
    """An edit that changes no table's shape writes the tables in place:
    the graph's key is unchanged, every table equals a fresh rebuild, and
    the world, lights and soup equal the JAX engine's after the same
    edit.  Removing a flower rewrites the decoration rows in place (12
    rows of the 16 stand, the rest padding)."""
    je, pe = _engines()
    key0 = _graph_key(pe)
    ptrs = [t.data_ptr() for t in pe.world] + \
        [t.data_ptr() for t in pe.lights]
    if edit == "flower removed":
        x, y, z = (int(v) for v in np.argwhere(
            pe.world.blocks.numpy() == PB.FLOWER)[0])
        bid = 0
    else:
        x, z = 20, 30
        h = int(np.asarray(je.world.blocks[x, :, z]).nonzero()[0].max())
        y, bid = (h + 1, PB.SOIL) if edit == "dirt block" else (h, 0)
    je.set_block(x, y, z, bid)
    pe.set_block(x, y, z, bid)
    assert _graph_key(pe) == key0
    assert [t.data_ptr() for t in pe.world] + \
        [t.data_ptr() for t in pe.lights] == ptrs
    assert pe.world_version == 1 and pe.host_world.version == 1
    _assert_tables_fresh(pe)
    _assert_world_equal(je.world, pe.world)
    _assert_soup_equal(je, pe)
    if edit == "flower removed":
        assert int((pe.entity_buffers().tri_packed != 0).any(-1).sum()) == 12


@pytest.mark.parametrize("edit", ["500 bricks", "first lantern"])
def test_growing_edit_changes_the_graph_key(edit):
    """An edit the JAX package compiles anew for changes the key: 500
    bricks grow the exception list past its 128 entries; the first
    lantern changes the light table's K (8 → 16), the local-light count
    (0 → 8) and the soup's rows (16 → 64)."""
    pe = Engine(settings=_settings(), device="cpu")
    key0 = _graph_key(pe)
    if edit == "500 bricks":
        xs, zs = np.meshgrid(np.arange(5, 55), np.arange(5, 15))
        xyz = np.stack([xs.ravel(), np.full(xs.size, 28), zs.ravel()], 1)
        pe.set_blocks(xyz, np.full(len(xyz), PB.BRICK, np.uint8))
        assert pe.cfg.max_exceptions == 1024
    else:
        x, z = LANTERN_XZ
        h = int(pe.world.blocks[x, :, z].nonzero().max())
        pe.set_block(x, h + 1, z, PB.LANTERN)
        assert pe._n_local == 8 and pe.lights.key.shape[0] == 16
        assert pe.entity_buffers().tri_packed.shape[0] == 64
    assert _graph_key(pe) != key0
    _assert_tables_fresh(pe)
