"""The port's models package and model loader against the JAX package's,
on the same inputs (made from a seed with numpy):

* skeleton: quat_to_mat3 / trs_to_mat4, global and skinning matrices on
  host arrays — exact (the same numpy arithmetic, the character's pose
  path); the torch path against the JAX package's jnp path within 1e-6
  (relative for the skinning matrices' products);
* animation: `evaluate` inside a clip and across its loop wrap, `blend`,
  `additive`, `_slerp` near antipodal quaternions — within 1e-6;
* skinning: `skin_vertices` in torch against the jnp version — within
  1e-6 absolute;
* entity: `model_matrix_np`, `set_pose`'s previous-pose shift,
  `update_vertices` / `triangles`, `make_cuboid`, `merge_meshes` — within
  1e-6 (exact for the host-built meshes);
* the loader: `load_model("data/models/character.glb")` and
  `load_obj("data/models/flower.obj")` field by field, bit for bit; a
  glTF written with a strided accessor, normalized weights, a STEP and a
  CUBICSPLINE sampler, bit for bit;
* the character: 60 frames of `Character.update` under a scripted input
  (walk, run, jump, a placing layer, then a wall placed in its path
  between two frames): position, velocity, yaw, state, blend and
  joint_mats within 1e-5 every frame; the port's character reads the
  engine's host grid keyed by the world version, so the wall that lands
  between frames stops it as it stops the JAX character."""
import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvb_tpu.assets import blocks as JB
from rtvb_tpu.assets import models as jio
from rtvb_tpu.models import animation as janim
from rtvb_tpu.models import character as jchar
from rtvb_tpu.models import entity as jent
from rtvb_tpu.models import skeleton as jskel
from rtvb_tpu.models import skinning as jskin
from rtvb_tpu.world import gen as jgen
from rtvb_tpu.world import voxel as jvoxel
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.assets import models as pio
from rtvb_tpu_torch.core.config import CharacterMovementSettings
from rtvb_tpu_torch.models import animation as panim
from rtvb_tpu_torch.models import character as pchar
from rtvb_tpu_torch.models import entity as pent
from rtvb_tpu_torch.models import skeleton as pskel
from rtvb_tpu_torch.models import skinning as pskin
from rtvb_tpu_torch.world import voxel as pvoxel

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARACTER = os.path.join(ROOT, "data", "models", "character.glb")
FLOWER = os.path.join(ROOT, "data", "models", "flower.obj")


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _skeleton_pair(seed):
    """A 7-joint skeleton (the character's hierarchy) with random binds,
    as the JAX package's and the port's."""
    rng = np.random.default_rng(seed)
    parents = np.array([-1, 0, 1, 1, 1, 0, 0], np.int32)
    bt = rng.normal(size=(7, 3)).astype(np.float32)
    br = _quats(rng, 7)
    bs = rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32)
    inv = rng.normal(size=(7, 4, 4)).astype(np.float32)
    names = [f"j{i}" for i in range(7)]
    return (jskel.Skeleton(names, parents, bt, br, bs, inv),
            pskel.Skeleton(names, parents, bt, br, bs, inv), rng)


def test_trs_to_mat4_exact():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    r = _quats(rng, 5)
    s = rng.uniform(0.5, 2.0, (5, 3)).astype(np.float32)
    np.testing.assert_array_equal(pskel.trs_to_mat4(t, r, s),
                                  jskel.trs_to_mat4(t, r, s))
    np.testing.assert_array_equal(pskel.quat_to_mat3(r),
                                  jskel.quat_to_mat3(r))
    got = pskel.trs_to_mat4(*(torch.from_numpy(a) for a in (t, r, s)))
    want = np.asarray(jskel.trs_to_mat4(*(jnp.asarray(a) for a in (t, r, s))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_skeleton_matrices_exact(seed):
    js, ps, rng = _skeleton_pair(seed)
    np.testing.assert_array_equal(ps.order, js.order)
    pose = (rng.normal(size=(7, 3)).astype(np.float32), _quats(rng, 7),
            rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32))
    model = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(ps.global_matrices(*pose),
                                  js.global_matrices(*pose))
    np.testing.assert_array_equal(ps.skinning_matrices(*pose, model=model),
                                  js.skinning_matrices(*pose, model=model))
    for a, b in zip(ps.bind_pose_np(), js.bind_pose_np()):
        np.testing.assert_array_equal(a, b)
    # the torch path against the jnp path
    got = ps.skinning_matrices(*ps.bind_pose())
    want = js.skinning_matrices(*js.bind_pose())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _clip_pair():
    jm = jchar.build_character_mesh()
    return jm.clips, interop.mesh_data(jm).clips


@pytest.mark.parametrize("name", ["idle", "walk", "run", "place"])
def test_clip_resampling_equal(name):
    jc, pc = _clip_pair()
    pclip = pchar.build_character_mesh().clips[name]
    for a, b in zip(pclip.host_tracks(), jc[name].host_tracks()):
        np.testing.assert_array_equal(a, b)
    assert pclip.duration == jc[name].duration
    assert pc[name].n_frames == jc[name].n_frames


@pytest.mark.parametrize("loop", [True, False])
def test_evaluate_inside_and_across_the_wrap(loop):
    jc, _ = _clip_pair()
    clip = pchar.build_character_mesh().clips["walk"]
    d = clip.duration
    for time in (0.0, 0.13, d * 0.5, d - 1e-4, d, d + 0.07, 3.3 * d):
        got = panim.evaluate(clip.host_tracks(), time, d, loop)
        want = janim.evaluate(jc["walk"].host_tracks(), time, d, loop)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_blend_additive_slerp():
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(7, 3)).astype(np.float32), _quats(rng, 7),
         rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32))
    b = (rng.normal(size=(7, 3)).astype(np.float32), _quats(rng, 7),
         rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32))
    ref = (rng.normal(size=(7, 3)).astype(np.float32), _quats(rng, 7),
           rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32))
    for alpha in (0.0, 0.3, 1.0):
        for x, y in zip(panim.blend(a, b, alpha), janim.blend(a, b, alpha)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    for w in (0.0, 0.8):
        for x, y in zip(panim.additive(a, b, ref, w),
                        janim.additive(a, b, ref, w)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(panim.quat_mul(a[1], b[1]),
                               janim.quat_mul(a[1], b[1]), rtol=0, atol=1e-6)
    # near antipodal (q1 ≈ -q0, the sign flip) and near parallel (nlerp)
    q0 = _quats(rng, 6)
    eps = rng.normal(size=(6, 4)).astype(np.float32) * 1e-5
    for q1 in (-q0 + eps, q0 + eps, _quats(rng, 6)):
        q1 = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
        for t in (0.25, 0.5):
            tt = np.full((6, 1), t, np.float32)
            np.testing.assert_allclose(panim._slerp(q0, q1, tt),
                                       janim._slerp(q0, q1, tt),
                                       rtol=0, atol=1e-6)


def test_skin_vertices_matches_jax():
    rng = np.random.default_rng(7)
    n, j = 200, 7
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    joints = rng.integers(0, j, (n, 4)).astype(np.int32)
    weights = rng.random((n, 4)).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    mats = rng.normal(size=(j, 4, 4)).astype(np.float32)
    sp, sn = pskin.skin_vertices(*(torch.from_numpy(a) for a in (
        pos, nrm, joints, weights, mats)))
    jp, jn = jskin.skin_vertices(*(jnp.asarray(a) for a in (
        pos, nrm, joints, weights, mats)))
    np.testing.assert_allclose(sp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sn.numpy(), np.asarray(jn), rtol=0, atol=1e-6)
    sp2 = pskin.skin_positions(*(torch.from_numpy(a) for a in (
        pos, joints, weights, mats)))
    assert torch.equal(sp2, sp)


def test_entity_pose_and_vertices():
    jm = jchar.build_character_mesh()
    pm = interop.mesh_data(jm)
    je = jent.Entity(mesh=jm, position=np.array([3.0, 4.0, 5.0], np.float32),
                     yaw=0.7, scale=1.3)
    pe = pent.Entity(mesh=pm, position=np.array([3.0, 4.0, 5.0], np.float32),
                     yaw=0.7, scale=1.3)
    np.testing.assert_array_equal(pe.model_matrix_np(), je.model_matrix_np())
    rng = np.random.default_rng(2)
    m1 = rng.normal(size=(7, 4, 4)).astype(np.float32)
    m2 = rng.normal(size=(7, 4, 4)).astype(np.float32)
    for e in (je, pe):
        e.set_pose(m1)
    # the first pose is its own previous pose
    np.testing.assert_array_equal(pe.prev_joint_mats, je.prev_joint_mats)
    np.testing.assert_array_equal(pe.prev_joint_mats, m1)
    for e in (je, pe):
        e.set_pose(m2)
    np.testing.assert_array_equal(pe.prev_joint_mats, m1)
    np.testing.assert_array_equal(pe.joint_mats, m2)
    skin = jm.skeleton.skinning_matrices(*jm.skeleton.bind_pose_np())
    je.update_vertices(jnp.asarray(skin))
    pe.update_vertices(skin)
    for a, b in zip(pe.triangles(), je.triangles()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    for a, b in zip(pent.make_cuboid((1, 2, 3), (0.5, 0.2, 0.7), 2.0),
                    jent.make_cuboid((1, 2, 3), (0.5, 0.2, 0.7), 2.0)):
        np.testing.assert_array_equal(a, b)
    assert pent.ENTITY_ID_BASE == jent.ENTITY_ID_BASE


def _assert_mesh_equal(pm, jm):
    for f in ("positions", "normals", "uvs", "indices", "joints", "weights"):
        a, b = getattr(pm, f), getattr(jm, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if jm.skeleton is None:
        assert pm.skeleton is None
    else:
        ps, js = pm.skeleton, jm.skeleton
        assert ps.names == js.names
        for f in ("parents", "bind_t", "bind_r", "bind_s", "inverse_bind",
                  "order"):
            np.testing.assert_array_equal(getattr(ps, f), getattr(js, f),
                                          err_msg=f)
    assert sorted(pm.clips) == sorted(jm.clips)
    for name, jc in jm.clips.items():
        pc = pm.clips[name]
        assert (pc.name, pc.duration, pc.loop) == (jc.name, jc.duration,
                                                   jc.loop)
        for a, b in zip(pc.host_tracks(), jc.host_tracks()):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_load_character_glb_bit_exact():
    pm, jm = pio.load_model(CHARACTER), jio.load_model(CHARACTER)
    assert (pm.n_triangles, len(pm.positions), pm.skeleton.n_joints) == \
        (72, 144, 7)
    assert sorted(pm.clips) == ["idle", "place", "run", "walk"]
    _assert_mesh_equal(pm, jm)
    _assert_mesh_equal(pchar.load_character_mesh(),
                       jchar.load_character_mesh())


def test_load_flower_obj_bit_exact():
    _assert_mesh_equal(pio.load_obj(FLOWER), jio.load_obj(FLOWER))
    _assert_mesh_equal(pio.load_model(FLOWER), jio.load_model(FLOWER))


def test_obj_without_normals_and_uv(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                    "f 1/1 2/2 3/3 4/4\n")
    _assert_mesh_equal(pio.load_obj(str(path)), jio.load_obj(str(path)))
    with pytest.raises(ValueError):
        pio.load_model(str(tmp_path / "mesh.fbx"))


def _write_gltf(path, seed):
    """A one-triangle skinned glTF with two joints, a strided POSITION
    accessor, normalized u8 weights, and STEP / CUBICSPLINE / LINEAR
    samplers."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(3, 3)).astype(np.float32)
    padded = np.concatenate([pos, np.zeros((3, 1), np.float32)], 1)
    idx = np.array([0, 1, 2], np.uint16)
    joints = np.array([[0, 1, 0, 0]] * 3, np.uint8)
    weights = np.array([[200, 55, 0, 0]] * 3, np.uint8)
    inv = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    inv[1, 3, :3] = [0.0, -1.0, 0.0]
    t_step = np.array([0.0, 0.5, 1.0], np.float32)
    v_step = rng.normal(size=(3, 3)).astype(np.float32)
    t_cub = np.array([0.0, 1.0], np.float32)
    q = _quats(rng, 2)
    v_cub = np.stack([np.zeros((2, 4), np.float32), q,
                      np.zeros((2, 4), np.float32)], 1).reshape(6, 4)
    t_lin = np.array([0.0, 0.25, 1.25], np.float32)
    v_lin = rng.uniform(0.5, 1.5, (3, 3)).astype(np.float32)
    chunks, views, accs = [], [], []

    def add(arr, ctype, typ, count, stride=None, normalized=False):
        off = sum(len(c) for c in chunks)
        data = arr.tobytes()
        chunks.append(data + b"\0" * (-len(data) % 4))
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if stride:
            view["byteStride"] = stride
        views.append(view)
        acc = {"bufferView": len(views) - 1, "componentType": ctype,
               "type": typ, "count": count}
        if normalized:
            acc["normalized"] = True
        accs.append(acc)
        return len(accs) - 1
    a_pos = add(padded, 5126, "VEC3", 3, stride=16)
    a_idx = add(idx, 5123, "SCALAR", 3)
    a_j = add(joints, 5121, "VEC4", 3)
    a_w = add(weights, 5121, "VEC4", 3, normalized=True)
    a_inv = add(inv.transpose(0, 2, 1).copy(), 5126, "MAT4", 2)
    a_ts, a_vs = add(t_step, 5126, "SCALAR", 3), add(v_step, 5126, "VEC3", 3)
    a_tc, a_vc = add(t_cub, 5126, "SCALAR", 2), add(v_cub, 5126, "VEC4", 6)
    a_tl, a_vl = add(t_lin, 5126, "SCALAR", 3), add(v_lin, 5126, "VEC3", 3)
    doc = {
        "asset": {"version": "2.0"},
        "nodes": [{"mesh": 0, "skin": 0},
                  {"name": "root", "children": [2],
                   "translation": [0.0, 0.5, 0.0]},
                  {"name": "tip", "translation": [0.0, 1.0, 0.0],
                   "rotation": [0.0, 0.0, 0.0, 1.0]}],
        "meshes": [{"primitives": [{"attributes": {
            "POSITION": a_pos, "JOINTS_0": a_j, "WEIGHTS_0": a_w},
            "indices": a_idx}]}],
        "skins": [{"joints": [1, 2], "inverseBindMatrices": a_inv}],
        "animations": [{"name": "mixed", "samplers": [
            {"input": a_ts, "output": a_vs, "interpolation": "STEP"},
            {"input": a_tc, "output": a_vc, "interpolation": "CUBICSPLINE"},
            {"input": a_tl, "output": a_vl, "interpolation": "LINEAR"}],
            "channels": [
                {"sampler": 0, "target": {"node": 1, "path": "translation"}},
                {"sampler": 1, "target": {"node": 2, "path": "rotation"}},
                {"sampler": 2, "target": {"node": 2, "path": "scale"}}]}],
        "accessors": accs, "bufferViews": views,
        "buffers": [{"byteLength": sum(len(c) for c in chunks)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    binary = b"".join(chunks)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(binary)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(binary), 0x004E4942) + binary)


@pytest.mark.parametrize("seed", [0, 1])
def test_load_gltf_features_bit_exact(tmp_path, seed):
    path = str(tmp_path / "rig.glb")
    _write_gltf(path, seed)
    pm, jm = pio.load_model(path), jio.load_model(path)
    assert pm.skeleton.parents.tolist() == [-1, 0]
    assert "mixed" in pm.clips
    _assert_mesh_equal(pm, jm)


# ---------------------------------------------------------------------------
# the character: 60 scripted frames against the JAX character
# ---------------------------------------------------------------------------

DT = 1.0 / 30.0
N_FRAMES = 60
WALL_FRAME = 24        # the wall lands before this frame's update


def _script(i):
    """(move_input, run, jump, placing) of frame i: walk along +x, run
    and jump, walk, run into the wall placing blocks, run diagonally and
    jump, stand (placing at the end)."""
    if i < 12:
        return (1.0, 0.0), False, False, False
    if i < 20:
        return (1.0, 0.0), True, i == 14, False
    if i < WALL_FRAME:
        return (1.0, 0.0), False, False, False
    if i < 38:
        return (1.0, 0.0), True, False, 26 <= i < 31
    if i < 48:
        return (0.6, 0.8), True, i == 40, False
    return (0.0, 0.0), False, False, i >= 55


def _wall(jblocks, pos):
    """Brick voxels across the +x path two columns ahead of `pos`, from
    the ground up 3 high → (xyz, the wall's x)."""
    x = int(np.floor(pos[0])) + 2
    z0 = int(np.floor(pos[2]))
    xyz = []
    for z in range(z0 - 2, z0 + 3):
        ground = int(np.nonzero(jblocks[x, :, z])[0].max())
        xyz += [(x, y, z) for y in range(ground + 1, ground + 4)]
    return np.array(xyz, np.int32), x


@pytest.fixture(scope="module")
def walks():
    """Both characters over the scripted frames, from the ground at (20.5,
    30.5); the port's reads a HostWorld whose version the wall's edit
    bumps."""
    cfg, jw = jgen.generate_world()
    pcfg = pvoxel.WorldConfig()
    jch = jchar.Character(cfg_world=cfg)
    pch = pchar.Character(cfg_world=pcfg, move=CharacterMovementSettings())
    ground = int(np.nonzero(np.asarray(jw.blocks)[20, :, 30])[0].max())
    for ch in (jch, pch):
        ch.position = np.array([20.5, ground + 1.2, 30.5], np.float32)
    host = pvoxel.HostWorld(blocks=np.asarray(jw.blocks), version=0)
    out = []
    wall_x = None
    for i in range(N_FRAMES):
        if i == WALL_FRAME:
            xyz, wall_x = _wall(np.asarray(jw.blocks), jch.position)
            jw = jvoxel.set_blocks(cfg, jw, xyz,
                                   np.full(len(xyz), JB.BRICK, np.uint8))
            host = pvoxel.HostWorld(blocks=np.asarray(jw.blocks),
                                    version=host.version + 1)
        move, run, jump, placing = _script(i)
        jch.update(jw, DT, move, run, jump, placing)
        pch.update(host, DT, move, run, jump, placing)
        out.append(dict(
            j=(jch.position.copy(), jch.velocity.copy(), jch.yaw, jch.state,
               jch.blend, jch.entity.joint_mats.copy(),
               jch.entity.prev_joint_mats.copy(), jch.on_ground),
            p=(pch.position.copy(), pch.velocity.copy(), pch.yaw, pch.state,
               pch.blend, pch.entity.joint_mats.copy(),
               pch.entity.prev_joint_mats.copy(), pch.on_ground),
            cache=pch._blocks_cache[0], version=host.version, wall_x=wall_x))
    return out


@pytest.mark.parametrize("frame", list(range(0, N_FRAMES, 6))
                         + [WALL_FRAME, N_FRAMES - 1])
def test_character_update_matches_jax(walks, frame):
    for f in walks[:frame + 1]:
        jpos, jvel, jyaw, jstate, jblend, jm, jpm, jg = f["j"]
        ppos, pvel, pyaw, pstate, pblend, pm, ppm, pg = f["p"]
        np.testing.assert_allclose(ppos, jpos, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pvel, jvel, rtol=0, atol=1e-5)
        assert abs(pyaw - jyaw) <= 1e-5
        assert (pstate, pg) == (jstate, jg)
        assert abs(pblend - jblend) <= 1e-5
        np.testing.assert_allclose(pm, jm, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ppm, jpm, rtol=0, atol=1e-5)


def test_character_script_covers_its_states(walks):
    states = {f["p"][3] for f in walks}
    assert states == {"idle", "walk", "run"}
    assert any(not f["p"][7] for f in walks[12:20])      # airborne: jumped


def test_character_reads_the_edited_grid_by_version(walks):
    """Before the wall the cache holds version 0, from its frame on
    version 1; the wall then stops the run along +x: the body's +x sample
    point never enters the wall's column, and it gets there."""
    assert [f["cache"] for f in walks] == \
        [f["version"] for f in walks] == \
        [0] * WALL_FRAME + [1] * (N_FRAMES - WALL_FRAME)
    wall_x = walks[-1]["wall_x"]
    r = CharacterMovementSettings().body_radius
    xs = [f["p"][0][0] for f in walks[WALL_FRAME:38]]
    assert max(xs) < wall_x - r, (xs, wall_x)
    assert max(xs) > wall_x - r - 0.16, (xs, wall_x)
    assert walks[37]["p"][1][0] > 0          # it still runs into it


def test_interop_character_carries_state(walks):
    cfg, _ = jgen.generate_world()
    jch = jchar.Character(cfg_world=cfg)
    jch.position = np.array([20.5, 9.0, 30.5], np.float32)
    jch.state, jch.blend, jch.anim_time = "run", 0.4, 1.7
    jch._update_pose()
    pch = interop.character(jch)
    assert (pch.state, pch.blend, pch.anim_time) == ("run", 0.4, 1.7)
    np.testing.assert_array_equal(pch.entity.joint_mats,
                                  jch.entity.joint_mats)
    _assert_mesh_equal(pch.entity.mesh, jch.entity.mesh)
    assert pch.entity.image == jch.entity.image == "character_albedo"
