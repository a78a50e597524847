"""Live entities in the port's Engine against the JAX Engine:

* `entity_buffers()` with the walking character over 3 frames (on the
  canonical world: 16 flower rows + 72, a 128-row soup; with a lantern:
  64 + 72, 256 rows) and with an unskinned cuboid entity (the model
  transform alone): `tri_packed`, `normals` and `prev_v0/1/2` within
  1e-5, `mat_index`, `light_slot`, `uvs` and `image_id` exact; the
  soup's tensors keep their addresses over the frames;
* whole frames with the character in view at 64×64 (the camera of
  tests/test_models.py test_character_textured_albedo), walking between
  the two frames, through the harness of tests/test_torch_fused_slice.py
  at its bars: G-buffers within 1e-4 on ≥ 99.9% of pixels, u8 mean |Δ|
  ≤ 1.0 and ≥ 90% of pixels within 3/255 (the JAX side compiles its
  frame once for the 128-row soup);
* the port's counterparts of two JAX tests: the character changes the
  depth (tests/test_render.py test_entity_changes_image) and
  `entity_in_bounces=False` changes the mirror frame beside the shader
  balls (test_golden_character_reflection, without its golden);
* the budget: past 256 triangles `entity_buffers` refuses, as JAX's."""
import numpy as np
import pytest
import torch

from rtvb_tpu.assets import blocks as JB
from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.models import character as jchar
from rtvb_tpu.models import entity as jent
from rtvb_tpu.render.renderer import Engine as JEngine
from rtvb_tpu_torch import interop
from rtvb_tpu_torch.assets import blocks as PB
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.models import character as pchar
from rtvb_tpu_torch.render.renderer import Engine
from test_torch_fused_slice import (W, H, _gbuffers_match,
                                    _jax_trace_denoise_fn, _shipped,
                                    _two_frames, _u8_matches)

torch.set_num_threads(2)

SIZE = 32
CHAR_POS = (31.5, 8.0, 45.0)
CLOSE_UP = dict(pos=(33.0, 9.0, 46.0), yaw=3.8, pitch=-0.3)
LANTERN_XZ = (40, 40)
DT = 1.0 / 30.0


def _engines():
    st = Settings().replace(rendering={"render_width": SIZE,
                                       "render_height": SIZE,
                                       "use_restir": False})
    je = JEngine(settings=JSettings.from_dict(st.to_dict()), width=SIZE,
                 height=SIZE)
    return je, Engine(settings=st, device="cpu")


def _characters(je, pe):
    jch = jchar.Character(cfg_world=je.cfg,
                          move=je.settings.character_movement)
    pch = pchar.Character(cfg_world=pe.cfg,
                          move=pe.settings.character_movement)
    for ch in (jch, pch):
        ch.position = np.array(CHAR_POS, np.float32)
        ch._update_pose()
    je.add_entity(jch.entity)
    pe.add_entity(pch.entity)
    return jch, pch


def _cuboids(je, pe):
    """An unskinned box entity (no joints: the model matrix alone)."""
    p, n, u, i = jent.make_cuboid((0.0, 0.5, 0.0), (0.6, 1.0, 0.4))
    jm = jent.MeshData(positions=p, normals=n, uvs=u, indices=i)
    je_box = jent.Entity(mesh=jm, material="brick",
                         position=np.array([30.0, 9.0, 44.0], np.float32),
                         yaw=0.4)
    pe_box = interop.entity(je_box)
    je.add_entity(je_box)
    pe.add_entity(pe_box)
    return je_box, pe_box


def _assert_buffers_match(jb, pb):
    for f in ("tri_packed", "normals", "prev_v0", "prev_v1", "prev_v2"):
        np.testing.assert_allclose(getattr(pb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    for f in ("mat_index", "light_slot", "uvs", "image_id"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


@pytest.mark.parametrize("scene,rows", [("flowers", 128), ("lantern", 256),
                                        ("box", 128)])
def test_entity_buffers_walk_matches_jax(scene, rows):
    je, pe = _engines()
    if scene == "lantern":
        x, z = LANTERN_XZ
        h = int(np.asarray(je.world.blocks[x, :, z]).nonzero()[0].max())
        je.set_block(x, h + 1, z, JB.LANTERN)
        pe.set_block(x, h + 1, z, PB.LANTERN)
    jch, pch = _characters(je, pe)
    box = _cuboids(je, pe) if scene == "box" else None
    ptrs = None
    for i in range(3):
        jch.update(je.world, DT, (1.0, 0.3), run=i == 2)
        pch.update(pe.host_world, DT, (1.0, 0.3), run=i == 2)
        if box is not None:
            for b in box:
                b.yaw += 0.2
                b.set_pose(b.model_matrix_np())
        jb, pb = je.entity_buffers(), pe.entity_buffers()
        assert pb.tri_packed.shape == (rows, 9)
        _assert_buffers_match(jb, pb)
        now = [t.data_ptr() for t in pb]
        assert ptrs is None or now == ptrs, f"frame {i}: a soup tensor moved"
        ptrs = now
    n_char = pch.entity.mesh.n_triangles
    img = pb.image_id.numpy()
    assert (img >= 0).sum() == n_char == 72
    # the entity rows moved with the walk: current ≠ previous vertices
    n_dec = len(pe._decoration_triangles()[0])
    rows_e = slice(n_dec, n_dec + n_char)
    assert not torch.equal(pb.tri_packed[rows_e, :3], pb.prev_v0[rows_e])


def test_entity_budget_is_refused():
    _, pe = _engines()
    ch = pchar.Character(cfg_world=pe.cfg)
    for _ in range(4):              # 16 + 4 × 72 > 256
        pe.add_entity(ch.entity)
    with pytest.raises(AssertionError):
        pe.entity_buffers()


# ---------------------------------------------------------------------------
# whole frames with the character in view (64×64)
# ---------------------------------------------------------------------------

def _with_character(je):
    ch = jchar.Character(cfg_world=je.cfg,
                         move=je.settings.character_movement)
    ch.position = np.array(CHAR_POS, np.float32)
    ch._update_pose()
    je.add_entity(ch.entity)
    je.set_camera(**CLOSE_UP)
    je._test_character = ch


def _walk(je):
    je._test_character.update(je.world, 1.0 / 60.0, (1.0, 0.0))


@pytest.fixture(scope="module")
def frames():
    settings = _shipped(W, H)
    je = JEngine(settings=JSettings.from_dict(settings.to_dict()),
                 backend="xla")
    return _two_frames(settings, _jax_trace_denoise_fn(je),
                       setup=_with_character, step=_walk)


def test_character_frame1_gbuffers_match(frames):
    f = frames[0]
    ent = f["port"].entity_buffers()
    assert ent.tri_packed.shape[0] == 128
    assert int((ent.image_id >= 0).sum()) == 72
    _gbuffers_match(f)


@pytest.mark.parametrize("frame", [0, 1])
def test_character_whole_frame_u8_matches(frames, frame):
    _u8_matches(frames[frame], W, f"character whole frame {frame + 1}")


def test_character_fills_the_close_up(frames):
    """The character is in view: its triangles hold the nearest hits of a
    block of pixels (depth under 4 where the terrain lies farther)."""
    g, _ = frames[1]["port"].render_gbuffers()
    depth = g.depth.numpy()
    assert ((depth > 0.5) & (depth < 4.0)).sum() > 200


# ---------------------------------------------------------------------------
# the port's counterparts of two JAX tests
# ---------------------------------------------------------------------------

def test_entity_changes_image():
    """tests/test_render.py test_entity_changes_image: a character placed
    in view changes the depth of some pixels of frame 0."""
    eng = Engine(settings=Settings(), width=96, height=96, device="cpu")
    g0 = eng.path_trace()
    ch = pchar.Character(cfg_world=eng.cfg)
    ch.position = np.array([36.0, 14.0, 20.0], np.float32)
    ch.update(eng.host_world, 1.0 / 30.0)
    eng.add_entity(ch.entity)
    eng.frame_index = 0             # the same RNG as frame 0
    g1 = eng.path_trace()
    changed = (np.abs(g0.depth.numpy() - g1.depth.numpy()) > 0.01).mean()
    assert changed > 0.001, changed


def test_entity_in_bounces_changes_the_mirror():
    """tests/test_render.py test_golden_character_reflection without its
    golden: beside the mirror shader ball the character appears in
    secondary rays only with entity_in_bounces."""
    def render(in_bounces: bool):
        s = Settings().replace(rendering={"entity_in_bounces": in_bounces})
        eng = Engine(settings=s, width=64, height=64, device="cpu")
        ch = pchar.Character(cfg_world=eng.cfg,
                             move=eng.settings.character_movement)
        ch.position = np.array(CHAR_POS, np.float32)
        ch._update_pose()
        eng.add_entity(ch.entity)
        eng.set_camera(pos=(33.5, 8.6, 46.5), yaw=3.95, pitch=-0.25)
        out = None
        for _ in range(4):
            out = eng.render_accumulated()
        return out

    on, off = render(True), render(False)
    assert np.abs(on - off).max() > 0.05
