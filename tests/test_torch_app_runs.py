"""The port's apps on its real CPU Engine at 32×32: two interactive
sessions through the app's own loop (the dig, the lantern, the walking
character, the dev panel, the autosave, the world loaded back), `main
--device cpu`, and the offline app's `--test-sequence` run, whose edited
grid equals the JAX package's `scripted_edits` applied to the same
grid."""
import io
import os
import types

import numpy as np
import pytest
import torch

from rtvb_tpu.apps import offline as joff

from rtvb_tpu_torch.apps import interactive as papp
from rtvb_tpu_torch.apps import offline as poff
from rtvb_tpu_torch.assets.blocks import LANTERN
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.core.scene import SceneConfig
from rtvb_tpu_torch.utils.image import read_png
from rtvb_tpu_torch.world.persistence import WorldStore


class _Collect(papp.Presenter):
    def __init__(self):
        self.frames = []

    def present(self, frame, index):
        self.frames.append((index, frame))


def _keys(lines):
    src = papp.StdinInputSource(stream=io.StringIO(""))
    pending = list(lines)
    src._pending_lines = lambda: [pending.pop(0)] if pending else []
    return src


def _check_frames(frames, shape, first_person=()):
    """Every frame u8 on the CPU; not blank but in the first-person
    camera, which sits inside the character's own mesh (the JAX
    package's camera and soup: ROADMAP Queue 3)."""
    assert len(frames) >= 4
    for i, f in frames:
        assert isinstance(f, torch.Tensor) and f.device.type == "cpu"
        assert tuple(f.shape) == shape and f.dtype == torch.uint8
        if i not in first_person:
            assert float(f.float().std()) > 1.0, i


def _loads_back(store, eng, name="default"):
    """The saved world loads back to the engine's host tables, bit for
    bit."""
    cfg, world, _, _ = store.load(name, eng._nonsolid_ids(), device="cpu")
    host = eng._host_tables()
    for f in ("blocks", "schema", "colmask", "exc_mask", "df_super",
              "maxh_super"):
        assert np.array_equal(getattr(world, f).numpy(), host[f]), f


def test_session_end_to_end(tmp_path):
    """tests/test_interactive.py's scripted session on the port: the dev
    panel, a move, a dig attempt and F5, eight frames, then the autosave;
    frames arrive on the engine's device as u8."""
    store = WorldStore(str(tmp_path / "worlds"))
    pres = _Collect()
    app = papp.InteractiveApp(
        settings=Settings().replace(rendering={"render_width": 32,
                                               "render_height": 32,
                                               "dynamic_resolution": False}),
        scene=SceneConfig(), presenter=pres, store=store, max_frames=8,
        device="cpu")
    app.run(input_source=_keys(["F3", "w", "x", "F5", "", "", "", "quit"]))
    _check_frames(pres.frames, (32, 32, 3))
    assert store.list_worlds() == ["default"]
    assert app.frame_scales == [1.0] * len(app.frame_scales)
    assert app.engine.graph_log == []           # the CPU runs no graphs
    _loads_back(store, app.engine)


class _FixedStepTimer(papp.FrameTimer):
    """A frame timer whose every tick is 1/30 s: a CPU frame takes far
    longer, and the character's physics steps by the frame time."""

    def tick(self) -> float:
        self.dt = 1.0 / 30.0
        return self.dt


def test_session_dig_lantern_walk(tmp_path, monkeypatch):
    """A keyboard session close to the ground: menus, dig the picked block,
    select the lantern (12) and place it on the face below, switch to the
    first-person camera, then the follow camera, and walk, save; dynamic
    resolution on.  The grid has
    the hole filled by the lantern, the light table has its light, the
    character moved, and the saved world loads back bit for bit.  With no
    frame cap the loop starts the light-variant warm-up at frame 0 and
    joins it before returning."""
    monkeypatch.setattr(papp, "FrameTimer", _FixedStepTimer)
    store = WorldStore(str(tmp_path / "worlds"))
    pres = _Collect()
    scene = SceneConfig(camera_pos=(32.0, 14.0, 8.0), camera_pitch=-0.9)
    app = papp.InteractiveApp(
        settings=Settings().replace(rendering={"render_width": 32,
                                               "render_height": 32,
                                               "block_highlight": True}),
        scene=scene, presenter=pres, store=store, auto_start=False,
        device="cpu")
    keys = ["", "enter", "enter", "x", "", "12 b", "c", "c", "w", "w",
            "F5", "quit"]
    app.run(input_source=_keys(keys))
    eng = app.engine
    _check_frames(pres.frames, (32, 32, 3), first_person=(6,))
    blocks = eng.host_world.blocks
    assert blocks[33, 8, 11] == LANTERN              # dug, then refilled
    assert int(eng._host_lights()["count"]) > 0
    assert eng._n_local > 0 and eng.world_version >= 2
    assert store.list_worlds() == ["default"]
    _loads_back(store, eng)


class _GridStub:
    """What JAX's scripted_edits reads and calls, on a host grid."""

    def __init__(self, blocks):
        self.world = types.SimpleNamespace(blocks=blocks)

    def set_block(self, x, y, z, block_id):
        self.world.blocks[x, y, z] = block_id

    def delete_block(self, x, y, z):
        self.world.blocks[x, y, z] = 0


@pytest.mark.parametrize("flag,frames", [("--test-sequence", 12)])
def test_offline_scripted_run(tmp_path, monkeypatch, flag, frames):
    """offline.main on the CPU Engine: the saved frames (1, 4, 16 where
    reached, and the last) are 32×32 and not blank, the run exits 0, and
    the edited grid equals JAX's scripted_edits applied frame by frame to
    the initial grid."""
    made = []

    class Recorded(poff.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
            self.initial_blocks = self.host_world.blocks.copy()

    monkeypatch.setattr(poff, "Engine", Recorded)
    out = tmp_path / "out"
    rc = poff.main(["--width", "32", "--height", "32", "--frames",
                    str(frames), "--out-dir", str(out), "--device", "cpu",
                    flag])
    assert rc == 0
    want_files = {f"frame_{i:04d}.png" for i in (1, 4, 16, 64)
                  if i <= frames} | {f"frame_{frames:04d}.png"}
    assert set(os.listdir(out)) == want_files
    for name in want_files:
        img = read_png(str(out / name))
        assert img.shape == (32, 32, 3) and img.std() > 1.0
    eng = made[0]
    stub = _GridStub(eng.initial_blocks.copy())
    args = joff.build_argparser().parse_args([flag])
    for f in range(1, frames + 1):
        joff.scripted_edits(stub, f, args)
    assert np.array_equal(eng.host_world.blocks, stub.world.blocks)
    assert not np.array_equal(eng.initial_blocks, stub.world.blocks)


def test_interactive_main_on_cpu(tmp_path, capsys):
    """`main --device cpu`: the scripted flythrough for 3 frames at 32×32,
    every 10th frame streamed as PNG, the summary row printed, the world
    autosaved."""
    rc = papp.main(["--width", "32", "--height", "32", "--frames", "3",
                    "--device", "cpu", "--worlds-dir", str(tmp_path / "w"),
                    "--out-dir", str(tmp_path / "live")])
    assert rc == 0
    assert os.listdir(tmp_path / "live") == ["live_00000.png"]
    assert read_png(str(tmp_path / "live" / "live_00000.png")).shape == \
        (32, 32, 3)
    assert "[interactive] flythrough | WholeFrame" in capsys.readouterr().out
    assert WorldStore(str(tmp_path / "w")).list_worlds() == ["default"]
