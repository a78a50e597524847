"""The port's apps and the modules they import, held against the JAX
package on the CPU, exactly: the menu state machine and its keyboard
navigation, the stdin key parser (every token), the camera controllers'
poses, the UI overlay buffers, image_diff, PNG bytes and FNV-1a, the
performance tracker's stats, saved worlds crossing between the packages
byte for byte, and both apps' loops (`InteractiveApp.run`,
`offline.main`) with their module's Engine replaced by one recording stub:
the logs of Engine calls, the overlay buffers, the saved files and the
written PNGs are equal.  No frame is rendered here (test_torch_app_runs.py
renders the port's)."""
import copy
import io
import os
import types

import numpy as np
import pytest

from rtvb_tpu.apps import interactive as japp
from rtvb_tpu.apps import offline as joff
from rtvb_tpu.core import config as jconfig
from rtvb_tpu.core import controllers as jctl
from rtvb_tpu.core.scene import SceneConfig as JScene
from rtvb_tpu import ui as jui
from rtvb_tpu.utils import image as jimage
from rtvb_tpu.utils import image_diff as jdiff
from rtvb_tpu.utils import perf as jperf
from rtvb_tpu.world import persistence as jpers

from rtvb_tpu_torch.apps import interactive as papp
from rtvb_tpu_torch.assets.blocks import LANTERN
from rtvb_tpu_torch.apps import offline as poff
from rtvb_tpu_torch.core import config as pconfig
from rtvb_tpu_torch.core import controllers as pctl
from rtvb_tpu_torch.core.scene import SceneConfig as PScene
from rtvb_tpu_torch import ui as pui
from rtvb_tpu_torch.utils import image as pimage
from rtvb_tpu_torch.utils import image_diff as pdiff
from rtvb_tpu_torch.utils import native as pnative
from rtvb_tpu_torch.utils import perf as pperf
from rtvb_tpu_torch.world import gen as pgen
from rtvb_tpu_torch.world import persistence as ppers
from rtvb_tpu_torch.world import voxel as pvoxel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": types.SimpleNamespace(app=japp, off=joff, config=jconfig,
                                 ctl=jctl, Scene=JScene, ui=jui,
                                 pers=jpers, perf=jperf),
    "port": types.SimpleNamespace(app=papp, off=poff, config=pconfig,
                                  ctl=pctl, Scene=PScene, ui=pui,
                                  pers=ppers, perf=pperf),
}


# ---------------------------------------------------------------------------
# the menu state machine
# ---------------------------------------------------------------------------

UI_SCRIPTS = {
    "new game": [("navigate", 1), ("navigate", -1), ("activate",),
                 ("navigate", 1), ("back",), ("activate",), ("activate",),
                 ("back",), ("navigate", 3), ("activate",)],
    "load game": [("navigate", 1), ("activate",), ("navigate", -1),
                  ("activate",), ("back",), ("menu_action", "continue")],
    "actions": [("menu_action", "new"), ("menu_action", "back"),
                ("menu_action", "new"), ("menu_action", "select", "alpha"),
                ("menu_action", "menu"), ("menu_action", "continue"),
                ("menu_action", "load"), ("menu_action", "select", "beta")],
    "quit": [("navigate", -1), ("activate",)],
}


def _ui_trace(pkg, tmp_path, script, worlds):
    store = pkg.pers.WorldStore(str(tmp_path / "store"))
    meta = {"worlds": {w: {"saved_at": "t"} for w in worlds},
            "last_world": worlds[-1] if worlds else None}
    store._save_meta(meta)
    ui = pkg.app.GameUI(store)
    trace = [(ui.state, ui.cursor, ui.menu_items())]
    for op in script:
        out = getattr(ui, op[0])(*op[1:])
        trace.append((op, out, ui.state, ui.cursor, ui.selected_world,
                      ui.quit_requested, ui.menu_items()))
    return trace


@pytest.mark.parametrize("worlds", [(), ("alpha", "beta")],
                         ids=["no worlds", "two worlds"])
@pytest.mark.parametrize("script", list(UI_SCRIPTS))
def test_game_ui_equal(tmp_path, script, worlds):
    """GameUI transitions and keyboard navigation: every state, cursor,
    selection and item list equal after each step."""
    got = {name: _ui_trace(pkg, tmp_path / name, UI_SCRIPTS[script],
                           list(worlds)) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    assert (papp.STATE_NAMES == japp.STATE_NAMES
            and (papp.MAIN_MENU, papp.NEW_GAME, papp.LOAD_GAME,
                 papp.GAMEPLAY) == (japp.MAIN_MENU, japp.NEW_GAME,
                                    japp.LOAD_GAME, japp.GAMEPLAY))


# ---------------------------------------------------------------------------
# the stdin key parser
# ---------------------------------------------------------------------------

TOKENS = ["w", "s", "a", "d", "e", "q", "j", "l", "i", "k", "r", "space",
          "x", "b", "c", "F3", "F5", "F9", "quit", "up", "down", "enter",
          "esc", "n", "+", "-", "7", "12", "zz"]


def _parse(pkg, lines):
    src = pkg.app.StdinInputSource(stream=io.StringIO(""))
    pending = [list(batch) for batch in lines]
    src._pending_lines = lambda: pending.pop(0) if pending else []
    return [vars(src(f)) for f in range(len(lines) + 1)]


@pytest.mark.parametrize("tok", TOKENS)
def test_stdin_token_parsed_equal(tok):
    """Each token alone, twice, then with others in one line."""
    lines = [[tok], [f"{tok} {tok}"], [f"w {tok} d", "r"]]
    assert _parse(PKGS["port"], lines) == _parse(PKGS["jax"], lines)


def _pipe_frames(pkg, writes):
    """The parser over a real pipe (select on its descriptor): before
    frame f, writes[f] is written → each frame's InputState."""
    r, w = os.pipe()
    with os.fdopen(r, "r") as rf, os.fdopen(w, "w") as wf:
        src = pkg.app.StdinInputSource(stream=rf)
        out = []
        for text in writes:
            wf.write(text)
            wf.flush()
            out.append(vars(src(len(out))))
        return out


def test_stdin_reads_a_pipe_equal():
    """Over a real pipe the parsers agree frame by frame, also where two
    lines arrive together: select sees the descriptor, and a line already
    pulled into the stream's buffer waits for the next write (the JAX
    package's behaviour, kept)."""
    writes = ["", "w d 3\n", "F5\nx\n", "", "b\n", "quit\n"]
    got = _pipe_frames(PKGS["port"], writes)
    assert got == _pipe_frames(PKGS["jax"], writes)
    assert (got[1]["forward"], got[1]["strafe"],
            got[1]["selected_block"]) == (1.0, 1.0, 3)
    assert got[2]["save_world"] and not got[2]["left_click"]


# ---------------------------------------------------------------------------
# camera controllers
# ---------------------------------------------------------------------------

class _EyeStub:
    """A character reduced to its eye position."""

    def __init__(self, eye):
        self._eye = np.asarray(eye, np.float32)

    def eye_position(self):
        return self._eye


INPUTS = [dict(forward=1.0, mouse_dx=10.0), dict(strafe=-1.0, ascend=1.0,
                                                 run=True, mouse_dy=-30.0),
          dict(forward=-0.5, mouse_dy=400.0), dict(toggle_camera_mode=True),
          dict(mouse_dx=-7.0, forward=1.0), dict(toggle_camera_mode=True),
          dict(mouse_dy=-900.0, strafe=1.0), dict(toggle_camera_mode=True),
          dict(forward=1.0)]


def _poses(pkg, mode, character, dt=1.0 / 30.0):
    cfg = pkg.config.CameraMovementSettings()
    handler = pkg.ctl.InputHandler(cfg, mode=mode)
    pose = pkg.ctl.CameraPose(np.array([32.0, 18.0, 8.0], np.float32), 1.1,
                              -0.35)
    out = []
    for kw in INPUTS:
        pose = handler.update(pose, pkg.ctl.InputState(**kw), dt, character)
        out.append((handler.mode, np.asarray(pose.pos).tolist(),
                     float(pose.yaw), float(pose.pitch)))
    return out


@pytest.mark.parametrize("with_character", [False, True])
@pytest.mark.parametrize("mode", ["free", "gameplay", "follow"])
def test_controllers_pose_equal(mode, with_character):
    """Each controller (and the mode cycle) from the same inputs: the same
    poses, exactly."""
    eye = _EyeStub([31.5, 9.7, 30.25]) if with_character else None
    assert _poses(PKGS["port"], mode, eye) == _poses(PKGS["jax"], mode, eye)


def test_controllers_follow_the_ports_character():
    """The character-following modes read the port's
    Character.eye_position(), which equals the JAX character's."""
    from rtvb_tpu.models.character import Character as JChar
    from rtvb_tpu_torch.models.character import Character as PChar
    pos = np.array([31.5, 9.0, 30.25], np.float32)
    chars = {}
    for name, cls in (("jax", JChar), ("port", PChar)):
        cfg = PKGS[name].config.CharacterMovementSettings()
        chars[name] = cls(cfg_world=pvoxel.WorldConfig(), move=cfg,
                          position=pos.copy())
    assert np.array_equal(chars["port"].eye_position(),
                          chars["jax"].eye_position())
    for mode in ("gameplay", "follow"):
        assert _poses(PKGS["port"], mode, chars["port"]) == \
            _poses(PKGS["jax"], mode, chars["jax"])


# ---------------------------------------------------------------------------
# the UI overlay
# ---------------------------------------------------------------------------

STATS = {"fps": 57.25, "frame_ms": 17.4667, "internal": (960, 540),
         "output": (1920, 1080), "cam": (31.5, 12.25, -4.125),
         "yaw": 1.1, "pitch": -0.35}


def _screens(pkg, h, w):
    c = pkg.ui.OverlayCanvas(h, w)
    out = []
    for state, worlds, sel, items in [
            ("MainMenu", [], 0, None), ("MainMenu", ["alpha"], 2, None),
            ("NewGame", ["alpha", "beta"], 1, None),
            ("LoadGame", ["alpha", "beta"], 1, None), ("LoadGame", [], 0, None),
            ("MainMenu", [], 1, ["CONTINUE", "NEW GAME", "LOAD GAME", "QUIT"]),
            ("Gameplay", [], 0, None)]:
        pkg.ui.render_menu(c, state, worlds, selected=sel, items=items)
        out.append(c.buf.copy())
    settings = pkg.config.Settings().adjust("tone_mapping.gain", 1)
    for sel in (None, 0, 38, 84):
        pkg.ui.render_dev_panel(c, settings, STATS, selected=sel)
        out.append(c.buf.copy())
    pkg.ui.render_hud(c, ["lights 3", "Exceptions 14: x=(1, 2)"])
    out.append(c.buf.copy())
    c.clear()
    c.panel(-5, 3, w + 9, 40, title="CLIPPED panel ~`{}")
    c.text(w - 13, h - 4, "EDGE", scale=2)
    c.hbar(2, 2, 50, 4, 1.7, (1, 2, 3, 4), (5, 6, 7, 8))
    out.append(c.buf.copy())
    return out


@pytest.mark.parametrize("size", [(96, 160), (180, 320), (1080, 1920)])
def test_overlay_buffers_equal(size):
    """render_menu, render_dev_panel, render_hud and the raster primitives:
    the RGBA buffers bit for bit."""
    got = _screens(PKGS["port"], *size)
    want = _screens(PKGS["jax"], *size)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.uint8 and np.array_equal(a, b), i
    assert any(a[..., 3].any() for a in got)


# ---------------------------------------------------------------------------
# image_diff, PNG bytes, FNV-1a
# ---------------------------------------------------------------------------

def _pairs():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    noisy = np.clip(a.astype(np.int32) + rng.integers(-2, 3, a.shape), 0,
                    255).astype(np.uint8)
    far = np.clip(a.astype(np.int32) + rng.integers(-40, 41, a.shape), 0,
                  255).astype(np.uint8)
    f = rng.random((48, 64, 3), dtype=np.float32) * 1.2
    one = a.copy()
    one[3, 5, 1] ^= 0x40
    return {"identical": (a, a.copy()), "one pixel": (one, a),
            "noise 2": (noisy, a), "noise 40": (far, a),
            "float vs u8": (f, a), "float vs float": (f, f * 0.98)}


@pytest.mark.parametrize("pair", list(_pairs()))
def test_image_diff_equal(pair):
    """compare (every field, the verdict with the same bars) and
    amplified_diff on the same pairs."""
    a, b = _pairs()[pair]
    got, want = pdiff.compare(a, b), jdiff.compare(a, b)
    assert vars(got) == vars(want) and str(got) == str(want)
    assert np.array_equal(pdiff.amplified_diff(a, b),
                          jdiff.amplified_diff(a, b))
    assert (pdiff.VERY_CLOSE, pdiff.CLOSE, pdiff.PIXEL_DIFF_THRESHOLD) == \
        (jdiff.VERY_CLOSE, jdiff.CLOSE, jdiff.PIXEL_DIFF_THRESHOLD)


def test_image_diff_accepts_tensors():
    import torch
    a, b = _pairs()["noise 2"]
    assert vars(pdiff.compare(torch.from_numpy(a), b)) == \
        vars(jdiff.compare(a, b))


@pytest.mark.parametrize("kind", ["u8", "float", "tensor u8",
                                  "tensor float"])
def test_png_bytes_equal(tmp_path, kind):
    """write_png, write_pngs and to_u8: the same bytes as the JAX
    package's (a tensor is copied to the host where it is written)."""
    import torch
    rng = np.random.default_rng(3)
    img = rng.random((37, 53, 3), dtype=np.float32) * 1.3 - 0.1
    if kind.endswith("u8"):
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    arg = torch.from_numpy(img) if kind.startswith("tensor") else img
    pimage.write_png(str(tmp_path / "p.png"), arg)
    jimage.write_png(str(tmp_path / "j.png"), img)
    assert (tmp_path / "p.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    frames = [img, img[::-1].copy(), np.ascontiguousarray(img[:, ::-1])]
    paths = {n: [str(tmp_path / f"{n}{i}.png") for i in range(3)]
             for n in ("p", "j")}
    pimage.write_pngs(paths["p"], [torch.from_numpy(f) if kind.startswith(
        "tensor") else f for f in frames])
    jimage.write_pngs(paths["j"], frames)
    for p, j in zip(paths["p"], paths["j"]):
        assert open(p, "rb").read() == open(j, "rb").read()
    assert np.array_equal(pimage.to_u8(arg), jimage.to_u8(img))
    assert np.array_equal(pimage.read_png(str(tmp_path / "p.png")),
                          jimage.read_png(str(tmp_path / "j.png")))


def test_png_fallback_writer_decodes_equal(tmp_path):
    """The dependency-free writer (no native library, no PIL) writes a PNG
    that decodes to the same pixels."""
    img = np.random.default_rng(4).integers(0, 256, (9, 14, 3),
                                            dtype=np.uint8)
    pimage._write_png_raw(str(tmp_path / "raw.png"), img)
    assert np.array_equal(pimage.read_png(str(tmp_path / "raw.png")), img)


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 32768])
def test_fnv1a64_equal(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    want = jpers.fnv1a64(data)
    assert ppers.fnv1a64(data) == want
    assert pnative.fnv1a64(data) == want          # the native build
    if n <= 4096:                                 # the Python fallback
        h = 0xCBF29CE484222325
        for b in data:
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        assert h == want


def test_native_builds_under_build_not_native():
    """The port's binding builds native/rtvb_native.c into build/native/;
    the tracked native/ directory is never written."""
    before = {f: os.stat(os.path.join(ROOT, "native", f)).st_mtime_ns
              for f in os.listdir(os.path.join(ROOT, "native"))}
    path = pnative._build()
    assert pnative.available()
    assert os.path.dirname(path) == os.path.realpath(pnative.BUILD_DIR) or \
        os.path.samefile(os.path.dirname(path), pnative.BUILD_DIR)
    assert os.path.samefile(os.path.dirname(pnative.BUILD_DIR),
                            os.path.join(ROOT, "build"))
    after = {f: os.stat(os.path.join(ROOT, "native", f)).st_mtime_ns
             for f in os.listdir(os.path.join(ROOT, "native"))}
    assert after == before


# ---------------------------------------------------------------------------
# the performance tracker
# ---------------------------------------------------------------------------

class FakeClock:
    """A `time` module stand-in for the modules under test: each
    perf_counter call advances by the next step (cycling), sleep advances
    by its argument, strftime is pinned."""

    def __init__(self, steps=(0.020,)):
        self.t = 1000.0
        self.steps = steps
        self.i = 0

    def perf_counter(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t

    def sleep(self, s):
        self.t += s

    @staticmethod
    def strftime(*a):
        return "2026-01-02 03:04:05"

    def install(self, monkeypatch, *modules):
        for mod in modules:
            monkeypatch.setattr(mod, "time", self)


def _tracked(pkg, monkeypatch):
    FakeClock((0.0031, 0.0172, 0.0009, 0.0415, 0.0063)).install(
        monkeypatch, pkg.perf)
    tr = pkg.perf.PerformanceTracker()
    for i in range(6):
        tr.begin_frame()
        with tr.segment("scenePrep"):
            pass
        tr.timed("pathTracing", lambda x: x * 2, np.arange(3))
        if i % 2:
            with tr.segment("denoiser", sync=np.zeros(2)):
                pass
        tr.end_frame()
    timer = pkg.perf.FrameTimer(60.0)
    ticks = [timer.tick() for _ in range(5)] + [timer.fps, timer.dt]
    return tr.stats(), tr.stats(skip_first=0), tr.summary_row("row"), ticks


def test_perf_tracker_equal(monkeypatch, tmp_path):
    """stats, summary_row and the frame timer on fixed timings; STAGES."""
    got = _tracked(PKGS["port"], monkeypatch)
    want = _tracked(PKGS["jax"], monkeypatch)
    assert got == want
    assert pperf.STAGES == jperf.STAGES
    FakeClock().install(monkeypatch, pperf, jperf)
    for name, pkg in PKGS.items():
        tr = pkg.perf.PerformanceTracker()
        tr._frames = [{"a": 1.0, "wholeFrame": 3.0},
                      {"a": 2.0, "wholeFrame": 5.0}]
        tr.save_report(str(tmp_path / name / "r.txt"), "lbl")
    assert (tmp_path / "port" / "r.txt").read_text() == \
        (tmp_path / "jax" / "r.txt").read_text()


def test_perf_waits_only_for_card_tensors():
    """A stage's outputs on the host are never waited on (no CUDA call is
    made for them)."""
    import torch
    devs = pperf._cuda_devices((torch.zeros(2), [np.zeros(1)],
                                {"k": (1, torch.ones(1))}), set())
    assert devs == set()
    pperf.wait_for((torch.zeros(2), np.zeros(3), None))


# ---------------------------------------------------------------------------
# saved worlds
# ---------------------------------------------------------------------------

def _nonsolid_ids():
    """The instanced blocks of the shipped registry (the Engine's)."""
    from rtvb_tpu_torch.assets.blocks import BlockRegistry
    reg = BlockRegistry.from_yaml(os.path.join(ROOT, "data", "assets",
                                               "blocks.yaml"))
    return tuple(b.id for b in reg.blocks if b.instanced)


@pytest.fixture(scope="module")
def port_world():
    cfg = pvoxel.WorldConfig()
    nonsolid = _nonsolid_ids()
    tables = pgen.generate_tables(cfg, seed=124, nonsolid_ids=nonsolid)
    blocks = tables["blocks"].copy()
    blocks[5, 20, 5] = 9
    blocks[40, 3, 60] = 0
    tables = pvoxel.build_tables_np(cfg, blocks, tables["schema"], nonsolid)
    return cfg, tables, nonsolid


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _pin_time(monkeypatch):
    FakeClock().install(monkeypatch, jpers, ppers)


def test_saved_world_files_equal(tmp_path, monkeypatch, port_world):
    """One world saved by each package: every file byte for byte (the
    port saves the engine's host tables; the JAX package its world)."""
    import jax.numpy as jnp
    _pin_time(monkeypatch)
    cfg, tables, _ = port_world
    jworld = types.SimpleNamespace(
        blocks=jnp.asarray(tables["blocks"]),
        schema=jnp.asarray(tables["schema"].reshape(-1, 128)))
    cam = {"pos": [1.5, 2.0, 3.25], "yaw": 1.1, "pitch": -0.35}
    jpers.WorldStore(str(tmp_path / "j")).save("w1", cfg, jworld, camera=cam)
    ppers.WorldStore(str(tmp_path / "p")).save("w1", cfg, tables, camera=cam)
    got, want = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert got == want and len(got) == 2 + 4     # 2 YAMLs, 4 chunk blobs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_world_loads_in_both(tmp_path, writer, port_world):
    """A world saved by either package loads in the other: the loaded
    tables equal the port's build_tables of the saved grid, the camera and
    the metadata come back."""
    import jax.numpy as jnp
    cfg, tables, nonsolid = port_world
    root = str(tmp_path / "store")
    if writer == "jax":
        jworld = types.SimpleNamespace(
            blocks=jnp.asarray(tables["blocks"]),
            schema=jnp.asarray(tables["schema"].reshape(-1, 128)))
        jpers.WorldStore(root).save("w2", cfg, jworld, camera={"yaw": 2.5})
    else:
        ppers.WorldStore(root).save("w2", cfg, tables, camera={"yaw": 2.5})
    want = pvoxel.build_tables(cfg, tables["blocks"], tables["schema"],
                               nonsolid)
    pcfg, pworld, pcam, _ = ppers.WorldStore(root).load("w2", nonsolid,
                                                       device="cpu")
    assert pcfg == cfg and pcam == {"yaw": 2.5}
    for f in pvoxel.VoxelWorld._fields:
        assert np.array_equal(getattr(pworld, f).numpy(),
                              getattr(want, f).numpy()), f
    jcfg, jworld, jcam, _ = jpers.WorldStore(root).load("w2", nonsolid)
    assert jcam == {"yaw": 2.5}
    for f in ("blocks", "colmask", "exc_mask", "exc_key", "exc_id", "schema"):
        assert np.array_equal(np.asarray(getattr(jworld, f)).reshape(-1),
                              getattr(want, f).numpy().reshape(-1)
                              .astype(np.asarray(getattr(jworld, f)).dtype)
                              ), f
    assert ppers.WorldStore(root).list_worlds() == ["w2"]
    assert ppers.WorldStore(root).last_world() == "w2"


def test_saved_world_corruption_detected(tmp_path, port_world):
    cfg, tables, _ = port_world
    store = ppers.WorldStore(str(tmp_path))
    store.save("x", cfg, tables)
    cdir = tmp_path / "x" / "chunks"
    blob = sorted(os.listdir(cdir))[0]
    with open(cdir / blob, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff")
    with pytest.raises(AssertionError, match="corrupt"):
        store.load("x", device="cpu")


def test_save_refuses_card_tensors(tmp_path, port_world):
    """A save reads host copies only: a tensor on the card is refused (a
    CPU tensor is read in place)."""
    import torch
    cfg, tables, _ = port_world
    store = ppers.WorldStore(str(tmp_path))
    store.save("t", cfg, {"blocks": torch.from_numpy(tables["blocks"]),
                          "schema": torch.from_numpy(tables["schema"])})
    fake = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError, match="host"):
        store.save("t", cfg, {"blocks": fake, "schema": tables["schema"]})


# ---------------------------------------------------------------------------
# the loops against the JAX loops, through one recording Engine stub
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    cfg = pvoxel.WorldConfig()
    tables = pgen.generate_tables(cfg, seed=124,
                                  nonsolid_ids=_nonsolid_ids())
    return tables["blocks"], tables["schema"]


class RecordingEngine:
    """An Engine stand-in for both packages' apps: it records every call
    with its arguments, keeps a host block grid that edits change, answers
    picks from the camera (deterministically) and returns frames made from
    the frame index.  It offers both packages' ways of reading the world:
    the JAX package's `world` / `lights` and the port's host copies."""
    log: list = None
    grid = None

    def __init__(self, settings=None, scene=None, width=None, height=None,
                 **kw):
        rs = settings.rendering
        self.settings = settings
        self.out_width = width or rs.render_width
        self.out_height = height or rs.render_height
        self.cfg = pvoxel.WorldConfig()
        self.blocks = self.grid[0].copy()
        self.schema = self.grid[1]
        self.version = 0
        self.n_lights = 0
        self.frame_index = 0
        self.pose = (tuple(map(float, scene.camera_pos)),
                     float(scene.camera_yaw), float(scene.camera_pitch))
        self.set_render_scale(float(rs.render_scale), record=False)
        self.log.append(("Engine", self.out_width, self.out_height,
                         settings.to_dict()))

    # the JAX package's reads
    @property
    def world(self):
        return types.SimpleNamespace(blocks=self.blocks,
                                     schema=self.schema.reshape(-1, 128),
                                     exc_key=self._exc_key())

    @property
    def lights(self):
        return types.SimpleNamespace(count=np.int32(self.n_lights))

    # the port's host copies
    def _host_tables(self):
        return {"blocks": self.blocks, "schema": self.schema,
                "exc_key": self._exc_key()}

    def _host_lights(self):
        return {"count": np.int32(self.n_lights)}

    @property
    def host_world(self):
        return pvoxel.HostWorld(self.blocks, self.version)

    def _exc_key(self):
        k = np.full(128, 1 << 30, np.int32)
        k[:self.version % 5] = np.arange(self.version % 5)
        return k

    def add_entity(self, entity):
        self.log.append(("add_entity", type(entity).__name__))

    def set_camera(self, pos=None, yaw=None, pitch=None, keep_history=False):
        self.log.append(("set_camera", pos, yaw, pitch, keep_history))
        p, y, pt = self.pose
        self.pose = (tuple(map(float, pos)) if pos is not None else p,
                     float(yaw) if yaw is not None else y,
                     float(pitch) if pitch is not None else pt)

    def pick_block(self, max_dist: float = 8.0):
        (x, y, z), yaw, pitch = self.pose
        ix = int(np.clip(x + 4 * np.cos(yaw), 0, 63))
        iz = int(np.clip(z + 4 * np.sin(yaw), 0, 63))
        col = np.nonzero(self.blocks[ix, :, iz])[0]
        hit = bool(col.size) and pitch < -0.1 and max_dist >= 8.0
        iy = int(col.max()) if col.size else 0
        out = (hit, (ix, iy, iz), (0.0, 1.0, 0.0))
        self.log.append(("pick_block", max_dist, out))
        return out

    def set_block(self, x, y, z, block_id):
        self.log.append(("set_block", x, y, z, block_id))
        self.blocks[x, y, z] = block_id
        self.version += 1
        self.n_lights += int(block_id == LANTERN)

    def delete_block(self, x, y, z):
        self.log.append(("delete_block", x, y, z))
        self.blocks[x, y, z] = 0
        self.version += 1

    def apply_settings(self, settings):
        self.log.append(("apply_settings", settings.to_dict()))
        self.settings = settings

    def set_render_scale(self, scale, record=True):
        if record:
            self.log.append(("set_render_scale", scale))
        self.render_scale = scale
        self.width = max(8, int(round(self.out_width * scale / 2.0)) * 2)
        self.height = max(8, int(round(self.out_height * scale / 2.0)) * 2)

    def set_ui_overlay(self, rgba):
        self.log.append(("set_ui_overlay", np.array(rgba)))

    def warm_light_variant_async(self):
        self.log.append(("warm_light_variant_async",))

    def _frame(self):
        self.frame_index += 1
        f = np.zeros((self.out_height, self.out_width, 3), np.uint8)
        f[..., 0] = self.frame_index
        f[::2, :, 1] = self.version
        return f

    def render_realtime_device(self, dt=1.0 / 60.0):
        self.log.append(("render", round(float(dt), 9)))
        return self._frame()

    render_realtime = render_realtime_device

    def render_accumulated(self, dt=1.0 / 60.0):
        self.log.append(("render_accumulated", round(float(dt), 9)))
        return self._frame().astype(np.float32) / 200.0

    def reset_accumulation(self):
        self.log.append(("reset_accumulation",))


def _entries_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(map(_entries_equal, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_entries_equal(a[k], b[k])
                                            for k in a)
    return a == b


def _assert_logs_equal(got, want):
    assert len(got) == len(want), ([g[0] for g in got], [w[0] for w in want])
    for i, (g, w) in enumerate(zip(got, want)):
        assert _entries_equal(g, w), (i, g[0], w[0])


def _stub(monkeypatch, pkg, module, grid):
    log = []
    eng_cls = type("RecordingEngine", (RecordingEngine,),
                   {"log": log, "grid": grid})
    monkeypatch.setattr(module, "Engine", eng_cls)
    return log


class _Presenter:
    def __init__(self, base):
        self.frames = []

    def present(self, frame, index):
        self.frames.append((index, np.asarray(frame).copy()))


def _scripted_lines(lines):
    def make(pkg):
        src = pkg.app.StdinInputSource(stream=io.StringIO(""))
        pending = list(lines)
        src._pending_lines = lambda: [pending.pop(0)] if pending else []
        return src
    return make


def _menu_edit_source(gi):
    """The menu navigation and live edit session's inputs."""
    def make(pkg):
        def src(frame):
            S = pkg.ctl.InputState
            if frame in (0, 1):
                return S(menu_select=True)       # NEW GAME, then CREATE
            if frame == 2:
                return S(toggle_dev_panel=True)
            if 4 <= frame < 4 + gi:
                return S(dev_next_field=True)
            if frame == 4 + gi:
                return S(dev_adjust=1)
            return S()
        return src
    return make


GAIN = [n for n, _ in pconfig.Settings().value_list()].index(
    "tone_mapping.gain")
SESSION_KEYS = (["", "enter", "down", "up", "enter", "F3"] + ["n"] * 3
                + ["+", "k k k k k k k k k k k k", "x", "", "12 b", "c",
                   "w", "w r", "space w", "c", "j j", "c", "F9", "esc",
                   "down", "enter", "esc", "enter", "enter", "F5", "a",
                   "quit"])
SESSIONS = {
    # tests/test_interactive.py's scripted sessions
    "end to end": dict(source=_scripted_lines(
        ["F3", "w", "x", "F5", "", "", "", "quit"]), max_frames=8,
        auto_start=True, rendering={"render_width": 96,
                                    "render_height": 96,
                                    "dynamic_resolution": False}),
    "menu and live edit": dict(source=_menu_edit_source(GAIN),
                               max_frames=GAIN + 8, auto_start=False,
                               rendering={"render_width": 64,
                                          "render_height": 64,
                                          "dynamic_resolution": False}),
    # the keys chip_smoke's interactive phase sends, with the shipped
    # dynamic resolution walking the rungs (the fake clock is over budget)
    "keyboard session": dict(source=_scripted_lines(SESSION_KEYS),
                             max_frames=None, auto_start=False,
                             rendering={"render_width": 160,
                                        "render_height": 90,
                                        "block_highlight": True}),
    "scripted flythrough": dict(source=lambda pkg: (
        lambda f: pkg.ctl.InputState(forward=0.6, mouse_dx=2.0)),
        max_frames=130, auto_start=True,
        rendering={"render_width": 48, "render_height": 32}),
}


def _run_session(pkg, module, monkeypatch, tmp_path, grid, case):
    spec = SESSIONS[case]
    FakeClock((0.0125, 0.021, 0.0045)).install(monkeypatch, module,
                                               pkg.perf, pkg.pers)
    log = _stub(monkeypatch, pkg, module, grid)
    store = pkg.pers.WorldStore(str(tmp_path / "worlds"))
    pres = _Presenter(None)
    settings = pkg.config.Settings().replace(rendering=spec["rendering"])
    app = module.InteractiveApp(
        settings=settings, scene=pkg.Scene(), presenter=pres, store=store,
        max_frames=spec["max_frames"], auto_start=spec["auto_start"])
    perf = app.run(input_source=spec["source"](pkg))
    return log, pres.frames, _tree(tmp_path / "worlds"), perf, app


@pytest.mark.parametrize("case", list(SESSIONS))
def test_interactive_loop_engine_calls_equal(monkeypatch, tmp_path, grid,
                                             capsys, case):
    """Both InteractiveApp.run loops against the same recording Engine and
    the same clock: the Engine calls (set_camera arguments, picks, edits,
    set_render_scale, apply_settings, set_ui_overlay buffers) equal in
    order, the same frames presented, the saved files byte for byte, the
    printed stats lines and the tracker's summary equal."""
    got = _run_session(PKGS["port"], papp, monkeypatch, tmp_path / "p",
                       grid, case)
    out_p = capsys.readouterr().out
    want = _run_session(PKGS["jax"], japp, monkeypatch, tmp_path / "j",
                        grid, case)
    out_j = capsys.readouterr().out
    _assert_logs_equal(got[0], want[0])
    assert [i for i, _ in got[1]] == [i for i, _ in want[1]]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got[1],
                                                               want[1]))
    assert got[2] == want[2] and any(k.endswith("scene.yaml")
                                     for k in got[2])
    assert out_p == out_j
    assert got[3].summary_row("s") == want[3].summary_row("s")
    kinds = {e[0] for e in got[0]}
    assert {"set_camera", "render", "set_ui_overlay"} <= kinds
    if case == "keyboard session":
        # every kind of call the loop makes was made
        assert {"pick_block", "set_block", "delete_block", "apply_settings",
                "set_render_scale"} <= kinds
        assert got[4].completed_ms and got[4].frame_scales[-1] < 1.0
    if case == "menu and live edit":
        assert abs(got[4].settings.tone_mapping.gain - 1.25) < 1e-9
        assert got[4].settings.to_dict() == want[4].settings.to_dict()
    if case == "scripted flythrough":
        # past 120 frames the loop warms the lit variant at frame 0
        assert ("warm_light_variant_async",) in got[0]


OFFLINE_RUNS = {
    "sequence": ["--frames", "12", "--test-sequence"],
    "remove20": ["--frames", "44", "--test-remove20"],
    "remove circle": ["--frames", "44", "--test-remove-circle"],
    "realtime, every frame, report": ["--frames", "5", "--realtime",
                                      "--save-all", "--test-sequence",
                                      "--perf-report", "{tmp}/perf/r.txt",
                                      "--label", "lbl"],
    "procedural, update then test": ["--frames", "3", "--procedural",
                                     "--update-canonical", "--test-canonical",
                                     "--canonical", "{tmp}/c/canon.png"],
    "authored, no canonical (2)": ["--frames", "2", "--authored",
                                   "--test-canonical", "--canonical",
                                   "{tmp}/none.png"],
    "test against another (1)": ["--frames", "4", "--test-canonical",
                                 "--canonical", "{golden}"],
}


def _run_offline(pkg, module, monkeypatch, tmp_path, grid, case):
    FakeClock((0.0031, 0.011)).install(monkeypatch, pkg.perf)
    log = _stub(monkeypatch, pkg, module, grid)
    golden = tmp_path.parent / "golden.png"
    if not golden.exists():
        jimage.write_png(str(golden), np.full((20, 24, 3), 90, np.uint8))
    args = [a.format(tmp=str(tmp_path), golden=str(golden))
            for a in OFFLINE_RUNS[case]]
    rc = module.main(["--width", "24", "--height", "20", "--out-dir",
                      str(tmp_path / "out"), *args])
    return rc, log, _tree(tmp_path)


@pytest.mark.parametrize("case", list(OFFLINE_RUNS))
def test_offline_main_engine_calls_equal(monkeypatch, tmp_path, grid, capsys,
                                         case):
    """Both offline.main against the same recording Engine: the exit code,
    every Engine call in order (the scripted edits, the column tops read
    from the host grid, the picks of --test-remove-circle), and every file
    written (the saved frames, the diff image, the report) byte for
    byte; the printed lines equal."""
    got = _run_offline(PKGS["port"], poff, monkeypatch, tmp_path / "p",
                       grid, case)
    out_p = capsys.readouterr().out.replace(str(tmp_path / "p"), "T")
    want = _run_offline(PKGS["jax"], joff, monkeypatch, tmp_path / "j",
                        grid, case)
    out_j = capsys.readouterr().out.replace(str(tmp_path / "j"), "T")
    assert got[0] == want[0]
    _assert_logs_equal(got[1], want[1])
    assert got[2] == want[2]
    assert out_p == out_j
    expect_rc = 2 if "(2)" in case else 1 if "(1)" in case else 0
    assert got[0] == expect_rc
    edits = [e for e in got[1] if e[0] in ("set_block", "delete_block")]
    n_edits = {"sequence": 3, "remove20": 20}.get(case)
    if n_edits is not None:
        assert len(edits) == n_edits


def test_offline_argparser_flags_equal():
    """Every flag of the JAX CLI, with its default, save --platform (the
    port's --device)."""
    def flags(ap):
        return {a.dest: a.default for a in ap._actions if a.dest != "help"}
    got, want = flags(poff.build_argparser()), flags(joff.build_argparser())
    assert got.pop("device") == "cuda" and want.pop("platform") is None
    for k in ("out_dir", "canonical"):
        assert os.path.samefile(os.path.dirname(got.pop(k)),
                                os.path.dirname(want.pop(k)))
    assert got == want
    assert poff.SAVE_FRAMES == joff.SAVE_FRAMES


def test_dev_overlay_text_equal(grid):
    """dev_overlay_text from the engine's host copies equals the JAX
    text read from its device tables."""
    eng_cls = type("E", (RecordingEngine,), {"log": [], "grid": grid})
    eng = eng_cls(settings=pconfig.Settings(), scene=PScene())
    eng.set_block(3, 30, 3, LANTERN)
    eng.set_render_scale(2.0 / 3.0)
    texts = []
    for pkg, mod in ((PKGS["port"], papp), (PKGS["jax"], japp)):
        timer = pkg.perf.FrameTimer(None)
        timer.fps = 47.125
        pose = pkg.ctl.CameraPose(np.array([1.25, 2.5, -3.0], np.float32),
                                  0.3, -0.2)
        texts.append(mod.dev_overlay_text(eng, timer, pose, eng.width))
    assert texts[0] == texts[1] and "lights 1 | exceptions 1" in texts[0]


def test_interactive_app_device_default():
    """The app's engine runs on the card unless given "cpu"."""
    assert papp.InteractiveApp.__dataclass_fields__["device"].default == \
        "cuda"
    assert poff.build_argparser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("cls", ["GameUI", "Presenter", "NullPresenter",
                                 "PngPresenter", "StdinInputSource",
                                 "DynamicResolution", "InteractiveApp"])
def test_interactive_names(cls):
    assert hasattr(papp, cls) and hasattr(japp, cls)


def test_png_presenter_writes_card_frames_on_host(tmp_path):
    import torch
    pres = papp.PngPresenter(str(tmp_path), every=2)
    frame = torch.arange(4 * 6 * 3, dtype=torch.uint8).reshape(4, 6, 3)
    for i in range(3):
        pres.present(frame, i)
    assert sorted(os.listdir(tmp_path)) == ["live_00000.png",
                                            "live_00002.png"]
    assert np.array_equal(pimage.read_png(str(tmp_path / "live_00000.png")),
                          frame.numpy())
