"""The interactive app (port of rtvb_tpu/apps/interactive.py): the
loop a player runs.

Each frame: the frame timer, input, the menu state machine (MainMenu /
NewGame / LoadGame / Gameplay) or the gameplay input (the camera
controllers, the walking character, dig and place through `pick_block`,
`set_block` and `delete_block`), the dev panel's live settings edits, the
frame on the card (`Engine.render_realtime_device`, a replay of the
captured frame), dynamic resolution over the rungs from completed-frame
times, the UI overlay (`Engine.set_ui_overlay`), a save on F5 and on quit.

There is no window: a `Presenter` takes each finished frame (a u8 tensor
on the engine's device) — `PngPresenter` streams PNGs, `NullPresenter`
drops them.  Input comes from an input source, a callable frame → InputState
(scripted, or `StdinInputSource` reading key commands from a stream).
The engine runs on "cuda" unless the app is given device="cpu".
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from ..core.config import Settings
from ..core.controllers import InputHandler, InputState, CameraPose
from ..core.scene import SceneConfig
from ..models.character import Character
from ..render.renderer import Engine
from ..utils import image
from ..utils.perf import FrameTimer, PerformanceTracker
from ..world.persistence import WorldStore

# ---------------------------------------------------------------------------
# UI state machine
# ---------------------------------------------------------------------------

MAIN_MENU, NEW_GAME, LOAD_GAME, GAMEPLAY = range(4)
STATE_NAMES = {MAIN_MENU: "MainMenu", NEW_GAME: "NewGame",
               LOAD_GAME: "LoadGame", GAMEPLAY: "Gameplay"}


class GameUI:
    """Headless UI state machine: menu → world select / create → gameplay.

    Navigation: a cursor over the current state's item list, driven by
    InputState menu_up / menu_down / menu_select / menu_back, so every
    transition of the programmatic `menu_action` is reachable from the
    keyboard."""

    def __init__(self, store: WorldStore):
        self.state = MAIN_MENU
        self.store = store
        self.selected_world: str | None = None
        self.cursor = 0
        self.quit_requested = False

    # ---- keyboard navigation -------------------------------------------

    def menu_items(self) -> list[tuple[str, str, str | None]]:
        """(label, action, world) rows for the current state's screen."""
        if self.state == MAIN_MENU:
            items = []
            if self.store.last_world():
                items.append(("CONTINUE", "continue", None))
            items += [("NEW GAME", "new", None), ("LOAD GAME", "load", None),
                      ("QUIT", "quit", None)]
            return items
        if self.state == NEW_GAME:
            return [("CREATE", "select", None), ("BACK", "back", None)]
        if self.state == LOAD_GAME:
            worlds = self.store.list_worlds()
            return [(w.upper(), "select", w) for w in worlds] + \
                [("BACK", "back", None)]
        return []

    def navigate(self, delta: int) -> None:
        n = len(self.menu_items())
        if n:
            self.cursor = (self.cursor + delta) % n

    def activate(self):
        """Trigger the item under the cursor (Enter).  Returns the new
        state; sets quit_requested for the QUIT item."""
        items = self.menu_items()
        if not items:
            return self.state
        label, action, world = items[min(self.cursor, len(items) - 1)]
        if action == "quit":
            self.quit_requested = True
            return self.state
        if self.state == NEW_GAME and action == "select":
            world = world or "default"
        prev = self.state
        out = self.menu_action(action, world)
        if out != prev:
            self.cursor = 0
        return out

    def back(self):
        """Escape: back out of submenus, or open the menu from gameplay."""
        prev = self.state
        out = self.menu_action("back" if self.state in (NEW_GAME, LOAD_GAME)
                               else "menu")
        if out != prev:
            self.cursor = 0
        return out

    def menu_action(self, action: str, world_name: str | None = None):
        if self.state == MAIN_MENU:
            if action == "new":
                self.state = NEW_GAME
            elif action == "load":
                self.state = LOAD_GAME
            elif action == "continue" and self.store.last_world():
                self.selected_world = self.store.last_world()
                self.state = GAMEPLAY
        elif self.state in (NEW_GAME, LOAD_GAME):
            if action == "select":
                self.selected_world = world_name
                self.state = GAMEPLAY
            elif action == "back":
                self.state = MAIN_MENU
        elif self.state == GAMEPLAY and action == "menu":
            self.state = MAIN_MENU
        return self.state


# ---------------------------------------------------------------------------
# Presenters
# ---------------------------------------------------------------------------

class Presenter:
    """Frames arrive as u8 RGB tensors on the engine's device: the loop
    never copies pixels to the host; a presenter copies them only where it
    consumes them."""

    def present(self, frame, index: int):
        raise NotImplementedError

    def close(self):
        pass


class NullPresenter(Presenter):
    def present(self, frame, index):
        pass


class PngPresenter(Presenter):
    def __init__(self, out_dir: str, every: int = 1):
        self.out_dir = out_dir
        self.every = every
        os.makedirs(out_dir, exist_ok=True)

    def present(self, frame, index):
        if index % self.every == 0:
            image.write_png(os.path.join(self.out_dir, f"live_{index:05d}.png"),
                            frame)


# ---------------------------------------------------------------------------
# Dev overlay text (live stats)
# ---------------------------------------------------------------------------

def dev_overlay_text(engine: Engine, timer: FrameTimer, cam_pose: CameraPose,
                     render_w: int) -> str:
    """The stats line block the loop prints every 30 frames.  The light
    count and the exception list come from the engine's host copies (the
    device tables are not read back)."""
    exc_key = engine._host_tables()["exc_key"]
    lines = [
        f"FPS {timer.fps:6.1f} | frame {engine.frame_index} | "
        f"render {engine.width}x{engine.height} "
        f"-> {engine.out_width}x{engine.out_height} "
        f"(scale {engine.render_scale:.2f})",
        f"cam ({cam_pose.pos[0]:.2f}, {cam_pose.pos[1]:.2f}, {cam_pose.pos[2]:.2f}) "
        f"yaw {cam_pose.yaw:.2f} pitch {cam_pose.pitch:.2f}",
        f"lights {int(engine._host_lights()['count'])} | exceptions "
        f"{int((np.asarray(exc_key) < (1 << 30)).sum())}",
    ]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Input sources
# ---------------------------------------------------------------------------

class StdinInputSource:
    """Line-oriented keyboard input over a stream (stdin by default; the
    headless stand-in for key callbacks).  Non-blocking: reads whatever
    lines arrived since the last frame.  Commands (one or more per line):

      w/s/a/d  move    q/e   descend/ascend     j/l  yaw    i/k  pitch
      r        toggle run    space  jump
      x        left click (dig)     b    right click (place)
      1-9      select block id      c    toggle camera mode
      F3       toggle dev panel     F5/F9 save/load world    quit exit
      up/down/enter/esc   menu navigation (GameUI cursor)
      n        dev panel: next field    +/-   adjust selected field
    """

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stdin
        self.run_held = False
        self.selected = 1

    def _pending_lines(self):
        import select
        lines = []
        try:
            while True:
                r, _, _ = select.select([self.stream], [], [], 0.0)
                if not r:
                    break
                line = self.stream.readline()
                if not line:
                    break
                lines.append(line.strip())
        except (OSError, ValueError):
            pass
        return lines

    def __call__(self, frame: int) -> InputState:
        inp = InputState(run=self.run_held, selected_block=self.selected)
        for line in self._pending_lines():
            for tok in line.split():
                if tok == "w":
                    inp.forward += 1.0
                elif tok == "s":
                    inp.forward -= 1.0
                elif tok == "a":
                    inp.strafe -= 1.0
                elif tok == "d":
                    inp.strafe += 1.0
                elif tok == "e":
                    inp.ascend += 1.0
                elif tok == "q":
                    inp.ascend -= 1.0
                elif tok == "j":
                    inp.mouse_dx -= 10.0
                elif tok == "l":
                    inp.mouse_dx += 10.0
                elif tok == "i":
                    inp.mouse_dy -= 10.0
                elif tok == "k":
                    inp.mouse_dy += 10.0
                elif tok == "r":
                    self.run_held = not self.run_held
                    inp.run = self.run_held
                elif tok == "space":
                    inp.jump = True
                elif tok == "x":
                    inp.left_click = True
                elif tok == "b":
                    inp.right_click = True
                elif tok == "c":
                    inp.toggle_camera_mode = True
                elif tok == "F3":
                    inp.toggle_dev_panel = True
                elif tok == "F5":
                    inp.save_world = True
                elif tok == "F9":
                    inp.load_world = True
                elif tok == "quit":
                    inp.quit = True
                elif tok == "up":
                    inp.menu_up = True
                elif tok == "down":
                    inp.menu_down = True
                elif tok == "enter":
                    inp.menu_select = True
                elif tok == "esc":
                    inp.menu_back = True
                elif tok == "n":
                    inp.dev_next_field = True
                elif tok == "+":
                    inp.dev_adjust = 1
                elif tok == "-":
                    inp.dev_adjust = -1
                elif tok.isdigit():
                    self.selected = int(tok)
                    inp.selected_block = self.selected
        return inp


# ---------------------------------------------------------------------------
# Dynamic resolution: a small ladder of fixed render-scale rungs, 1 → 3/4
# → 2/3 → 1/2.  Over the frame budget it steps down, with headroom it steps
# up, with hysteresis so a borderline frame time does not flip it every
# frame.  The caller applies each returned scale with
# `Engine.set_render_scale`; the first frame at a new rung captures a new
# graph.
# ---------------------------------------------------------------------------

class DynamicResolution:
    RUNGS = (1.0, 0.75, 2.0 / 3.0, 0.5)

    def __init__(self, target_fps: float, min_scale: float = 0.5,
                 start_scale: float = 1.0, hysteresis: int = 8):
        self.target = target_fps
        self.rungs = [r for r in self.RUNGS if r >= min_scale - 1e-6]
        self.idx = min(range(len(self.rungs)),
                       key=lambda i: abs(self.rungs[i] - start_scale))
        self.hysteresis = hysteresis
        self._streak = 0
        self._ema = None

    @property
    def scale(self) -> float:
        return self.rungs[self.idx]

    def update(self, frame_ms: float) -> float:
        """Feed one frame time; returns the scale to use next frame."""
        self._ema = frame_ms if self._ema is None else \
            0.8 * self._ema + 0.2 * frame_ms
        budget = 1000.0 / self.target
        if self._ema > budget * 1.08:
            self._streak = min(self._streak + 1, self.hysteresis)
        elif self._ema < budget * 0.55:
            self._streak = max(self._streak - 1, -self.hysteresis)
        else:
            self._streak = 0
        if self._streak >= self.hysteresis and self.idx + 1 < len(self.rungs):
            self.idx += 1
            self._streak = 0
            self._ema = None
        elif self._streak <= -self.hysteresis and self.idx > 0:
            self.idx -= 1
            self._streak = 0
            self._ema = None
        return self.rungs[self.idx]


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------

def _frame_done_event(frame):
    """An event recorded on the stream that produced a card frame (None
    for a CPU frame, which is complete on return)."""
    if getattr(frame, "is_cuda", False):
        import torch
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(frame.device))
        return ev
    return None


@dataclass
class InteractiveApp:
    settings: Settings
    scene: SceneConfig
    presenter: Presenter
    store: WorldStore
    max_frames: int | None = None
    # True: jump straight into gameplay (benchmarks, scripted flythroughs).
    # False: boot into MainMenu and let InputState menu events drive the
    # GameUI state machine.
    auto_start: bool = True
    # frames kept in flight: the loop submits frame N+k while frame N
    # renders, waiting only on the OLDEST pending frame's event; the
    # dynamic-resolution controller is fed completed-frame times.  As in
    # the JAX package, perf.timed("pathTracing", ...) already waits for
    # each frame's output, so no frame is still running when the loop
    # waits (kept for parity).
    frames_in_flight: int = 2
    # the engine's device: "cuda" (the card) unless asked for "cpu"
    device: str = "cuda"

    def run(self, input_source=None):
        eng = Engine(settings=self.settings, scene=self.scene,
                     device=self.device)
        self.engine = eng
        # completed-frame ms as fed to the controller, and the scale each
        # frame rendered at (by frame index)
        self.completed_ms: list[float] = []
        self.frame_scales: list[float] = []
        ui = GameUI(self.store)
        if self.auto_start:
            ui.menu_action("new")
            ui.menu_action("select", "default")
        character = Character(cfg_world=eng.cfg,
                              move=self.settings.character_movement)
        character._update_pose()
        eng.add_entity(character.entity)
        handler = InputHandler(self.settings.camera_movement, mode="free")
        pose = CameraPose(np.array(self.scene.camera_pos, np.float32),
                          self.scene.camera_yaw, self.scene.camera_pitch)
        timer = FrameTimer(self.settings.rendering.target_fps)
        perf = PerformanceTracker()
        dynres = DynamicResolution(
            self.settings.rendering.target_fps,
            self.settings.rendering.min_render_scale,
            start_scale=eng.render_scale) \
            if self.settings.rendering.dynamic_resolution else None
        # the UI overlay: menus raster on state change, the dev panel
        # twice a second while toggled; the engine composites the RGBA
        # buffer on the card every frame
        from .. import ui as ui_gfx
        canvas = ui_gfx.OverlayCanvas(eng.out_height, eng.out_width)
        dev_panel = False
        ui_drawn_state = None
        dev_field = 0     # dev-panel selected settings field (reflection idx)
        inflight: list = []       # (frame index, frame, done event) pending
        warm = None               # the light-variant warm-up thread
        last_done = None
        render_ms = 0.0
        frame = 0
        try:
            while self.max_frames is None or frame < self.max_frames:
                dt = timer.tick()
                inp = input_source(frame) if input_source else InputState()
                if inp.quit or ui.quit_requested:
                    break
                in_menu = ui.state != GAMEPLAY
                if in_menu:
                    # menu navigation; movement and edit input never
                    # reach gameplay while a menu is up
                    if inp.menu_up:
                        ui.navigate(-1)
                    if inp.menu_down:
                        ui.navigate(1)
                    if inp.menu_select:
                        ui.activate()
                    if inp.menu_back:
                        ui.back()
                    ui_drawn_state = None if (inp.menu_up or inp.menu_down
                                              or inp.menu_select
                                              or inp.menu_back) \
                        else ui_drawn_state
                    inp = InputState(selected_block=inp.selected_block)
                elif inp.menu_back:
                    ui.back()        # Escape in gameplay opens the main menu
                    ui_drawn_state = None
                if dev_panel and (inp.dev_next_field or inp.dev_adjust):
                    # live settings editing: +/- applies Settings.adjust to
                    # the selected field and the engine takes the new
                    # settings (the next frame captures anew)
                    rows = self.settings.value_list()
                    if inp.dev_next_field:
                        dev_field = (dev_field + 1) % len(rows)
                    if inp.dev_adjust:
                        self.settings = self.settings.adjust(
                            rows[dev_field][0], inp.dev_adjust)
                        eng.apply_settings(self.settings)
                    ui_drawn_state = None
                perf.begin_frame()
                with perf.segment("scenePrep"):
                    pose = handler.update(pose, inp, dt, character)
                    eng.set_camera(pos=tuple(map(float, pose.pos)),
                                   yaw=pose.yaw, pitch=pose.pitch)
                    if handler.mode != "free":
                        # the host grid and its version, never the
                        # device tables
                        character.update(eng.host_world, dt,
                                         (inp.forward, inp.strafe), inp.run,
                                         inp.jump, inp.left_click)
                    if inp.right_click:
                        hit, (x, y, z), n = eng.pick_block()
                        if hit:
                            eng.set_block(int(x + n[0]), int(y + n[1]),
                                          int(z + n[2]), inp.selected_block)
                    if inp.left_click and handler.mode == "free":
                        hit, (x, y, z), _ = eng.pick_block()
                        if hit:
                            eng.delete_block(x, y, z)
                    if inp.save_world:
                        self._save(ui, eng, pose)
                # submit this frame, then wait only on the oldest frame in
                # flight (no host copy of the frame; presenters pull pixels
                # only where they consume them)
                self.frame_scales.append(eng.render_scale)
                out = perf.timed("pathTracing", eng.render_realtime_device, dt)
                inflight.append((frame, out, _frame_done_event(out)))
                while len(inflight) >= max(1, self.frames_in_flight) + 1 \
                        or (self.max_frames is not None
                            and frame == self.max_frames - 1 and inflight):
                    done_idx, done_out, done_ev = inflight.pop(0)
                    if done_ev is not None:
                        done_ev.synchronize()
                    now = time.perf_counter()
                    if last_done is not None:
                        # completed-frame throughput drives dynamic
                        # resolution
                        render_ms = (now - last_done) * 1e3
                        self.completed_ms.append(render_ms)
                        if dynres is not None:
                            eng.set_render_scale(dynres.update(render_ms))
                    last_done = now
                    self.presenter.present(done_out, done_idx)
                perf.end_frame()
                if frame == 0 and (self.max_frames is None
                                   or self.max_frames > 120):
                    # a throwaway lit frame on its own stream, so the first
                    # placed lantern finds the lit kernels loaded (skipped
                    # for short scripted sessions, as in the JAX package)
                    warm = eng.warm_light_variant_async()
                if inp.toggle_dev_panel:
                    dev_panel = not dev_panel
                    ui_drawn_state = None
                state_name = STATE_NAMES[ui.state]
                ui_key = (state_name, dev_panel, ui.cursor, dev_field,
                          frame // 15 if dev_panel else 0)
                if ui_key != ui_drawn_state:
                    if state_name != "Gameplay":
                        ui_gfx.render_menu(canvas, state_name,
                                           self.store.list_worlds(),
                                           selected=ui.cursor,
                                           items=[r[0] for r in ui.menu_items()])
                    elif dev_panel:
                        ui_gfx.render_dev_panel(canvas, self.settings, {
                            "fps": timer.fps, "frame_ms": render_ms,
                            "internal": (eng.width, eng.height),
                            "output": (eng.out_width, eng.out_height),
                            "cam": tuple(map(float, pose.pos)),
                            "yaw": float(pose.yaw), "pitch": float(pose.pitch)},
                            selected=dev_field)
                    else:
                        canvas.clear()
                    eng.set_ui_overlay(canvas.buf)
                    ui_drawn_state = ui_key
                if frame % 30 == 0:
                    print(dev_overlay_text(eng, timer, pose, eng.width))
                frame += 1
            # drain the frames still in flight (the quit path)
            for done_idx, done_out, done_ev in inflight:
                if done_ev is not None:
                    done_ev.synchronize()
                self.presenter.present(done_out, done_idx)
        finally:
            # the warm-up's kernels run on their own stream: wait for them
            # before the app returns, so no kernel outlives the session
            if warm is not None:
                warm.join()
        # autosave on quit
        self._save(ui, eng, pose)
        return perf

    def _save(self, ui: GameUI, eng: Engine, pose: CameraPose) -> None:
        """Save the engine's world under the selected name, from its host
        copies (nothing read back from the card)."""
        self.store.save(ui.selected_world or "default", eng.cfg,
                        eng._host_tables(),
                        camera={"pos": [float(v) for v in pose.pos],
                                "yaw": float(pose.yaw),
                                "pitch": float(pose.pitch)})


def main(argv=None):
    ap = argparse.ArgumentParser("rtvb-interactive")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out-dir", type=str, default=None,
                    help="stream frames as PNGs (default: no display)")
    ap.add_argument("--worlds-dir", type=str, default="data/savedata")
    ap.add_argument("--stdin-input", action="store_true",
                    help="drive the session from stdin key commands "
                         "(see StdinInputSource; default: scripted flythrough)")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=("cuda", "cpu"),
                    help="the engine's device (default: the card)")
    args = ap.parse_args(argv)

    settings = Settings().replace(rendering={
        "render_width": args.width, "render_height": args.height,
        # gameplay feedback: the picked block's edge highlight lives in
        # the interactive config
        "block_highlight": True})
    presenter = PngPresenter(args.out_dir, every=10) if args.out_dir else NullPresenter()

    if args.stdin_input:
        source = StdinInputSource()
    else:
        # scripted flythrough input (deterministic)
        def source(frame):
            return InputState(forward=0.6, mouse_dx=2.0, run=False)

    app = InteractiveApp(settings=settings, scene=SceneConfig(),
                         presenter=presenter, store=WorldStore(args.worlds_dir),
                         max_frames=None if args.stdin_input else args.frames,
                         # keyboard sessions boot into the MainMenu and
                         # navigate with up/down/enter/esc; scripted
                         # flythroughs jump straight to gameplay
                         auto_start=not args.stdin_input,
                         device=args.device)
    perf = app.run(source)
    print("[interactive]", perf.summary_row("flythrough"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
