"""One cell of the benchmark on the port: set-up, the settle phase, the
measured window, and the frames after it.

A frame, as `InteractiveApp.run` makes it: the character steps (a walking
cell), the camera moves, every click due by now is made (pick, then place
or delete), then `Engine.render_realtime_device(dt)` (a graph replay on
the card) and a synchronize of its output.  No frame is kept in flight.
Clicks come on a wall-clock schedule that does not wait for frames.

The settle phase, between set-up and the window, renders at the
window's first pose for a cell's `settle_s` seconds (`cells/<cell>.json`)
with no clicks and no character steps, so that the replays' slow stretch
at a process's start passes before the window opens.  Its frames are not
the window's and it is not counted in setup_s.

Every input the engine is given (poses, dt, clicks, character steps) is
logged by frame, so that the output check can give the reference the
same inputs.  Host spans are kept by name (`Session.spans`); in the
traced run each span is also a profiler range `bench.<name>`.
"""
from __future__ import annotations

import contextlib
import time

from . import traffic as traffic_mod
from .devtrace import SPAN_PREFIX as SPAN_RANGE


def settings_of(settings_cls, cfg: dict, window=None):
    """The engine's settings for a configuration file: the shipped
    defaults, the file's groups, the output window."""
    w, h = window or cfg["window"]
    groups = {k: dict(v) for k, v in cfg.get("settings", {}).items()}
    groups.setdefault("rendering", {}).update(render_width=int(w),
                                              render_height=int(h))
    return settings_cls().replace(**groups)


class Session:
    """The port's Engine under one cell's traffic.

    device: "cuda" on the card; the tests drive it on "cpu" at a small
    `window`.  clock: the host clock (a fake one in tests)."""

    def __init__(self, cfg: dict, traffic_spec: dict, seed: int,
                 device="cuda", window=None, clock=time.perf_counter):
        self.cfg = cfg
        self.traffic = traffic_mod.Traffic(traffic_spec, seed)
        self.device = device
        self.window_size = window
        self.clock = clock
        self.eng = None
        self.character = None
        self.frames: list = []        # one record per frame rendered
        self.clicks: list = []        # one record per click made
        self.char_log: list = []      # (dt, move) of every character step
        self.spans: dict = {}         # name → [seconds, ...] (window)
        self.counters: dict = {}
        self.window = None            # (start, end) on the host clock
        self.intervals: list = []     # frame intervals in the window, s
        self.untraced: list = []      # those the profiler took no part in
        self.n_clicks_due = 0         # clicks made so far
        self.click_k0 = 0             # the first click of this window
        self.placed = None            # where the last place put its block
        self.last_sync = None
        self.dt = 1.0 / 60.0
        self.t0 = None                # the window's start (host clock)
        self.profiling = False
        self.phase = "setup"

    # -- set-up ----------------------------------------------------------

    def sync(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the window (kept by name, outside the traced
        slice), and in the traced slice a profiler range."""
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function(SPAN_RANGE + name)
            rf.__enter__()
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            if self.profiling:
                rf.__exit__(None, None, None)
            # the profiled slice's frames are not the window's spans: the
            # tracer's own cost lands on the host there
            if self.phase == "window" and not self.profiling:
                self.spans.setdefault(name, []).append(dt)

    def build(self):
        """The engine and its character, the camera at the traffic's base
        pose: set-up is the same work whatever the seed."""
        from rtvb_tpu_torch.core.config import Settings
        from rtvb_tpu_torch.core.scene import SceneConfig
        from rtvb_tpu_torch.render.renderer import Engine
        settings = settings_of(Settings, self.cfg, self.window_size)
        self.eng = Engine(settings=settings,
                          scene=SceneConfig(**self.cfg.get("scene", {})),
                          device=self.device)
        tr = self.traffic
        if tr.character is not None:
            from rtvb_tpu_torch.models.character import Character
            ch = Character(cfg_world=self.eng.cfg,
                           move=self.eng.settings.character_movement)
            ch.position = tr.character_start(self.eng.host_world.blocks)
            self.character = ch
            self._char_step(None)                 # settle on the ground
            self.eng.add_entity(ch.entity)
        if tr.camera is not None:
            self.pose = tr.base_pose()
            pos, yaw, pitch = self.pose
            self.eng.set_camera(pos=pos, yaw=yaw, pitch=pitch)

    def start(self):
        """The seed's start, after the warm-up: the character's walk before
        the window (host steps) and the camera's pose at the window's
        start."""
        tr = self.traffic
        if self.character is not None:
            for _ in range(tr.preroll):
                self._char_step(self._next_move())
        if tr.camera is not None:
            self.pose = tr.pose(0.0)
            pos, yaw, pitch = self.pose
            self.eng.set_camera(pos=pos, yaw=yaw, pitch=pitch)

    def settle(self, seconds: float):
        """Frames at the window's first pose for `seconds` of the host
        clock, before the window: no clicks, no character steps."""
        if seconds <= 0:
            return
        self.phase = "settle"
        end = self.clock() + seconds
        while self.clock() < end:
            self.frame(0.0, step=False)
        self.sync()

    pose = None            # the camera pose last given (None: the scene's)

    def _next_move(self):
        # the settling step is not one of the cycle's steps
        return self.traffic.character_move(len(self.char_log) - 1)

    def _char_step(self, move):
        dt = float(self.traffic.character["dt"])
        if move is None:
            self.character.update(self.eng.host_world, dt)
        else:
            self.character.update(self.eng.host_world, dt, move, False,
                                  False, False)
        self.char_log.append((dt, move))

    def warm(self, n_frames: int = 3):
        """Every shape the cell's traffic uses, at the base pose: the first
        frame (eager, then the capture), replays, and for a clicking cell
        a full cycle of its click actions, each followed by a frame."""
        t = None
        for _ in range(n_frames):
            self.frame(t)
        if self.traffic.clicks is not None:
            for _ in self.traffic.clicks["actions"]:
                self._click(self.n_clicks_due, due=None)
                self.n_clicks_due += 1
                self.frame(t)
        self.sync()

    # -- one frame -------------------------------------------------------

    def frame(self, t, process_clicks: bool = False,
              force_clicks: int = 0, eager: bool = False, step: bool = True):
        """One frame of the traffic at `t` seconds into the window (None:
        the base pose, in the warm-up); returns the u8 frame (on the
        engine's device).  process_clicks: make every click due by now
        first; force_clicks: make that many of the next clicks first, due
        or not; eager: the frame op by op (`Engine._eager_frame`, what the
        graph captured) in place of the replay; step: the character's step
        (none in the settle phase)."""
        eng, tr = self.eng, self.traffic
        rec = dict(n=len(self.frames), clicks=[],
                   char_steps=len(self.char_log), phase=self.phase)
        if self.character is not None and step:
            with self.span("character"):
                self._char_step(self._next_move())
        rec["char_upto"] = len(self.char_log)
        rec["hist"] = self.pose       # the pose the history camera takes
        rec["pose"] = None
        if tr.camera is not None:
            with self.span("camera"):
                rec["pose"] = tr.base_pose() if t is None else tr.pose(t)
                pos, yaw, pitch = rec["pose"]
                eng.set_camera(pos=pos, yaw=yaw, pitch=pitch)
        self.pose = rec["pose"]
        if process_clicks:
            while self.clock() >= self.due(self.n_clicks_due):
                k = self.n_clicks_due
                self.n_clicks_due += 1
                rec["clicks"].append(self._click(k, due=self.due(k)))
        for _ in range(force_clicks):
            k = self.n_clicks_due
            self.n_clicks_due += 1
            rec["clicks"].append(self._click(k, due=None))
        rec["dt"] = self.dt
        with self.span("enqueue"):
            out = (eng._eager_frame(self.dt) if eager
                   else eng.render_realtime_device(self.dt))
        with self.span("sync"):
            self.sync()
        now = self.clock()
        rec["ok"] = (tuple(out.shape) == (eng.out_height, eng.out_width, 3)
                     and str(out.dtype) == "torch.uint8")
        rec["done"] = now
        for c in rec["clicks"]:
            c["seen"] = now
        if self.last_sync is not None:
            self.dt = min(max(now - self.last_sync, 1e-3), 0.1)
        self.last_sync = now
        self.frames.append(rec)
        return out

    def due(self, k: int) -> float:
        """When click k is due on the host clock: the traffic's schedule
        from the window's start, counted from the window's first click."""
        return self.t0 + self.traffic.click_due(k - self.click_k0)

    def _click(self, k: int, due) -> dict:
        """Click k: pick, then its action; the span runs from the pick to
        the upload's completion."""
        from rtvb_tpu_torch.assets import blocks as B
        eng, tr = self.eng, self.traffic
        action = tr.click_action(k)
        rec = dict(k=k, due=due, action=action, pose=self.pose,
                   ok=False, pick=None, target=None, frame=len(self.frames),
                   profiled=self.profiling)
        with self.span("click"):
            t0 = self.clock()
            try:
                hit, xyz, n = eng.pick_block()
                rec["pick"] = (bool(hit), tuple(int(v) for v in xyz),
                               tuple(float(v) for v in n))
                if action == "place" and hit:
                    target = tuple(int(xyz[i] + n[i]) for i in range(3))
                    eng.set_block(*target, int(getattr(B, tr.clicks["block"])))
                    self.placed = target
                    rec["target"], rec["ok"] = target, True
                elif action == "delete_placed" and hit and \
                        self.placed is not None:
                    eng.delete_block(*self.placed)
                    rec["target"], rec["ok"] = self.placed, True
                    self.placed = None
                self.sync()
            except Exception as exc:           # a click that raises fails
                rec["error"] = repr(exc)
            rec["call_s"] = self.clock() - t0
        if rec["ok"]:
            rec["rebuild_ms"] = float(eng.last_edit.get("host_ms", 0.0))
        self.clicks.append(rec)
        return rec

    # -- the window ------------------------------------------------------

    def run_window(self, seconds: float, profile_slice=None):
        """Frames for `seconds` of the host clock.  The window closes at
        the synchronize of the first frame that ends past its length.
        profile_slice: (start_s, stop) into the window, where stop(frames
        in the slice, seconds) says when the profiled slice ends, and the
        window does not close before it has; the profile is returned."""
        self.phase = "window"
        self.intervals = []
        self.untraced = []
        self.spans = {}
        self.sync()
        self.t0 = self.clock()
        self.last_sync = self.t0
        self.click_k0 = self.n_clicks_due
        n_captures = len(self.eng.graph_log)
        prof = None
        slice_frames = 0
        slice_t0 = None
        while True:
            t = self.clock() - self.t0
            if profile_slice is not None and prof is None and \
                    slice_t0 is None and t >= profile_slice[0]:
                prof = self._start_profile()
            # frames after a profile replay slower (the tracer stays
            # with the process): only those before it are untraced
            untraced = prof is None and slice_t0 is None
            self.frame(t, process_clicks=self.traffic.clicks is not None)
            end = self.clock()
            self.intervals.append(self.frames[-1]["done"] - (
                self.frames[-2]["done"] if len(self.frames) > 1
                and self.frames[-2]["phase"] == "window" else self.t0))
            if untraced:
                self.untraced.append(self.intervals[-1])
            if prof is not None:
                if slice_t0 is None:
                    # the profiler's first frame warms the tracer up; the
                    # slice starts after it
                    self._open_slice()
                    slice_t0 = self.clock()
                else:
                    slice_frames += 1
                    if profile_slice[1](slice_frames, end - slice_t0):
                        self._stop_profile(prof, slice_frames)
                        prof = None
            # a traced window closes once its slice has ended
            if end - self.t0 >= seconds and prof is None:
                break
        self.window = (self.t0, self.frames[-1]["done"])
        self.counters["captures"] = len(self.eng.graph_log) - n_captures
        self.phase = "after"
        # every click due in the window is made and seen, late or not
        tr = self.traffic
        while tr.clicks is not None and \
                self.due(self.n_clicks_due) <= self.window[1]:
            k = self.n_clicks_due
            self.n_clicks_due += 1
            rec = self._click(k, due=self.due(k))
            self.frame(self.clock() - self.t0)
            rec["seen"] = self.frames[-1]["done"]
        return self.profile

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        from torch.profiler import record_function
        self.sync()
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device != "cpu" else []))
        prof.start()
        self.profiling = True
        return prof

    def _open_slice(self):
        from torch.profiler import record_function
        self.sync()
        self._slice_range = record_function(SPAN_RANGE + "slice")
        self._slice_range.__enter__()

    def _stop_profile(self, prof, frames: int):
        self.sync()
        if getattr(self, "_slice_range", None) is not None:
            self._slice_range.__exit__(None, None, None)
            self._slice_range = None
        self.profiling = False
        prof.stop()
        self.profile = (prof, frames)

    profile = None

    # -- what the window did -----------------------------------------------

    def window_frames(self) -> list:
        return [f for f in self.frames if f["phase"] == "window"
                and self.window[0] <= f["done"] <= self.window[1]]

    def window_clicks(self) -> list:
        """Every click due in the window."""
        if self.window is None:
            return []
        return [c for c in self.clicks if c["due"] is not None
                and self.window[0] <= c["due"] <= self.window[1]]


def feedback_state(eng) -> dict:
    """Clones of the engine's feedback states: {name: tensor}."""
    out = {}
    if eng.restir_state is not None:
        out["restir"] = eng.restir_state.data.clone()
    ds = eng.denoiser_state
    for name in type(ds)._fields:
        out["denoise." + name] = getattr(ds, name).clone()
    out["post.exposure"] = eng.post_state.exposure.clone()
    return out


def tables(eng) -> dict:
    """The engine's world and light tables on the host: {name: array}."""
    out = {}
    for group, tup in (("world", eng.world), ("lights", eng.lights)):
        for name in type(tup)._fields:
            out[f"{group}.{name}"] = getattr(tup, name).cpu().numpy()
    return out


def soup_rows(eng) -> dict:
    """The triangle soup as the last frame read it: {name: array}, or {}
    without triangles."""
    buf = eng.entity_buffers()
    if buf is None:
        return {}
    return {name: getattr(buf, name).cpu().numpy()
            for name in type(buf)._fields}

