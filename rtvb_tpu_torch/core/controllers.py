"""Camera controllers and input handling (port of
rtvb_tpu/core/controllers.py; host numpy, the same classes and math).

A free fly camera, a first-person camera at the character's eye height
and a spring-damped third-person follow camera, behind an InputHandler
that routes each frame's `InputState` snapshot to the active controller
and cycles the modes.  Input arrives as one `InputState` a frame: the
interactive app fills it from a terminal, tests drive it directly.  The
character-following modes call the port's `Character.eye_position()`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import CameraMovementSettings


@dataclass
class InputState:
    forward: float = 0.0        # -1..1
    strafe: float = 0.0
    ascend: float = 0.0
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    run: bool = False
    jump: bool = False
    left_click: bool = False
    right_click: bool = False
    selected_block: int = 1
    toggle_camera_mode: bool = False
    toggle_dev_panel: bool = False   # dev panel visibility toggle
    save_world: bool = False
    load_world: bool = False
    quit: bool = False
    # menu navigation
    menu_up: bool = False
    menu_down: bool = False
    menu_select: bool = False        # Enter
    menu_back: bool = False          # Escape
    # dev-panel live editing
    dev_next_field: bool = False     # cycle the selected settings field
    dev_adjust: int = 0              # -1 / +1 applied to the selected field


@dataclass
class CameraPose:
    pos: np.ndarray
    yaw: float
    pitch: float


class FreeCameraController:
    """WASD fly camera."""

    def __init__(self, cfg: CameraMovementSettings):
        self.cfg = cfg

    def update(self, pose: CameraPose, inp: InputState, dt: float,
               character=None) -> CameraPose:
        yaw = pose.yaw + inp.mouse_dx * self.cfg.mouse_sensitivity
        pitch = np.clip(pose.pitch - inp.mouse_dy * self.cfg.mouse_sensitivity,
                        -1.5, 1.5)
        c, s = np.cos(yaw), np.sin(yaw)
        cp = np.cos(pitch)
        fwd = np.array([cp * c, np.sin(pitch), cp * s], np.float32)
        right = np.array([-s, 0, c], np.float32)
        vel = (fwd * inp.forward + right * inp.strafe
               + np.array([0, 1, 0], np.float32) * inp.ascend)
        speed = self.cfg.fly_speed * (2.5 if inp.run else 1.0)
        return CameraPose(pose.pos + vel * speed * dt, yaw, pitch)


class GameplayCameraController:
    """First person at the character's eye height."""

    def __init__(self, cfg: CameraMovementSettings):
        self.cfg = cfg

    def update(self, pose: CameraPose, inp: InputState, dt: float,
               character=None) -> CameraPose:
        yaw = pose.yaw + inp.mouse_dx * self.cfg.mouse_sensitivity
        pitch = np.clip(pose.pitch - inp.mouse_dy * self.cfg.mouse_sensitivity,
                        -1.5, 1.5)
        pos = character.eye_position() if character is not None else pose.pos
        return CameraPose(np.asarray(pos, np.float32), yaw, pitch)


class CharacterFollowCameraController:
    """Third-person spring-damped follow."""

    def __init__(self, cfg: CameraMovementSettings):
        self.cfg = cfg
        self._smoothed = None

    def update(self, pose: CameraPose, inp: InputState, dt: float,
               character=None) -> CameraPose:
        yaw = pose.yaw + inp.mouse_dx * self.cfg.mouse_sensitivity
        pitch = np.clip(pose.pitch - inp.mouse_dy * self.cfg.mouse_sensitivity,
                        -1.2, 0.4)
        anchor = (character.eye_position() if character is not None
                  else pose.pos)
        c, s = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        back = -np.array([cp * c, sp, cp * s], np.float32)
        target = np.asarray(anchor, np.float32) + back * self.cfg.follow_distance
        if self._smoothed is None:
            self._smoothed = target
        k = min(1.0, self.cfg.follow_stiffness * dt)
        self._smoothed = self._smoothed + (target - self._smoothed) * k
        return CameraPose(self._smoothed, yaw, pitch)


MODES = ("free", "gameplay", "follow")


class InputHandler:
    """Routes InputState to the active camera controller and cycles the
    modes on a toggle."""

    def __init__(self, cfg: CameraMovementSettings, mode: str = "free"):
        self.cfg = cfg
        self.mode = mode
        self._ctrls = {
            "free": FreeCameraController(cfg),
            "gameplay": GameplayCameraController(cfg),
            "follow": CharacterFollowCameraController(cfg),
        }

    def update(self, pose: CameraPose, inp: InputState, dt: float,
               character=None) -> CameraPose:
        if inp.toggle_camera_mode:
            self.mode = MODES[(MODES.index(self.mode) + 1) % len(MODES)]
        return self._ctrls[self.mode].update(pose, inp, dt, character)
