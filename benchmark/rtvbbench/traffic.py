"""The one traffic generator: a traffic file's parameters and a seed →
the inputs a player gives the engine.

A traffic file (`traffic/<name>.json`) has up to three parts:

- `camera`: a start pose (`pos`, `yaw`, `pitch`), the seed's draw around
  it (`jitter_pos` per axis, `jitter_yaw`), a `glide` to and fro along an
  axis (`axis` "view" for the start yaw's horizontal direction or an
  [x, y, z] vector, `range` [lo, hi] in blocks, `speed` in blocks/s), a
  sideways `weave` (`amp` blocks, `period_s`) and a `yaw_sway` (`amp`
  rad, `period_s`).  The pose is a function of the window's time; the
  seed draws each motion's phase.
- `clicks`: one click due every `every_s` seconds of wall-clock time from
  a phase the seed draws, whether or not frames keep up; the clicks take
  `actions` in turn ("place": the block `block` on the picked face,
  "delete_placed": the block the last place put down).
- `character`: the interactive app's character, standing at `start_xz`,
  stepped `dt` seconds a frame: legs of walking forward, and between
  legs `turn_steps` steps of strafing (with the
  character's yaw smoothing, a turn about): `leg_steps` forward, the
  first leg half as long, so that it walks to and fro about its start;
  the seed draws how many steps of the cycle it has walked before the
  window.

Nothing here reads the engine: the same file and seed give the same
inputs.
"""
from __future__ import annotations

import math
import random

import numpy as np


def _tri(u: float) -> float:
    """A triangle wave of period 1 in [0, 1]: 0 at u = 0, 1 at u = 1/2."""
    u = u % 1.0
    return 2.0 * u if u < 0.5 else 2.0 * (1.0 - u)


class Traffic:
    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.seed = int(seed)
        rng = random.Random(self.seed)
        cam = spec.get("camera")
        self.camera = None
        if cam is not None:
            jp = cam.get("jitter_pos", [0.0, 0.0, 0.0])
            pos = [p + rng.uniform(-j, j) for p, j in zip(cam["pos"], jp)]
            yaw = cam["yaw"] + rng.uniform(-1.0, 1.0) * cam.get(
                "jitter_yaw", 0.0)
            glide = cam.get("glide")
            axis = None
            if glide is not None:
                axis = glide.get("axis", "view")
                if axis == "view":
                    axis = [math.cos(yaw), 0.0, math.sin(yaw)]
                n = math.sqrt(sum(a * a for a in axis))
                axis = [a / n for a in axis]
            self.camera = dict(
                pos=pos, yaw=yaw, pitch=cam["pitch"], glide=glide, axis=axis,
                weave=cam.get("weave"), sway=cam.get("yaw_sway"),
                phases=[rng.random() for _ in range(3)])
        self.clicks = spec.get("clicks")
        self.click_phase = (rng.random() * self.clicks["every_s"]
                            if self.clicks else 0.0)
        ch = spec.get("character")
        self.character = ch
        self.preroll = 0
        if ch is not None:
            cycle = 2 * (ch["leg_steps"] + ch["turn_steps"])
            self.preroll = rng.randrange(cycle)

    # -- the camera ------------------------------------------------------

    def base_pose(self):
        """The file's start pose, before the seed's draw: where the set-up
        warms up."""
        c = self.spec["camera"]
        return (tuple(float(v) for v in c["pos"]), float(c["yaw"]),
                float(c["pitch"]))

    def pose(self, t: float):
        """((x, y, z), yaw, pitch) at `t` seconds into the window."""
        c = self.camera
        pos = list(c["pos"])
        yaw = c["yaw"]
        g = c["glide"]
        if g is not None:
            lo, hi = g["range"]
            leg = (hi - lo) / g["speed"]           # seconds one way
            s = lo + (hi - lo) * _tri(t / (2.0 * leg) + c["phases"][0])
            pos = [p + s * a for p, a in zip(pos, c["axis"])]
        w = c["weave"]
        if w is not None:
            ax = c["axis"] or [math.cos(yaw), 0.0, math.sin(yaw)]
            side = [-ax[2], 0.0, ax[0]]
            n = math.hypot(side[0], side[2]) or 1.0
            off = w["amp"] * math.sin(2.0 * math.pi * (
                t / w["period_s"] + c["phases"][1]))
            pos = [p + off * s / n for p, s in zip(pos, side)]
        sw = c["sway"]
        if sw is not None:
            yaw = yaw + sw["amp"] * math.sin(2.0 * math.pi * (
                t / sw["period_s"] + c["phases"][2]))
        return (float(pos[0]), float(pos[1]), float(pos[2])), float(yaw), \
            float(c["pitch"])

    # -- the clicks ------------------------------------------------------

    def click_due(self, k: int) -> float:
        """When click k (0, 1, ...) is due, in seconds into the window."""
        return self.click_phase + k * self.clicks["every_s"]

    def click_action(self, k: int) -> str:
        acts = self.clicks["actions"]
        return acts[k % len(acts)]

    # -- the character ---------------------------------------------------

    def character_move(self, step: int):
        """(forward, strafe) of the character's step `step` (counted
        from the character's first step, the pre-roll included)."""
        ch = self.character
        per = ch["leg_steps"] + ch["turn_steps"]
        u = (step + ch["leg_steps"] // 2) % per
        return (1.0, 0.0) if u < ch["leg_steps"] else (0.0, 1.0)

    def character_start(self, blocks: np.ndarray):
        """(x, y, z) where the character stands at its start: on top of
        the highest solid voxel of the start column of `blocks`."""
        x, z = self.character["start_xz"]
        col = blocks[int(x), :, int(z)]
        return np.array([x, float(col.nonzero()[0].max() + 1), z],
                        np.float32)
