"""Scripted flythrough camera path (port of rtvb_tpu/utils/flypath.py).

A static camera flatters temporal ReSTIR and the denoiser (perfect
reprojection), so the moving-camera measurements ride this path: a
forward glide, a sideways weave and a yaw pan, which disocclude both
screen edges and reproject with depth parallax."""
from __future__ import annotations

import math


def flythrough_pose(pos0, yaw0: float, i: int, frames: int):
    """Camera pose at step i of a `frames`-step sweep."""
    t = i / max(frames - 1, 1)
    pos = (pos0[0] + 3.0 * t,
           pos0[1],
           pos0[2] + 1.5 * math.sin(2.0 * t))
    return pos, yaw0 + 0.5 * t


def apply_flythrough(eng, i: int, frames: int, pos0=None, yaw0=None):
    """Move `eng`'s camera to step i of the sweep from (pos0, yaw0), by
    default its current pose (read from the engine's host copy); returns
    (pos0, yaw0) for the next step."""
    pos, yaw, _ = eng.camera_pose()
    if pos0 is None:
        pos0 = pos
    if yaw0 is None:
        yaw0 = yaw
    pos, yaw = flythrough_pose(pos0, yaw0, i, frames)
    eng.set_camera(pos=pos, yaw=yaw)
    return pos0, yaw0
