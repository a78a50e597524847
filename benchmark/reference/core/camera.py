"""Pinhole camera: uv↔world mappings, ray generation, reprojection (port of
rtvb_tpu/core/camera.py).  Camera fields are 0-d float32 tensors on the
engine's device; the Engine's cameras are views of one fixed buffer
(`camera_view`), written in place from a host copy of the leaves
(`camera_leaves`)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import mathutil as m


class Camera(NamedTuple):
    pos_x: torch.Tensor
    pos_y: torch.Tensor
    pos_z: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor
    tan_half_fov_y: torch.Tensor
    aspect: torch.Tensor

    @property
    def pos(self):
        return (self.pos_x, self.pos_y, self.pos_z)

    def basis(self):
        cp, sp = torch.cos(self.pitch), torch.sin(self.pitch)
        cy, sy = torch.cos(self.yaw), torch.sin(self.yaw)
        front = (cp * cy, sp, cp * sy)
        zero = torch.zeros_like(cp)
        right = m.normalize(m.cross(front, (zero, zero + 1.0, zero)))
        up = m.cross(right, front)
        return front, right, up

    def uv_to_dir(self, u, v):
        front, right, up = self.basis()
        tx = self.tan_half_fov_y * self.aspect
        ty = self.tan_half_fov_y
        d = m.add(front, m.add(m.scale(right, (u - 0.5) * 2.0 * tx),
                               m.scale(up, (v - 0.5) * 2.0 * ty)))
        return m.normalize(d)

    def dir_to_uv(self, d):
        front, right, up = self.basis()
        df = m.dot(d, front)
        valid = df > 1e-6
        inv = 1.0 / torch.where(valid, df, 1.0)
        tx = self.tan_half_fov_y * self.aspect
        ty = self.tan_half_fov_y
        u = 0.5 + m.dot(d, right) * inv / (2.0 * tx)
        v = 0.5 + m.dot(d, up) * inv / (2.0 * ty)
        return u, v, valid

    def point_to_uv(self, p):
        return self.dir_to_uv(m.sub(p, self.pos))

    def pixel_cone_spread(self, height: int):
        return 2.0 * self.tan_half_fov_y / float(np.float32(height))


def camera_leaves(pos=(0.0, 0.0, 0.0), yaw=0.0, pitch=0.0,
                  fov_y_degrees=60.0, aspect=16.0 / 9.0) -> np.ndarray:
    """The seven Camera leaves as a (7,) float32 host array, computed in
    numpy float32 exactly like the JAX package's make_camera."""
    f32 = np.float32
    return np.array([f32(pos[0]), f32(pos[1]), f32(pos[2]), f32(yaw),
                     f32(pitch),
                     f32(np.tan(np.deg2rad(fov_y_degrees) * 0.5)),
                     f32(aspect)], np.float32)


def make_camera(pos=(0.0, 0.0, 0.0), yaw=0.0, pitch=0.0,
                fov_y_degrees=60.0, aspect=16.0 / 9.0, device="cpu") -> Camera:
    """Leaves are computed in numpy float32 exactly like the JAX package's
    make_camera, then placed on `device`."""
    vals = camera_leaves(pos, yaw, pitch, fov_y_degrees, aspect)
    return Camera(*(torch.tensor(v, dtype=torch.float32, device=device)
                    for v in vals))


def camera_view(buf: torch.Tensor) -> Camera:
    """A Camera whose leaves are 0-d views of a (7,) float32 buffer: a
    fixed camera that is updated by writing the buffer in place."""
    return Camera(*(buf[i] for i in range(len(Camera._fields))))


def pixel_uv(width: int, height: int, jitter_u=0.5, jitter_v=0.5, y0=0,
             rows: int | None = None, device="cpu"):
    """uv grids for pixels, row 0 = top of image."""
    rows = height if rows is None else rows
    x = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    y = (torch.arange(rows, dtype=torch.float32, device=device)
         + float(y0))[:, None]
    u = (x + jitter_u) / float(width)
    v = 1.0 - (y + jitter_v) / float(height)
    return u.expand(rows, width), v.expand(rows, width)


def camera_rays(cam: Camera, width: int, height: int, jitter_u=0.5,
                jitter_v=0.5, y0=0, rows: int | None = None):
    rows = height if rows is None else rows
    dev = cam.pos_x.device
    u, v = pixel_uv(width, height, jitter_u, jitter_v, y0, rows, device=dev)
    d = cam.uv_to_dir(u, v)
    o = tuple(c.expand(rows, width) for c in cam.pos)
    return o, d
