"""Skeleton: joint hierarchy, bind pose, global matrices (port of
rtvb_tpu/models/skeleton.py).

The hierarchy walk is a host-side topological order baked at load time.
The per-frame pose math runs on the host in numpy (only the composed
joint matrices reach the device); the same functions take torch tensors
and then run in torch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

MAX_JOINTS = 128


def _is_np(a) -> bool:
    return isinstance(a, np.ndarray)


def quat_to_mat3(q):
    """(..., 4) xyzw quaternion → (..., 3, 3) rotation matrix (numpy
    arrays or torch tensors)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]
    m = np.stack(rows, axis=-1) if _is_np(q) else torch.stack(rows, dim=-1)
    return m.reshape(tuple(q.shape[:-1]) + (3, 3))


def trs_to_mat4(t, r, s):
    """translation (..., 3), rotation quat (..., 4), scale (..., 3) →
    (..., 4, 4)."""
    rot = quat_to_mat3(r) * s[..., None, :]
    lead = tuple(t.shape[:-1])
    if _is_np(t):
        top = np.concatenate([rot, t[..., :, None]], axis=-1)
        bottom = np.broadcast_to(np.asarray([0.0, 0.0, 0.0, 1.0], top.dtype),
                                 lead + (1, 4))
        return np.concatenate([top, bottom], axis=-2)
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(lead + (1, 4))
    return torch.cat([top, bottom], dim=-2)


@dataclass
class Skeleton:
    """Static skeleton description (host); a per-frame pose is arrays."""
    names: list
    parents: np.ndarray          # (J,) int, -1 = root
    bind_t: np.ndarray           # (J, 3)
    bind_r: np.ndarray           # (J, 4) xyzw
    bind_s: np.ndarray           # (J, 3)
    inverse_bind: np.ndarray     # (J, 4, 4)
    order: np.ndarray = field(init=False)   # topological order

    def __post_init__(self):
        j = len(self.parents)
        assert j <= MAX_JOINTS
        order = []
        remaining = set(range(j))
        placed = set()
        while remaining:
            for i in sorted(remaining):
                if self.parents[i] < 0 or self.parents[i] in placed:
                    order.append(i)
                    placed.add(i)
                    remaining.discard(i)
                    break
            else:
                raise ValueError("cyclic skeleton")
        self.order = np.array(order, np.int32)

    @property
    def n_joints(self) -> int:
        return len(self.parents)

    def global_matrices(self, local_t, local_r, local_s):
        """Hierarchical local → global compose.  Inputs (J, 3/4/3) numpy or
        torch; returns (J, 4, 4) of the same kind."""
        locals_m = trs_to_mat4(local_t, local_r, local_s)
        mats = [None] * self.n_joints
        for i in self.order:
            i = int(i)
            p = int(self.parents[i])
            mats[i] = locals_m[i] if p < 0 else mats[p] @ locals_m[i]
        return np.stack(mats) if _is_np(locals_m) else torch.stack(mats)

    def skinning_matrices(self, local_t, local_r, local_s, model=None):
        """Global ∘ inverse bind per joint, optionally under `model`."""
        g = self.global_matrices(local_t, local_r, local_s)
        inv = self.inverse_bind if _is_np(g) else torch.as_tensor(
            self.inverse_bind, device=g.device)
        skin = g @ inv
        if model is not None:
            skin = model[None] @ skin
        return skin

    def bind_pose(self, device="cpu"):
        return tuple(torch.as_tensor(a, device=device)
                     for a in (self.bind_t, self.bind_r, self.bind_s))

    def bind_pose_np(self):
        return self.bind_t, self.bind_r, self.bind_s
