"""Entities: transformable skinned or static triangle meshes in the world
(port of rtvb_tpu/models/entity.py).

An entity's per-frame pose is its composed model ∘ skinning matrices on
the host (`joint_mats`, and the previous frame's `prev_joint_mats` for
motion vectors).  The engine's pack (render/renderer.py) skins the
mesh on the device from these alone; vertices never come back to the
host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .skeleton import Skeleton

ENTITY_ID_BASE = 100000


@dataclass
class MeshData:
    """Static mesh with optional skinning data."""
    positions: np.ndarray          # (N, 3)
    normals: np.ndarray            # (N, 3)
    uvs: np.ndarray                # (N, 2)
    indices: np.ndarray            # (T, 3)
    joints: Optional[np.ndarray] = None    # (N, 4) int
    weights: Optional[np.ndarray] = None   # (N, 4)
    skeleton: Optional[Skeleton] = None
    clips: dict = field(default_factory=dict)  # name -> AnimationClip

    @property
    def n_triangles(self) -> int:
        return len(self.indices)


@dataclass
class Entity:
    mesh: MeshData
    material: str = "default"
    # albedo texture name (data/textures/<image>.png), sampled at entity
    # hits through the engine's image atlas
    image: str | None = None
    position: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0
    scale: float = 1.0
    entity_id: int = ENTITY_ID_BASE

    # current and previous world-space vertices (update_vertices)
    _cur_pos: Optional[torch.Tensor] = None
    _prev_pos: Optional[torch.Tensor] = None
    _cur_norm: Optional[torch.Tensor] = None

    # host-side per-frame pose: composed model ∘ skinning matrices, (J, 4,
    # 4) (or (1, 4, 4), the model transform of an unskinned mesh)
    joint_mats: Optional[np.ndarray] = None
    prev_joint_mats: Optional[np.ndarray] = None

    def model_matrix_np(self) -> np.ndarray:
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        return np.array([
            [c * self.scale, 0, s * self.scale, self.position[0]],
            [0, self.scale, 0, self.position[1]],
            [-s * self.scale, 0, c * self.scale, self.position[2]],
            [0, 0, 0, 1],
        ], np.float32)

    def model_matrix(self, device="cpu") -> torch.Tensor:
        return torch.from_numpy(self.model_matrix_np()).to(device)

    def set_pose(self, mats: np.ndarray):
        """Publish this frame's composed (model ∘ skinning) matrices,
        shifting the previous frame's for motion vectors."""
        mats = np.asarray(mats, np.float32)
        if mats.ndim == 2:
            mats = mats[None]
        self.prev_joint_mats = self.joint_mats \
            if self.joint_mats is not None else mats
        self.joint_mats = mats

    def update_vertices(self, skin_mats=None, device="cpu"):
        """Recompute world-space vertices (skinned if a skeleton and
        `skin_mats` are given), keeping the previous positions."""
        from .skinning import skin_vertices

        self._prev_pos = self._cur_pos
        pos = torch.from_numpy(np.asarray(self.mesh.positions,
                                          np.float32)).to(device)
        norm = torch.from_numpy(np.asarray(self.mesh.normals,
                                           np.float32)).to(device)
        if skin_mats is not None and self.mesh.joints is not None:
            pos, norm = skin_vertices(
                pos, norm, torch.from_numpy(self.mesh.joints).to(device),
                torch.from_numpy(self.mesh.weights).to(device),
                torch.as_tensor(skin_mats, device=device))
        m = self.model_matrix(device)
        p4 = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=-1)
        self._cur_pos = (p4 @ m.T)[:, :3]
        self._cur_norm = norm @ m[:3, :3].T
        if self._prev_pos is None:
            self._prev_pos = self._cur_pos

    def triangles(self):
        """World-space triangle vertices (v0, v1, v2), each (T, 3)."""
        assert self._cur_pos is not None, "call update_vertices first"
        idx = torch.from_numpy(np.asarray(self.mesh.indices, np.int64))
        v = self._cur_pos
        idx = idx.to(v.device)
        return v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]


def make_cuboid(center, size, uv_scale=1.0):
    """Axis-aligned cuboid mesh (the building block of the procedural
    blocky character)."""
    cx, cy, cz = center
    sx, sy, sz = (s * 0.5 for s in size)
    corners = np.array([
        [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
        [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
        [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
        [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz],
    ], np.float32)
    faces = [  # quad corner ids + normal
        ((0, 1, 2, 3), (0, 0, -1)), ((5, 4, 7, 6), (0, 0, 1)),
        ((4, 0, 3, 7), (-1, 0, 0)), ((1, 5, 6, 2), (1, 0, 0)),
        ((3, 2, 6, 7), (0, 1, 0)), ((4, 5, 1, 0), (0, -1, 0)),
    ]
    pos, norm, uv, idx = [], [], [], []
    for quad, n in faces:
        base = len(pos)
        for j, ci in enumerate(quad):
            pos.append(corners[ci])
            norm.append(n)
            uv.append([(j in (1, 2)) * uv_scale, (j in (2, 3)) * uv_scale])
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.array(pos, np.float32), np.array(norm, np.float32),
            np.array(uv, np.float32), np.array(idx, np.int32))


def merge_meshes(parts):
    """((positions, normals, uvs, indices), joint) parts → one MeshData,
    each part rigidly bound to its joint."""
    pos, norm, uv, idx = [], [], [], []
    joints, weights = [], []
    off = 0
    for (p, n, u, i), joint in parts:
        pos.append(p)
        norm.append(n)
        uv.append(u)
        idx.append(i + off)
        joints.append(np.full((len(p), 4), 0, np.int32)
                      + np.array([joint, 0, 0, 0]))
        weights.append(np.tile(np.array([[1.0, 0, 0, 0]], np.float32),
                               (len(p), 1)))
        off += len(p)
    return MeshData(
        positions=np.concatenate(pos), normals=np.concatenate(norm),
        uvs=np.concatenate(uv), indices=np.concatenate(idx),
        joints=np.concatenate(joints), weights=np.concatenate(weights),
    )
