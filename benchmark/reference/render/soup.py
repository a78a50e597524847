"""The triangle soup the frame intersects — decorations and live
entities — at fixed addresses (the port's counterpart of the JAX
package's `entity_buffers` and `_pack_entity_tris`,
rtvb_tpu/render/renderer.py:49-91 and :351-447).

A `Soup` holds one `pathtracer.EntityBuffers` of t_max rows (a power of
two ≥ 16): the decoration rows first, then each entity's triangles, then
zero padding.  Its tensors keep their addresses while t_max stands, so a
captured frame that reads them stays valid:
- `write_static` writes the rows that change only on an edit or a new
  entity set (the decorations' geometry, every row's material, light
  slot, UVs and image id, zeros in the entity and padding rows) in
  place;
- `pack_entity` writes one entity's rows of `tri_packed`, `normals` and
  `prev_v0/1/2` in place from its current and previous pose matrices
  (linear-blend skinning, or the model transform alone for an unskinned
  mesh), on the current stream before the frame: the JAX package's
  separate `_pack_entity_tris` dispatch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.skinning import skin_positions
from . import frame_graph
from .pathtracer import EntityBuffers

MIN_ROWS = 16


def soup_rows(n_tris: int) -> int:
    """Rows of a soup of n_tris triangles: the next power of two ≥ 16 (the
    intersector's cost is linear in the rows; a bucket recaptures
    once)."""
    t_max = MIN_ROWS
    while t_max < n_tris:
        t_max *= 2
    return t_max


class EntityStatic(NamedTuple):
    """An entity's mesh on the device, uploaded once: bind-pose positions,
    skinning joints and weights (None when unskinned), triangle corners."""
    pos: torch.Tensor              # (N, 3) f32
    joints: torch.Tensor | None    # (N, 4) int64
    weights: torch.Tensor | None   # (N, 4) f32
    i0: torch.Tensor               # (T,) int64
    i1: torch.Tensor
    i2: torch.Tensor


def entity_static(mesh, device) -> EntityStatic:
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    idx = np.asarray(mesh.indices)
    return EntityStatic(
        pos=t(mesh.positions, torch.float32),
        joints=(t(mesh.joints, torch.int64) if mesh.joints is not None
                else None),
        weights=(t(mesh.weights, torch.float32) if mesh.weights is not None
                 else None),
        i0=t(idx[:, 0], torch.int64), i1=t(idx[:, 1], torch.int64),
        i2=t(idx[:, 2], torch.int64))


def world_vertices(st: EntityStatic, mats: torch.Tensor) -> torch.Tensor:
    """World-space vertices under (J, 4, 4) composed pose matrices:
    skinned when the mesh has joints and the pose more than one matrix,
    else the one (model) matrix applied."""
    if st.joints is not None and mats.shape[0] > 1:
        return skin_positions(st.pos, st.joints, st.weights, mats)
    p4 = torch.cat([st.pos, torch.ones_like(st.pos[:, :1])], dim=-1)
    return (p4 @ mats[0].T)[:, :3]


def decoration_geometry(dv0, dv1, dv2) -> dict:
    """The decoration rows' host geometry: packed [v0 | e1 | e2], unit
    geometric normals, and the vertices (a static row's previous frame is
    itself)."""
    nrm = np.cross(dv1 - dv0, dv2 - dv0)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                           1e-12)
    return dict(tri_packed=np.concatenate([dv0, dv1 - dv0, dv2 - dv0],
                                          axis=-1),
                normals=nrm.astype(np.float32), prev_v0=dv0, prev_v1=dv1,
                prev_v2=dv2)


def static_arrays(t_max: int, decor, entities: list) -> dict:
    """Host arrays of every field of a t_max-row soup: the decoration
    rows' geometry and metadata, then per entity (n_tris, material
    index, (T, 6) per-corner UVs, atlas image slot) its metadata with
    zero geometry, then padding (material 0, light slot -1, image -1)."""
    dv0, dv1, dv2, dmat, dslot = decor
    nd = len(dv0)
    out = {f: np.zeros((t_max, w), np.float32) for f, w in (
        ("tri_packed", 9), ("normals", 3), ("prev_v0", 3), ("prev_v1", 3),
        ("prev_v2", 3), ("uvs", 6))}
    for f, a in decoration_geometry(dv0, dv1, dv2).items():
        out[f][:nd] = a
    out["mat_index"] = np.zeros(t_max, np.int32)
    out["light_slot"] = np.full(t_max, -1, np.int32)
    out["image_id"] = np.full(t_max, -1, np.int32)
    out["mat_index"][:nd] = dmat
    out["light_slot"][:nd] = dslot
    row = nd
    for n, mat, uv, img in entities:
        out["mat_index"][row:row + n] = mat
        out["uvs"][row:row + n] = uv
        out["image_id"][row:row + n] = img
        row += n
    return out


class Soup:
    """A t_max-row EntityBuffers at fixed addresses (module docstring)."""

    def __init__(self, t_max: int, device: torch.device):
        def f32(w):
            return torch.zeros((t_max, w), dtype=torch.float32,
                               device=device)
        self.buffers = EntityBuffers(
            tri_packed=f32(9), normals=f32(3), prev_v0=f32(3),
            prev_v1=f32(3), prev_v2=f32(3),
            mat_index=torch.zeros(t_max, dtype=torch.int32, device=device),
            light_slot=torch.full((t_max,), -1, dtype=torch.int32,
                                  device=device),
            uvs=f32(6),
            image_id=torch.full((t_max,), -1, dtype=torch.int32,
                                device=device))

    @property
    def t_max(self) -> int:
        return self.buffers.tri_packed.shape[0]

    def clone(self) -> "Soup":
        new = object.__new__(Soup)
        new.buffers = EntityBuffers(*(t.clone() for t in self.buffers))
        return new

    def write_static(self, arrays: dict) -> None:
        if not frame_graph.write_fields(self.buffers, arrays):
            raise ValueError("static arrays of another soup size")

    def pack_entity(self, row0: int, st: EntityStatic, cur: torch.Tensor,
                    prev: torch.Tensor) -> None:
        """Write the entity's rows [row0, row0 + T) from its current and
        previous (J, 4, 4) pose matrices."""
        rows = slice(row0, row0 + st.i0.shape[0])
        b = self.buffers
        cp = world_vertices(st, cur)
        pp = world_vertices(st, prev)
        v0, v1, v2 = cp[st.i0], cp[st.i1], cp[st.i2]
        e1, e2 = v1 - v0, v2 - v0
        b.tri_packed[rows].copy_(torch.cat([v0, e1, e2], dim=-1))
        n = torch.linalg.cross(e1, e2)
        b.normals[rows].copy_(n / torch.clamp(
            torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12))
        b.prev_v0[rows].copy_(pp[st.i0])
        b.prev_v1[rows].copy_(pp[st.i1])
        b.prev_v2[rows].copy_(pp[st.i2])
