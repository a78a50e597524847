"""Instanced decoration meshes (flowers, torches, lanterns) — port of
rtvb_tpu/assets/decorations.py.

The procedural meshes and the model registry come from the JAX package's
decorations module, which imports no jax at module level; only its OBJ
path (`ModelRegistry.mesh` → `assets/models.load_obj`) pulls jax in, so
the OBJ loader and the mesh resolution live here instead.
"""
from __future__ import annotations

import os

import numpy as np

from rtvb_tpu.assets.decorations import PROCEDURAL_MESHES, registry

_REPO_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")


def load_obj_triangles(path: str):
    """Positions of an OBJ's faces (fan-triangulated) as (v0, v1, v2) float32
    arrays — the geometry part of the JAX package's load_obj."""
    vs, tris = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "f":
                ids = [int(s.split("/")[0]) - 1 for s in t[1:]]
                for k in range(1, len(ids) - 1):
                    tris.append((ids[0], ids[k], ids[k + 1]))
    pos = np.array(vs, np.float32)
    idx = np.array(tris, np.int64).reshape(-1, 3)
    return pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]


class DecorationMeshes:
    """Resolved base / light meshes per decoration name (cached)."""

    def __init__(self):
        self._reg = registry()
        self._cache: dict = {}

    @property
    def registry(self):
        return self._reg

    def base_material(self, name: str, default=None):
        return self._reg.base_material(name, default)

    def mesh(self, name: str):
        if name not in self._cache:
            e = self._reg.entry(name)
            mesh = None
            path = e.get("file")
            if path:
                full = os.path.join(_REPO_ROOT, path)
                if os.path.exists(full) and full.endswith(".obj"):
                    mesh = load_obj_triangles(full)
            if mesh is None and e.get("mesh") in PROCEDURAL_MESHES:
                mesh = PROCEDURAL_MESHES[e["mesh"]]()
            self._cache[name] = mesh
        return self._cache[name]

    def light_mesh(self, name: str):
        key = ("light", name)
        if key not in self._cache:
            self._cache[key] = self._reg.light_mesh(name)
        return self._cache[key]

    def decoration_triangles(self, name: str, positions: np.ndarray,
                             include_light: bool = True):
        """Instance a decoration mesh at voxel min-corner positions (N, 3).
        Returns (v0, v1, v2, is_light) stacked over all instances."""
        mesh = self.mesh(name)
        parts = []
        if mesh is not None:
            v0, v1, v2 = mesh
            parts.append((v0, v1, v2, np.zeros(len(v0), bool)))
        lm = self.light_mesh(name) if include_light else None
        if lm is not None:
            v0, v1, v2 = lm
            parts.append((v0, v1, v2, np.ones(len(v0), bool)))
        if not parts or len(positions) == 0:
            z = np.zeros((0, 3), np.float32)
            return z, z, z, np.zeros(0, bool)
        mv0, mv1, mv2, ml = (np.concatenate([p[i] for p in parts])
                             for i in range(4))
        outs = [[], [], [], []]
        for p in positions:
            p = np.asarray(p, np.float32)
            outs[0].append(mv0 + p)
            outs[1].append(mv1 + p)
            outs[2].append(mv2 + p)
            outs[3].append(ml)
        return tuple(np.concatenate(o) for o in outs)
