"""Instanced decoration meshes (flowers, torches, lanterns) — port of
rtvb_tpu/assets/decorations.py.

The procedural meshes, the builtin model table and the model registry are
the port's own copies of the JAX package's (same names and geometry); a
mesh file is read by the port's `assets/models.load_obj`.
"""
from __future__ import annotations

import os

import numpy as np

_REPO_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")


def flower_mesh():
    """Two crossed quads (classic sprite-cross plant), 4 triangles."""
    h, r = 0.8, 0.35
    quads = []
    for ang in (0.0, np.pi / 2):
        c, s = np.cos(ang), np.sin(ang)
        a = np.array([0.5 - r * c, 0.0, 0.5 - r * s], np.float32)
        b = np.array([0.5 + r * c, 0.0, 0.5 + r * s], np.float32)
        quads.append((a, b))
    v0, v1, v2 = [], [], []
    for a, b in quads:
        at = a + [0, h, 0]
        bt = b + [0, h, 0]
        v0 += [a, a]
        v1 += [b, bt]
        v2 += [bt, at]
    return np.stack(v0), np.stack(v1), np.stack(v2)


def torch_mesh():
    """Thin vertical box (8 side triangles + 2 top), ~0.15 wide, 0.7 tall."""
    r, h = 0.075, 0.7
    c = 0.5
    corners = np.array([
        [c - r, 0, c - r], [c + r, 0, c - r], [c + r, 0, c + r], [c - r, 0, c + r],
        [c - r, h, c - r], [c + r, h, c - r], [c + r, h, c + r], [c - r, h, c + r],
    ], np.float32)
    quads = [(0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7), (4, 5, 6, 7)]
    v0, v1, v2 = [], [], []
    for a, b, cc, d in quads:
        v0 += [corners[a], corners[a]]
        v1 += [corners[b], corners[cc]]
        v2 += [corners[cc], corners[d]]
    return np.stack(v0), np.stack(v1), np.stack(v2)


def _box(lo, hi):
    """12 triangles of an axis-aligned box [lo, hi], outward winding."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    faces = [
        ((x0, y0, z0), (0, 0, z1 - z0), (0, y1 - y0, 0)),   # -x
        ((x1, y0, z0), (0, y1 - y0, 0), (0, 0, z1 - z0)),   # +x
        ((x0, y0, z0), (x1 - x0, 0, 0), (0, 0, z1 - z0)),   # -y
        ((x0, y1, z0), (0, 0, z1 - z0), (x1 - x0, 0, 0)),   # +y
        ((x0, y0, z0), (0, y1 - y0, 0), (x1 - x0, 0, 0)),   # -z
        ((x0, y0, z1), (x1 - x0, 0, 0), (0, y1 - y0, 0)),   # +z
    ]
    # quad (o, o+eu, o+eu+ev, o+ev) → tris (o, o+eu, o+eu+ev), (o, o+eu+ev, o+ev)
    v0, v1, v2 = [], [], []
    for o, eu, ev in faces:
        o = np.array(o, np.float32)
        eu = np.array(eu, np.float32)
        ev = np.array(ev, np.float32)
        v0 += [o, o]
        v1 += [o + eu, o + eu + ev]
        v2 += [o + eu + ev, o + ev]
    return np.stack(v0), np.stack(v1), np.stack(v2)


def lantern_mesh():
    """Lantern = base cage (non-emissive) + inner glow box (light mesh).
    The light/base pairing of the reference's BlockManager (lantern = light
    mesh + base mesh, docs/ASSET_SYSTEM_GUIDE.md) — the base occludes,
    only the glow box reaches the light table."""
    base_parts = [
        _box((0.15, 0.0, 0.15), (0.85, 0.08, 0.85)),    # bottom plate
        _box((0.15, 0.78, 0.15), (0.85, 0.88, 0.85)),   # top cap
        _box((0.44, 0.88, 0.44), (0.56, 1.0, 0.56)),    # hanger knob
    ]
    v0 = np.concatenate([p[0] for p in base_parts])
    v1 = np.concatenate([p[1] for p in base_parts])
    v2 = np.concatenate([p[2] for p in base_parts])
    return v0, v1, v2


def lantern_light_mesh():
    return _box((0.28, 0.08, 0.28), (0.72, 0.78, 0.72))


def torch_light_mesh():
    """Small flame box atop the torch handle."""
    return _box((0.42, 0.7, 0.42), (0.58, 0.88, 0.58))


# procedural mesh ids referenced by data/assets/models.yaml `mesh:` /
# `light_mesh:` fields
PROCEDURAL_MESHES = {
    "flower": flower_mesh,
    "torch": torch_mesh,
    "lantern": lantern_mesh,
    "lantern_light": lantern_light_mesh,
    "torch_light": torch_light_mesh,
}

_MODELS_YAML = os.path.join(_REPO_ROOT, "data", "assets", "models.yaml")

# builtin registry — the fallback when data/assets/models.yaml is absent
# (AssetRegistry's hardcoded-fallback contract)
_BUILTIN_MODELS = {
    "flower": {"file": "data/models/flower.obj", "mesh": "flower"},
    "torch": {"mesh": "torch", "light_mesh": "torch_light",
              "base_material": "plank"},
    "lantern": {"mesh": "lantern", "light_mesh": "lantern_light",
                "base_material": "trunk"},
    "character": {"file": "data/models/character.glb"},
}


class ModelRegistry:
    """data/assets/models.yaml (AssetRegistry.h:13-84 ModelDefinition role):
    maps decoration/entity names to mesh files, procedural mesh ids,
    emissive sub-meshes and base materials.  Mesh files are resolved by
    DecorationMeshes below."""

    def __init__(self, entries: dict | None = None):
        self.entries = dict(_BUILTIN_MODELS if entries is None else entries)

    @classmethod
    def load_default(cls) -> "ModelRegistry":
        if os.path.exists(_MODELS_YAML):
            import yaml
            with open(_MODELS_YAML) as f:
                doc = yaml.safe_load(f) or {}
            entries = {e["name"]: {k: v for k, v in e.items() if k != "name"}
                       for e in doc.get("models", [])}
            return cls(entries)
        return cls()

    def entry(self, name: str) -> dict:
        return self.entries.get(name, {})

    def base_material(self, name: str, default=None):
        return self.entry(name).get("base_material", default)

    def light_mesh(self, name: str):
        mid = self.entry(name).get("light_mesh")
        return PROCEDURAL_MESHES[mid]() if mid in PROCEDURAL_MESHES else None


_registry: ModelRegistry | None = None


def registry() -> ModelRegistry:
    global _registry
    if _registry is None:
        _registry = ModelRegistry.load_default()
    return _registry


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
                    from .models import load_obj
                    md = load_obj(full)
                    idx = md.indices
                    mesh = tuple(md.positions[idx[:, k]].astype(np.float32)
                                 for k in range(3))
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
