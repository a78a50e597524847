"""Material system: registry → device SoA parameter table (port of the
numpy parts of rtvb_tpu/assets/materials.py)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import yaml

from .blocks import BlockRegistry


@dataclass
class MaterialDef:
    name: str
    albedo: tuple = (0.8, 0.8, 0.8)
    roughness: float = 0.8
    metallic: float = 0.0
    translucency: float = 0.0
    emissive: tuple = (0.0, 0.0, 0.0)
    texture: str | None = None
    image: str | None = None
    uv_scale: float = 1.0


_BUILTIN_MATERIALS = [
    MaterialDef("default", (0.75, 0.75, 0.75), 0.9),
    MaterialDef("sand", (0.82, 0.74, 0.52), 0.95, texture="noise_fine", image="sand"),
    MaterialDef("soil", (0.43, 0.30, 0.18), 0.95, texture="noise_coarse", image="soil"),
    MaterialDef("cliff", (0.45, 0.44, 0.46), 0.85, texture="noise_coarse", image="stone"),
    MaterialDef("rocks", (0.52, 0.50, 0.48), 0.9, texture="noise_mid", image="stone"),
    MaterialDef("grass", (0.30, 0.52, 0.18), 0.9, texture="noise_fine", image="grass"),
    MaterialDef("trunk", (0.36, 0.25, 0.13), 0.9, texture="stripes", image="bark"),
    MaterialDef("leaves", (0.20, 0.45, 0.12), 0.9, translucency=0.4, texture="noise_fine", image="leaves"),
    MaterialDef("plank", (0.62, 0.46, 0.26), 0.8, texture="stripes", image="planks"),
    MaterialDef("brick", (0.58, 0.22, 0.16), 0.85, texture="bricks", image="brick"),
    MaterialDef("glass", (0.95, 0.95, 0.98), 0.02, translucency=0.9),
    MaterialDef("water", (0.12, 0.25, 0.4), 0.05, translucency=0.6),
    MaterialDef("lantern_light", (1.0, 0.9, 0.7), 0.6, emissive=(14.0, 10.5, 6.0)),
    MaterialDef("torch_light", (1.0, 0.8, 0.5), 0.6, emissive=(10.0, 6.5, 3.0)),
    MaterialDef("flower", (0.85, 0.3, 0.35), 0.9),
] + [
    MaterialDef(f"shaderball{i}", (0.9, 0.35, 0.1), i / 9.0,
                metallic=1.0 if i < 5 else 0.0)
    for i in range(10)
]


class MaterialTable(NamedTuple):
    """Device SoA parameter tensors, index = material id."""
    albedo: torch.Tensor        # (N, 3) f32
    roughness: torch.Tensor     # (N,)
    metallic: torch.Tensor
    translucency: torch.Tensor
    emissive: torch.Tensor      # (N, 3)
    texture_id: torch.Tensor    # (N,) i32, -1 = none
    image_id: torch.Tensor      # (N,) i32, -1 = none
    uv_scale: torch.Tensor
    block_to_mat: torch.Tensor  # (B,) i32


@dataclass
class MaterialRegistry:
    materials: list = field(default_factory=lambda: list(_BUILTIN_MATERIALS))

    def __post_init__(self):
        self._by_name = {m.name: i for i, m in enumerate(self.materials)}

    @classmethod
    def from_yaml(cls, path: str) -> "MaterialRegistry":
        with open(path) as f:
            doc = yaml.safe_load(f)
        mats = [_BUILTIN_MATERIALS[0]]
        for e in doc.get("materials", []):
            mats.append(MaterialDef(
                name=e["name"],
                albedo=tuple(e.get("albedo", (0.8, 0.8, 0.8))),
                roughness=float(e.get("roughness", 0.8)),
                metallic=float(e.get("metallic", 0.0)),
                translucency=float(e.get("translucency", 0.0)),
                emissive=tuple(e.get("emissive", (0.0, 0.0, 0.0))),
                texture=e.get("texture"),
                image=e.get("image"),
                uv_scale=float(e.get("uv_scale", 1.0)),
            ))
        return cls(mats)

    def index_of(self, name: str | None) -> int:
        if name is None or name not in self._by_name:
            return 0
        return self._by_name[name]

    def build_table(self, blocks: BlockRegistry,
                    texture_names: dict | None = None,
                    image_names: dict | None = None,
                    device="cpu") -> MaterialTable:
        texture_names = texture_names or {}
        image_names = image_names or {}
        n = len(self.materials)
        alb = np.zeros((n, 3), np.float32)
        rough = np.zeros(n, np.float32)
        metal = np.zeros(n, np.float32)
        trans = np.zeros(n, np.float32)
        emis = np.zeros((n, 3), np.float32)
        tex = np.full(n, -1, np.int32)
        img = np.full(n, -1, np.int32)
        uvs = np.ones(n, np.float32)
        for i, mdef in enumerate(self.materials):
            alb[i] = mdef.albedo
            rough[i] = mdef.roughness
            metal[i] = mdef.metallic
            trans[i] = mdef.translucency
            emis[i] = mdef.emissive
            uvs[i] = mdef.uv_scale
            if mdef.texture is not None and mdef.texture in texture_names:
                tex[i] = texture_names[mdef.texture]
            if mdef.image is not None and mdef.image in image_names:
                img[i] = image_names[mdef.image]
        b2m = np.array([self.index_of(b.material) for b in blocks.blocks],
                       np.int32)
        return material_table_from_numpy(dict(
            albedo=alb, roughness=rough, metallic=metal, translucency=trans,
            emissive=emis, texture_id=tex, image_id=img, uv_scale=uvs,
            block_to_mat=b2m), device)


def material_table_from_numpy(arrays: dict, device="cpu") -> MaterialTable:
    return MaterialTable(**{
        f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(device)
        for f in MaterialTable._fields})
