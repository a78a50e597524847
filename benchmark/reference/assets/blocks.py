"""Block registry: ids, classification, material binding.

Capability parity with the reference's BlockManager + generated BlockType enum
(renderer/assets/BlockManager.{h,cpp}, generated/voxelengine/BlockType.h:6-40,
scripts/generate_block_types.py): block types come from data/assets/blocks.yaml
with a built-in fallback set; classification covers solid/transparent/emissive
and instanced decoration models vs. plain cubes.  No build-time codegen is
needed — the registry is a runtime table (ids are stable: YAML order).

The port's own copy of rtvb_tpu/assets/blocks.py (same ids, names and
classes), so that reference never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import yaml

# Fallback built-in block set, mirroring the reference's 30-type roster
# (terrain blocks, functional blocks, test shader balls 0..9 with roughness
# ramp — VoxelSceneGen.cu:121-161).
_BUILTIN_BLOCKS = [
    # name, material, is_transparent, is_emissive, is_instanced_model
    ("air", None, True, False, False),
    ("sand", "sand", False, False, False),
    ("soil", "soil", False, False, False),
    ("cliff", "cliff", False, False, False),
    ("rocks", "rocks", False, False, False),
    ("grass", "grass", False, False, False),
    ("trunk", "trunk", False, False, False),
    ("leaves", "leaves", True, False, False),
    ("plank", "plank", False, False, False),
    ("brick", "brick", False, False, False),
    ("glass", "glass", True, False, False),
    ("water", "water", True, False, False),
    ("lantern", "lantern_light", False, True, True),
    ("torch", "torch_light", False, True, True),
    ("flower", "flower", True, False, True),
] + [
    (f"shaderball{i}", f"shaderball{i}", False, False, False) for i in range(10)
]


@dataclass(frozen=True)
class BlockDef:
    id: int
    name: str
    material: str | None
    transparent: bool = False
    emissive: bool = False
    instanced: bool = False   # decoration mesh instead of a full cube


@dataclass
class BlockRegistry:
    blocks: list = field(default_factory=list)

    def __post_init__(self):
        self._by_name = {b.name: b for b in self.blocks}

    @classmethod
    def builtin(cls) -> "BlockRegistry":
        return cls([
            BlockDef(i, n, m, t, e, inst)
            for i, (n, m, t, e, inst) in enumerate(_BUILTIN_BLOCKS)
        ])

    @classmethod
    def from_yaml(cls, path: str) -> "BlockRegistry":
        with open(path) as f:
            doc = yaml.safe_load(f)
        blocks = [BlockDef(0, "air", None, True, False, False)]
        for entry in doc.get("blocks", []):
            blocks.append(BlockDef(
                id=len(blocks),
                name=entry["name"],
                material=entry.get("material", entry["name"]),
                transparent=bool(entry.get("transparent", False)),
                emissive=bool(entry.get("emissive", False)),
                instanced=bool(entry.get("instanced", False)),
            ))
        return cls(blocks)

    def save_yaml(self, path: str) -> None:
        doc = {"blocks": [
            {"name": b.name, "material": b.material,
             "transparent": b.transparent, "emissive": b.emissive,
             "instanced": b.instanced}
            for b in self.blocks if b.id != 0
        ]}
        with open(path, "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)

    def id_of(self, name: str) -> int:
        return self._by_name[name].id

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._by_name[key]
        return self.blocks[key]

    def __len__(self):
        return len(self.blocks)

    @property
    def emissive_ids(self):
        return [b.id for b in self.blocks if b.emissive]

    @property
    def transparent_ids(self):
        return [b.id for b in self.blocks if b.transparent]

    @property
    def instanced_ids(self):
        return [b.id for b in self.blocks if b.instanced]


# Convenience ids for the builtin set (world gen uses these).
_REG = BlockRegistry.builtin()
AIR = _REG.id_of("air")
SAND = _REG.id_of("sand")
SOIL = _REG.id_of("soil")
CLIFF = _REG.id_of("cliff")
ROCKS = _REG.id_of("rocks")
GRASS = _REG.id_of("grass")
PLANK = _REG.id_of("plank")
BRICK = _REG.id_of("brick")
LANTERN = _REG.id_of("lantern")
GLASS = _REG.id_of("glass")
WATER = _REG.id_of("water")
FLOWER = _REG.id_of("flower")
SHADERBALL0 = _REG.id_of("shaderball0")
