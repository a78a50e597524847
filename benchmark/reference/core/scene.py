"""Scene configuration: camera/character pose + world reference, YAML I/O.

Parity with the reference's SceneConfig (renderer/core/SceneConfig.{h,cpp},
data/scene/scene_export.yaml: camera + character pose used by the offline
renderer and world save/load).

The port's own copy of rtvb_tpu/core/scene.py, so that reference
never imports the JAX package."""
from __future__ import annotations

from dataclasses import dataclass, asdict

import yaml


@dataclass
class SceneConfig:
    camera_pos: tuple = (32.0, 18.0, 8.0)
    camera_yaw: float = 1.1
    camera_pitch: float = -0.35
    character_pos: tuple = (32.0, 12.0, 32.0)
    character_yaw: float = 0.0
    world_seed: int = 124

    def save(self, path: str) -> None:
        d = asdict(self)
        d["camera_pos"] = list(self.camera_pos)
        d["character_pos"] = list(self.character_pos)
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "SceneConfig":
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        if "camera_pos" in d:
            d["camera_pos"] = tuple(d["camera_pos"])
        if "character_pos" in d:
            d["character_pos"] = tuple(d["character_pos"])
        return cls(**d)
