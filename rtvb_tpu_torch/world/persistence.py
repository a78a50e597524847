"""World persistence: a content-addressed chunk store and scene YAML (port
of rtvb_tpu/world/persistence.py, the same files byte for byte).

* per-world scene YAML (camera pose, character transform, chunk records)
* content-addressed chunk blobs: FNV-1a-64 of the raw chunk bytes →
  `<hash>.bin`, identical chunks stored once
* worlds metadata with the last-played world (list, save, load).

A save reads the engine's host copies (`Engine.host_world`,
`Engine._host_tables()`): nothing is read back from the card.  A load
builds the tables on the host and puts them on the requested device.
"""
from __future__ import annotations

import os
import time

import numpy as np
import yaml

from .voxel import WorldConfig, VoxelWorld, build_tables


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64: native C when built, else the Python loop."""
    from ..utils import native
    h = native.fnv1a64(data)
    if h is not None:
        return h
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _host(a) -> np.ndarray:
    """A host array of a table: numpy as it is, a CPU tensor as a view; a
    tensor on the card is refused (a save reads host copies)."""
    if hasattr(a, "is_cuda"):
        if a.is_cuda:
            raise ValueError("WorldStore.save takes host tables (the "
                             "engine's host copies), not tensors on the card")
        return a.numpy()
    return np.asarray(a)


class WorldStore:
    """Directory layout:
        root/worlds.yaml                 (world list + last_world)
        root/<world>/scene.yaml          (camera/character/chunk records)
        root/<world>/chunks/<hash>.bin   (content-addressed chunk blobs)
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # ---- metadata ----

    def _meta_path(self):
        return os.path.join(self.root, "worlds.yaml")

    def _load_meta(self) -> dict:
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                return yaml.safe_load(f) or {}
        return {"worlds": {}, "last_world": None}

    def _save_meta(self, meta: dict):
        with open(self._meta_path(), "w") as f:
            yaml.safe_dump(meta, f, sort_keys=False)

    def list_worlds(self):
        return sorted(self._load_meta().get("worlds", {}).keys())

    def last_world(self):
        return self._load_meta().get("last_world")

    # ---- save / load ----

    def save(self, name: str, cfg: WorldConfig, tables: dict,
             camera: dict | None = None, character: dict | None = None):
        """tables: the world's host tables with `blocks` (X, Y, Z) u8 and
        `schema` (the engine's `_host_tables()`, or a CPU VoxelWorld's
        `_asdict()`)."""
        wdir = os.path.join(self.root, name)
        cdir = os.path.join(wdir, "chunks")
        os.makedirs(cdir, exist_ok=True)

        blocks = _host(tables["blocks"])
        cs = cfg.chunk_size
        records = []
        for cx in range(cfg.chunks_x):
            for cy in range(cfg.chunks_y):
                for cz in range(cfg.chunks_z):
                    chunk = blocks[cx * cs:(cx + 1) * cs,
                                   cy * cs:(cy + 1) * cs,
                                   cz * cs:(cz + 1) * cs]
                    data = chunk.tobytes()
                    h = fnv1a64(data)
                    blob = os.path.join(cdir, f"{h:016x}.bin")
                    if not os.path.exists(blob):   # dedup identical chunks
                        with open(blob, "wb") as f:
                            f.write(data)
                    records.append({"pos": [cx, cy, cz], "hash": f"{h:016x}"})

        scene = {
            "world_config": {"chunks": [cfg.chunks_x, cfg.chunks_y, cfg.chunks_z],
                             "chunk_size": cs},
            "schema": _host(tables["schema"]).reshape(-1).tolist(),
            "chunks": records,
            "camera": camera or {},
            "character": character or {},
            "saved_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        with open(os.path.join(wdir, "scene.yaml"), "w") as f:
            yaml.safe_dump(scene, f, sort_keys=False)

        meta = self._load_meta()
        meta.setdefault("worlds", {})[name] = {"saved_at": scene["saved_at"]}
        meta["last_world"] = name
        self._save_meta(meta)

    def load(self, name: str, nonsolid_ids: tuple = (), device="cuda"):
        """Returns (cfg, VoxelWorld on `device`, camera dict, character
        dict): the chunks read back, each checked against its hash, and the
        tables rebuilt.  The tables go to the card unless the caller asks
        for the CPU, as the Engine's do."""
        wdir = os.path.join(self.root, name)
        with open(os.path.join(wdir, "scene.yaml")) as f:
            scene = yaml.safe_load(f)
        wc = scene["world_config"]
        cfg = WorldConfig(chunks_x=wc["chunks"][0], chunks_y=wc["chunks"][1],
                          chunks_z=wc["chunks"][2], chunk_size=wc["chunk_size"])
        cs = cfg.chunk_size
        blocks = np.zeros((cfg.x, cfg.y, cfg.z), np.uint8)
        for rec in scene["chunks"]:
            cx, cy, cz = rec["pos"]
            blob = os.path.join(wdir, "chunks", rec["hash"] + ".bin")
            with open(blob, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8).reshape(cs, cs, cs)
            # integrity check: the stored hash must match the content (the
            # JAX package's AssertionError, raised also under python -O)
            if f"{fnv1a64(data.tobytes()):016x}" != rec["hash"]:
                raise AssertionError(f"corrupt chunk blob {rec['hash']}")
            blocks[cx * cs:(cx + 1) * cs, cy * cs:(cy + 1) * cs,
                   cz * cs:(cz + 1) * cs] = data

        schema = np.array(scene["schema"], np.int32)
        world: VoxelWorld = build_tables(cfg, blocks, schema,
                                         tuple(nonsolid_ids), device=device)

        meta = self._load_meta()
        meta["last_world"] = name
        self._save_meta(meta)
        return cfg, world, scene.get("camera", {}), scene.get("character", {})
