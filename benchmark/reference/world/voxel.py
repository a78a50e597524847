"""Voxel world: dense block grid + traversal tables (port of
rtvb_tpu/world/voxel.py).

The tables are derived on the host in numpy (exact integer work) and live
on the engine's device FLAT, indexed by column c = x·Z + z — the TPU's
(R, 128) lane layout has no job here:

* ``colmask``  (X·Z,) int32 — bit y set = voxel (x, y, z) occupied (u32 bits)
* ``schema``   (X·Z,) int32 — packed terrain bands (see schema_block_id)
* ``exc_mask`` (X·Z,) int32 — bit y set = voxel deviates from the schema
* ``exc_key``/``exc_id`` (K,) int32 — sorted exception list (key c·Y + y)
* ``df_super``/``maxh_super`` (128,) int32 — supercolumn distance field and
  height envelope (128 slots: the supercell grid the JAX package uses, so
  the DDA's empty-space jumps land on the same t values)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

AIR = 0
EXC_EMPTY = 1 << 30
SUPER_SLOTS = 128


@dataclass(frozen=True)
class WorldConfig:
    """Static world geometry (same fields as the JAX WorldConfig)."""
    chunks_x: int = 2
    chunks_y: int = 1
    chunks_z: int = 2
    chunk_size: int = 32
    max_exceptions: int = 128

    @property
    def x(self) -> int:
        return self.chunks_x * self.chunk_size

    @property
    def y(self) -> int:
        return self.chunks_y * self.chunk_size

    @property
    def z(self) -> int:
        return self.chunks_z * self.chunk_size

    @property
    def n_cols(self) -> int:
        return self.x * self.z

    @property
    def super_size(self) -> int:
        ss = 1
        while (self.x // ss) * (self.z // ss) > SUPER_SLOTS:
            ss *= 2
        return ss

    @property
    def super_x(self) -> int:
        return self.x // self.super_size

    @property
    def super_z(self) -> int:
        return self.z // self.super_size

    def __post_init__(self):
        if self.y > 32:
            raise ValueError("column masks hold at most 32 vertical bits")


class VoxelWorld(NamedTuple):
    blocks: torch.Tensor      # (X, Y, Z) uint8 block ids, 0 = air
    schema: torch.Tensor      # (X·Z,) int32
    colmask: torch.Tensor     # (X·Z,) int32 (u32 bits)
    exc_mask: torch.Tensor    # (X·Z,) int32 (u32 bits)
    exc_key: torch.Tensor     # (K,) int32 ascending, EXC_EMPTY = free
    exc_id: torch.Tensor      # (K,) int32
    df_super: torch.Tensor    # (128,) int32
    maxh_super: torch.Tensor  # (128,) int32


class HostWorld(NamedTuple):
    """The engine's host copy of the block grid, (X, Y, Z) uint8, and the
    world version the engine bumps on every edit (the key a reader of the
    grid caches by: the device tables are written in place)."""
    blocks: np.ndarray
    version: int


def pack_schema(h1, h2, id_deep, id_mid, id_surf):
    return (np.asarray(h1, np.int32) | (np.asarray(h2, np.int32) << 5)
            | (np.asarray(id_deep, np.int32) << 10)
            | (np.asarray(id_mid, np.int32) << 16)
            | (np.asarray(id_surf, np.int32) << 22))


def schema_block_id(schema, y):
    """Arithmetic block id from a packed column schema at height y (numpy
    arrays or torch tensors)."""
    h1 = schema & 31
    h2 = (schema >> 5) & 31
    id_deep = (schema >> 10) & 63
    id_mid = (schema >> 16) & 63
    id_surf = (schema >> 22) & 63
    if isinstance(schema, torch.Tensor):
        return torch.where(y < h1, id_deep, torch.where(y < h2, id_mid, id_surf))
    return np.where(y < h1, id_deep, np.where(y < h2, id_mid, id_surf))


def _bits_over_y(flags: np.ndarray) -> np.ndarray:
    """(X, Y, Z) bool → (X·Z,) int32 bit masks (bit y)."""
    y = np.arange(flags.shape[1], dtype=np.uint64)[None, :, None]
    m = (flags.astype(np.uint64) << y).sum(axis=1).astype(np.uint32)
    return m.reshape(-1).view(np.int32)


def build_colmask(cfg: WorldConfig, blocks: np.ndarray,
                  nonsolid_ids: tuple = ()) -> np.ndarray:
    occ = blocks != AIR
    for nid in nonsolid_ids:
        occ &= blocks != nid
    return _bits_over_y(occ)


def _column_heights(colmask: np.ndarray) -> np.ndarray:
    """Index of the highest set bit + 1 per column (0 for empty)."""
    m = colmask.view(np.uint32)
    h = np.zeros(m.shape, np.int32)
    for y in range(32):
        h = np.where((m >> np.uint32(y)) & 1, y + 1, h)
    return h


def build_super_df(cfg: WorldConfig, colmask: np.ndarray) -> np.ndarray:
    ss = cfg.super_size
    occ_col = (colmask.reshape(cfg.x, cfg.z) != 0)
    occ_super = occ_col.reshape(cfg.super_x, ss, cfg.super_z, ss).any(axis=(1, 3))
    sx = np.arange(cfg.super_x)
    sz = np.arange(cfg.super_z)
    dx = np.abs(sx[:, None, None, None] - sx[None, None, :, None])
    dz = np.abs(sz[None, :, None, None] - sz[None, None, None, :])
    cheb = np.maximum(dx, dz)
    big = cfg.super_x + cfg.super_z
    dist = np.min(np.where(occ_super[None, None], cheb, big), axis=(2, 3))
    dist = np.where(occ_super, 0, dist)
    flat = dist.reshape(-1).astype(np.int32)
    return np.concatenate([flat, np.full(SUPER_SLOTS - flat.shape[0], big,
                                         np.int32)])


def build_super_maxh(cfg: WorldConfig, colmask: np.ndarray) -> np.ndarray:
    ss = cfg.super_size
    h = _column_heights(colmask).reshape(cfg.x, cfg.z)
    hs = h.reshape(cfg.super_x, ss, cfg.super_z, ss).max(axis=(1, 3))
    flat = hs.reshape(-1).astype(np.int32)
    # pad with the WORLD max height (keeps max(maxh) the real envelope)
    return np.concatenate([flat, np.full(SUPER_SLOTS - flat.shape[0],
                                         flat.max(), np.int32)])


def predicted_blocks(cfg: WorldConfig, schema: np.ndarray,
                     colmask: np.ndarray) -> np.ndarray:
    sch = schema.reshape(cfg.x, cfg.z)[:, None, :]
    y = np.arange(cfg.y, dtype=np.int32)[None, :, None]
    ids = schema_block_id(sch, y)
    occ = (colmask.view(np.uint32).reshape(cfg.x, cfg.z)[:, None, :]
           >> y.astype(np.uint32)) & 1
    return np.where(occ == 1, ids, AIR).astype(np.uint8)


def build_tables_np(cfg: WorldConfig, blocks: np.ndarray, schema: np.ndarray,
                    nonsolid_ids: tuple = ()) -> dict:
    """All traversal tables as numpy arrays (exact)."""
    blocks = np.asarray(blocks, np.uint8)
    schema = np.asarray(schema, np.int32).reshape(-1)
    colmask = build_colmask(cfg, blocks, nonsolid_ids)
    pred = predicted_blocks(cfg, schema, colmask)
    is_exc = (blocks != AIR) & (blocks != pred)
    exc_mask = _bits_over_y(is_exc)
    flat_exc = is_exc.transpose(0, 2, 1).reshape(-1)     # key c·Y + y
    k = cfg.max_exceptions
    keys = np.nonzero(flat_exc)[0][:k].astype(np.int32)
    exc_key = np.full(k, EXC_EMPTY, np.int32)
    exc_key[:len(keys)] = keys
    exc_id = np.zeros(k, np.int32)
    exc_id[:len(keys)] = blocks.transpose(0, 2, 1).reshape(-1)[keys]
    return dict(blocks=blocks, schema=schema, colmask=colmask,
                exc_mask=exc_mask, exc_key=exc_key, exc_id=exc_id,
                df_super=build_super_df(cfg, colmask),
                maxh_super=build_super_maxh(cfg, colmask))


def world_from_numpy(tables: dict, device="cpu") -> VoxelWorld:
    # np.array copies: callers may hand in read-only views
    return VoxelWorld(**{f: torch.from_numpy(np.array(tables[f], order="C"))
                         .to(device) for f in VoxelWorld._fields})


def build_tables(cfg: WorldConfig, blocks, schema, nonsolid_ids: tuple = (),
                 device="cpu") -> VoxelWorld:
    """Re-derive all traversal tables from the dense grid."""
    if isinstance(blocks, torch.Tensor):
        blocks = blocks.cpu().numpy()
    if isinstance(schema, torch.Tensor):
        schema = schema.cpu().numpy()
    return world_from_numpy(build_tables_np(cfg, blocks, schema, nonsolid_ids),
                            device)


def exception_count_np(cfg: WorldConfig, tables: dict) -> int:
    """Number of voxels deviating from the column schema, from host tables
    (build_tables_np's).  Past cfg.max_exceptions the list keeps the
    lowest keys and drops the rest (Engine._after_edit grows it first)."""
    pred = predicted_blocks(cfg, tables["schema"], tables["colmask"])
    blocks = tables["blocks"]
    return int(np.sum((blocks != AIR) & (blocks != pred)))


def world_to_numpy(world: VoxelWorld) -> dict:
    """The world's tables as host arrays (build_tables_np's layout)."""
    return {f: getattr(world, f).cpu().numpy() for f in VoxelWorld._fields}


def exception_count(cfg: WorldConfig, world: VoxelWorld) -> int:
    """exception_count_np of a device world."""
    return exception_count_np(cfg, world_to_numpy(world))


def set_blocks(cfg: WorldConfig, world: VoxelWorld, xyz, ids,
               nonsolid_ids: tuple = ()) -> VoxelWorld:
    """Place / remove N blocks (id 0 deletes), then rebuild the tables
    once on the host, on the world's device."""
    blocks = world.blocks.cpu().numpy().copy()
    xyz = np.asarray(xyz, np.int64).reshape(-1, 3)
    blocks[xyz[:, 0], xyz[:, 1], xyz[:, 2]] = np.asarray(ids, np.uint8)
    return build_tables(cfg, blocks, world.schema, nonsolid_ids,
                        world.blocks.device)


def set_block(cfg: WorldConfig, world: VoxelWorld, ix, iy, iz, block_id,
              nonsolid_ids: tuple = ()) -> VoxelWorld:
    """Place / remove one block (block_id 0 deletes) and rebuild."""
    return set_blocks(cfg, world, [[ix, iy, iz]], [block_id], nonsolid_ids)


def block_id_at(cfg: WorldConfig, world: VoxelWorld, ix, iy, iz):
    """Block id lookup from the dense grid (AIR outside the world)."""
    flat = world.blocks.reshape(-1)
    idx = (ix * cfg.y * cfg.z + iy * cfg.z + iz).to(torch.int64)
    inb = ((ix >= 0) & (ix < cfg.x) & (iy >= 0) & (iy < cfg.y)
           & (iz >= 0) & (iz < cfg.z))
    got = flat[torch.clamp(idx, 0, flat.shape[0] - 1)]
    return torch.where(inb, got, torch.zeros_like(got))
