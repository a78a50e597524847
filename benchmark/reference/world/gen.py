"""Procedural world generation: Perlin-noise terrain with layered bands,
the shader-ball test row and the flower decorations (port of
rtvb_tpu/world/gen.py; host numpy in float32)."""
from __future__ import annotations

import numpy as np

from ..assets import blocks as B

from .voxel import WorldConfig, VoxelWorld, build_tables_np, pack_schema, \
    world_from_numpy

DEFAULT_SEED = 124
FLOWER_SPOTS = ((20, 50), (22, 48), (45, 20), (50, 36))

f32 = np.float32


def _perm_table(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.permutation(256).astype(np.int32)
    return np.concatenate([p, p])


def perlin2(x, z, perm):
    """Vectorized 2-D Perlin noise in [-1, 1] (float32)."""
    xi = np.floor(x).astype(np.int32)
    zi = np.floor(z).astype(np.int32)
    xf = x - xi.astype(f32)
    zf = z - zi.astype(f32)
    xi = xi & 255
    zi = zi & 255

    def fade(t):
        return t * t * t * (t * (t * f32(6.0) - f32(15.0)) + f32(10.0))

    u = fade(xf)
    v = fade(zf)

    def hash2(ix, iz):
        return perm[perm[ix] + iz]

    def grad(h, dx, dz):
        h = h & 7
        sgn_x = np.where((h & 1) == 0, f32(1.0), f32(-1.0))
        sgn_z = np.where((h & 2) == 0, f32(1.0), f32(-1.0))
        gx = np.where(h < 4, sgn_x, sgn_x * f32(0.70710678))
        gz = np.where(h < 4, sgn_z, sgn_z * f32(0.70710678))
        return gx * dx + gz * dz

    n00 = grad(hash2(xi, zi), xf, zf)
    n10 = grad(hash2(xi + 1, zi), xf - f32(1.0), zf)
    n01 = grad(hash2(xi, zi + 1), xf, zf - f32(1.0))
    n11 = grad(hash2(xi + 1, zi + 1), xf - f32(1.0), zf - f32(1.0))
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return nx0 + v * (nx1 - nx0)


def fbm2(x, z, perm, octaves: int = 4, lacunarity: float = 2.0,
         gain: float = 0.5):
    total = np.zeros(np.broadcast_shapes(x.shape, z.shape), f32)
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for _ in range(octaves):
        total = total + f32(amp) * perlin2(x * f32(freq), z * f32(freq), perm)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / f32(norm)


def _heightmap_from_perm(cfg: WorldConfig, perm, base_height: float = 8.0,
                         amplitude: float = 7.0, frequency: float = 0.04):
    gx = np.arange(cfg.x, dtype=f32)[:, None]
    gz = np.arange(cfg.z, dtype=f32)[None, :]
    h = f32(base_height) + f32(amplitude) * fbm2(gx * f32(frequency),
                                                 gz * f32(frequency), perm)
    return np.clip(np.round(h), 1, cfg.y - 2).astype(np.int32)


def terrain_heightmap(cfg: WorldConfig, seed: int = DEFAULT_SEED):
    return _heightmap_from_perm(cfg, _perm_table(seed))


def generate_tables(cfg: WorldConfig, seed: int = DEFAULT_SEED,
                    shader_ball_row: bool = True, flowers: bool = True,
                    nonsolid_ids: tuple = ()) -> dict:
    """Canonical world as numpy tables (see world/voxel.build_tables_np)."""
    heights = _heightmap_from_perm(cfg, _perm_table(seed))
    y = np.arange(cfg.y, dtype=np.int32)[None, :, None]
    h = heights[:, None, :]
    occupied = y < h
    low = heights <= 7
    surf_id = np.where(low, B.SAND, B.SOIL).astype(np.int32)
    h1 = np.maximum(h - 4, 0)
    h2 = np.maximum(h - 1, 0)
    ids = np.where(y < h1, B.CLIFF, np.where(y < h2, B.ROCKS,
                                             surf_id[:, None, :]))
    blocks = np.where(occupied, ids, B.AIR).astype(np.uint8)
    if shader_ball_row:
        blocks[np.arange(30, 40), 7, 43] = np.arange(
            B.SHADERBALL0, B.SHADERBALL0 + 10, dtype=np.uint8)
    if flowers:
        for fx, fz in FLOWER_SPOTS:
            blocks[fx, heights[fx, fz], fz] = B.FLOWER
    schema = pack_schema(h1[:, 0, :], h2[:, 0, :],
                         np.full((cfg.x, cfg.z), B.CLIFF, np.int32),
                         np.full((cfg.x, cfg.z), B.ROCKS, np.int32),
                         surf_id).reshape(-1)
    return build_tables_np(cfg, blocks, schema, tuple(nonsolid_ids))


def generate_world(cfg: WorldConfig | None = None, seed: int = DEFAULT_SEED,
                   shader_ball_row: bool = True, flowers: bool = True,
                   nonsolid_ids: tuple = (), device="cpu"
                   ) -> tuple[WorldConfig, VoxelWorld]:
    """Build the canonical world: layered terrain + shader-ball test row +
    flower decorations, tables on `device`."""
    cfg = cfg or WorldConfig()
    return cfg, world_from_numpy(
        generate_tables(cfg, seed, shader_ball_row, flowers, nonsolid_ids),
        device)
