"""Dynamic light system: emissive geometry → sampleable triangle-light table
(port of rtvb_tpu/world/lighting.py; the table build is host numpy, the
per-pixel sampling helpers are torch).

The build reads its inputs as host arrays (`build_light_arrays`), so an
engine that keeps host copies of its world and materials rebuilds the
table without reading the device, and writes the arrays into the
existing table in place while K stands."""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..assets.blocks import BlockRegistry

from ..ops import alias_table as at
from .voxel import EXC_EMPTY, WorldConfig

MAX_LIGHT_TRIS = 256
LIGHT_KEY_EMPTY = 1 << 30


class LightTable(NamedTuple):
    """Fixed-size (K triangle slots) light table; inactive slots weight 0."""
    v0x: torch.Tensor
    v0y: torch.Tensor
    v0z: torch.Tensor
    e1x: torch.Tensor
    e1y: torch.Tensor
    e1z: torch.Tensor
    e2x: torch.Tensor
    e2y: torch.Tensor
    e2z: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    area: torch.Tensor
    rad_r: torch.Tensor
    rad_g: torch.Tensor
    rad_b: torch.Tensor
    key: torch.Tensor      # (K,) i32 identity voxel_key*16 + ordinal
    ent: torch.Tensor      # (K,) bool
    active: torch.Tensor   # (K,) bool
    count: torch.Tensor    # () int32 number of active light triangles
    prob: torch.Tensor
    alias: torch.Tensor
    pmf: torch.Tensor


def _cube_triangles():
    tris = []
    faces = [
        ((0, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((0, 0, 0), (1, 0, 0), (0, 0, 1)),
        ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
        ((0, 0, 0), (0, 1, 0), (1, 0, 0)),
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
    ]
    for o, eu, ev in faces:
        o = np.array(o, np.float32)
        eu = np.array(eu, np.float32)
        ev = np.array(ev, np.float32)
        tris.append((o, eu, ev))
        tris.append((o + eu + ev, -eu, -ev))
    return tris


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def emissive_triangles(cfg: WorldConfig, world, mats, blocks: BlockRegistry,
                       decor):
    """Host scan of the exception list → (voxel_key, ordinal, v0, e1, e2,
    radiance, is_entity) for every emissive triangle.  `world` has
    exc_key / exc_id and `mats` block_to_mat / emissive, as tensors or
    host arrays; `decor` is an assets.decorations.DecorationMeshes."""
    exc_key = _host(world.exc_key)
    exc_id = _host(world.exc_id)
    emissive_ids = set(blocks.emissive_ids)
    b2m = _host(mats.block_to_mat)
    emis = _host(mats.emissive)
    out = []
    for i in range(exc_key.shape[0]):
        if exc_key[i] >= EXC_EMPTY or int(exc_id[i]) not in emissive_ids:
            continue
        bid = int(exc_id[i])
        c, y = divmod(int(exc_key[i]), cfg.y)
        x, z = divmod(c, cfg.z)
        pos = np.array([x, y, z], np.float32)
        e = emis[b2m[bid]]
        bdef = blocks[bid]
        light = decor.light_mesh(bdef.name) if bdef.instanced else None
        if light is not None:
            lv0, lv1, lv2 = light
            for t in range(len(lv0)):
                out.append((int(exc_key[i]), t, lv0[t] + pos,
                            lv1[t] - lv0[t], lv2[t] - lv0[t], e, True))
        else:
            for t, (o, eu, ev) in enumerate(_cube_triangles()):
                out.append((int(exc_key[i]), t, o + pos, eu, ev, e, False))
    return out


def light_table_from_numpy(arrays: dict, device="cpu") -> LightTable:
    # np.array copies (count stays 0-d: ascontiguousarray would make it 1-d)
    return LightTable(**{
        f: torch.from_numpy(np.array(arrays[f], np.int32) if f == "count"
                            else np.ascontiguousarray(arrays[f])).to(device)
        for f in LightTable._fields})


def build_light_arrays(cfg: WorldConfig, world, mats, blocks: BlockRegistry,
                       decor, k: int | None = None) -> dict:
    """The light table as host arrays (LightTable's fields; `count` a 0-d
    int32 array): the emissive triangles and their sampling alias table;
    K is the next power of two ≥ the triangle count (min 8)."""
    tris = emissive_triangles(cfg, world, mats, blocks, decor)
    if k is None:
        k = 8
        while k < len(tris):
            k *= 2
        k = min(k, MAX_LIGHT_TRIS)
    if len(tris) > k:
        warnings.warn(f"light-triangle overflow: {len(tris)} > {k}; "
                      f"extra lights are dropped")
        tris = tris[:k]
    v0 = np.zeros((k, 3), np.float32)
    e1 = np.zeros((k, 3), np.float32)
    e2 = np.zeros((k, 3), np.float32)
    nrm = np.zeros((k, 3), np.float32)
    area = np.zeros(k, np.float32)
    rad = np.zeros((k, 3), np.float32)
    key = np.full(k, LIGHT_KEY_EMPTY, np.int32)
    ent = np.zeros(k, bool)
    active = np.zeros(k, bool)
    weights = np.zeros(k, np.float64)
    for s, (vk, t, a, b, c, e, is_ent) in enumerate(tris):
        ent[s] = is_ent
        v0[s] = a
        e1[s] = b
        e2[s] = c
        cr = np.cross(b, c)
        ln = np.linalg.norm(cr)
        nrm[s] = cr / max(ln, 1e-12)
        area[s] = 0.5 * ln
        rad[s] = e
        key[s] = vk * 16 + t
        active[s] = True
        lum = 0.2126 * e[0] + 0.7152 * e[1] + 0.0722 * e[2]
        weights[s] = lum * area[s]
    table = at.build(weights)
    arrays = dict(
        v0x=v0[:, 0], v0y=v0[:, 1], v0z=v0[:, 2],
        e1x=e1[:, 0], e1y=e1[:, 1], e1z=e1[:, 2],
        e2x=e2[:, 0], e2y=e2[:, 1], e2z=e2[:, 2],
        nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2], area=area,
        rad_r=rad[:, 0], rad_g=rad[:, 1], rad_b=rad[:, 2],
        key=key, ent=ent, active=active,
        count=np.asarray(active.sum(), np.int32),
        prob=table.prob, alias=table.alias, pmf=table.pmf)
    return {f: a if f == "count" else np.ascontiguousarray(a)
            for f, a in arrays.items()}


def build_light_table(cfg: WorldConfig, world, mats, blocks: BlockRegistry,
                      decor, k: int | None = None,
                      device="cpu") -> LightTable:
    """build_light_arrays on `device`."""
    return light_table_from_numpy(
        build_light_arrays(cfg, world, mats, blocks, decor, k), device)


def light_slot_of(keys: np.ndarray, voxel_key: int, ordinal: int) -> int:
    """The slot of light (voxel_key, ordinal) in a table's host keys, or
    -1."""
    hits = np.nonzero(keys == voxel_key * 16 + ordinal)[0]
    return int(hits[0]) if len(hits) else -1


def light_id_remap_np(prev_key: np.ndarray, cur_key: np.ndarray
                      ) -> np.ndarray:
    """(K_prev,) int32: previous light slot → current slot (-1 where the
    light is gone), matched by identity key; feeds the ReSTIR
    reservoirs' slot remap across an edit."""
    cur_pos = {int(kk): i for i, kk in enumerate(cur_key)
               if kk < LIGHT_KEY_EMPTY}
    remap = np.full(prev_key.shape[0], -1, np.int32)
    for i, kk in enumerate(prev_key):
        if kk < LIGHT_KEY_EMPTY and int(kk) in cur_pos:
            remap[i] = cur_pos[int(kk)]
    return remap


# ---------------------------------------------------------------------------
# Per-pixel sampling (used inside the path tracer)
# ---------------------------------------------------------------------------

def fold_barycentric(u, v):
    flip = (u + v) > 1.0
    return torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)


def sample_light_point(lt: LightTable, slot, u1, u2, u3):
    """Uniform point on light triangle `slot`: (pos, normal, pdf_area,
    (fa, fb))."""
    g = lambda t: at.take(t, slot)
    fa, fb = fold_barycentric(u2, u3)
    pos = (g(lt.v0x) + fa * g(lt.e1x) + fb * g(lt.e2x),
           g(lt.v0y) + fa * g(lt.e1y) + fb * g(lt.e2y),
           g(lt.v0z) + fa * g(lt.e1z) + fb * g(lt.e2z))
    pdf_area = 1.0 / torch.clamp(g(lt.area), min=1e-8)
    return pos, (g(lt.nx), g(lt.ny), g(lt.nz)), pdf_area, (fa, fb)


def reconstruct_light_point(lt: LightTable, slot, fa, fb):
    g = lambda t: at.take(t, slot)
    return (g(lt.v0x) + fa * g(lt.e1x) + fb * g(lt.e2x),
            g(lt.v0y) + fa * g(lt.e1y) + fb * g(lt.e2y),
            g(lt.v0z) + fa * g(lt.e1z) + fb * g(lt.e2z))


def light_radiance(lt: LightTable, slot):
    return (at.take(lt.rad_r, slot), at.take(lt.rad_g, slot),
            at.take(lt.rad_b, slot))
