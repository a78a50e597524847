"""State carried across from the JAX package.

Each function takes one of the JAX package's state objects (any NamedTuple
whose leaves convert with ``np.asarray`` — this module never imports jax)
and returns the port's counterpart on `device`, bit for bit: packed planes
(ReSTIR reservoirs, texture atlas) keep their 32-bit patterns, and the
TPU's (R, 128) world tables are flattened to (X·Z,).  Tests use it to
start both implementations from identical state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .assets.image_textures import TextureAtlas, with_texels
from .assets.materials import MaterialTable, material_table_from_numpy
from .core.camera import Camera
from .render.denoiser import DenoiserState
from .render.postprocess import PostState
from .render.restir import ReSTIRState
from .render.sky import SkyState, sky_state_from_numpy
from .world.lighting import LightTable, light_table_from_numpy
from .world.voxel import VoxelWorld, WorldConfig


def _np(a) -> np.ndarray:
    return np.array(a)          # a writable host copy


def _t(a, device, dtype=None) -> torch.Tensor:
    arr = np.ascontiguousarray(_np(a))
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)     # u32 bit patterns ride as int32
    t = torch.from_numpy(arr).to(device)
    return t if dtype is None else t.to(dtype)


def world(jw, device="cpu") -> VoxelWorld:
    """VoxelWorld: (R, 128) tables → flat (X·Z,), uint32 → int32 bits."""
    return VoxelWorld(
        blocks=_t(jw.blocks, device),
        schema=_t(_np(jw.schema).reshape(-1), device),
        colmask=_t(_np(jw.colmask).reshape(-1), device),
        exc_mask=_t(_np(jw.exc_mask).reshape(-1), device),
        exc_key=_t(jw.exc_key, device, torch.int32),
        exc_id=_t(jw.exc_id, device, torch.int32),
        df_super=_t(_np(jw.df_super).reshape(-1), device, torch.int32),
        maxh_super=_t(_np(jw.maxh_super).reshape(-1), device, torch.int32))


def materials(jm, device="cpu") -> MaterialTable:
    arrays = {f: _np(getattr(jm, f)) for f in MaterialTable._fields}
    for f in ("texture_id", "image_id", "block_to_mat"):
        arrays[f] = arrays[f].astype(np.int32)
    for f in ("albedo", "roughness", "metallic", "translucency", "emissive",
              "uv_scale"):
        arrays[f] = arrays[f].astype(np.float32)
    return material_table_from_numpy(arrays, device)


def lights(jl, device="cpu") -> LightTable:
    arrays = {f: _np(getattr(jl, f)) for f in LightTable._fields}
    arrays["count"] = np.asarray(arrays["count"], np.int32)
    arrays["ent"] = arrays["ent"].astype(bool)
    arrays["active"] = arrays["active"].astype(bool)
    return light_table_from_numpy(arrays, device)


def sky(js, device="cpu") -> SkyState:
    arrays = {f: getattr(js, f) for f in SkyState._fields if f != "host"}
    arrays["sun_dir"] = np.array([float(v) for v in js.sun_dir], np.float32)
    for f in ("turbidity", "sky_intensity", "sun_intensity",
              "cos_sun_radius"):
        arrays[f] = float(_np(arrays[f]))
    for f in ("env_prob", "env_pmf", "basis_p", "basis_m", "sun_poly"):
        arrays[f] = _np(arrays[f]).astype(np.float32)
    arrays["env_alias"] = _np(arrays["env_alias"]).astype(np.int32)
    return sky_state_from_numpy(arrays, device)


def atlas(ja, device="cpu") -> TextureAtlas:
    out = TextureAtlas(lo=_t(ja.lo, device), hi=_t(ja.hi, device))
    return with_texels(out) if out.lo.device.type == "cuda" else out


def camera(jc, device="cpu") -> Camera:
    return Camera(**{f: torch.tensor(float(_np(getattr(jc, f))),
                                     dtype=torch.float32, device=device)
                     for f in Camera._fields})


def restir_state(jr, device="cpu") -> ReSTIRState:
    data = np.ascontiguousarray(_np(jr.data))
    return ReSTIRState(data=torch.from_numpy(
        data.view(np.int32).copy()).to(device).view(torch.float32))


def denoiser_state(jd, device="cpu") -> DenoiserState:
    return DenoiserState(
        slow=_t(jd.slow, device), fast=_t(jd.fast, device),
        moments=_t(jd.moments, device), hist_len=_t(jd.hist_len, device),
        prev_depth=_t(jd.prev_depth, device),
        prev_normal=_t(jd.prev_normal, device),
        bootstrapped=torch.full((), bool(_np(jd.bootstrapped)),
                                dtype=torch.bool, device=device))


def post_state(jp, device="cpu") -> PostState:
    return PostState(exposure=torch.tensor(float(_np(jp.exposure)),
                                           dtype=torch.float32,
                                           device=device))


def mesh_data(jm) -> "MeshData":
    """A JAX MeshData (host arrays, skeleton, clips) as the port's."""
    from .models.entity import MeshData

    def opt(a, dtype):
        return None if a is None else _np(a).astype(dtype)
    return MeshData(
        positions=_np(jm.positions).astype(np.float32),
        normals=_np(jm.normals).astype(np.float32),
        uvs=_np(jm.uvs).astype(np.float32),
        indices=_np(jm.indices).astype(np.int32),
        joints=opt(jm.joints, np.int32), weights=opt(jm.weights, np.float32),
        skeleton=None if jm.skeleton is None else skeleton(jm.skeleton),
        clips={n: clip(c) for n, c in jm.clips.items()})


def skeleton(js) -> "Skeleton":
    from .models.skeleton import Skeleton
    return Skeleton(list(js.names), _np(js.parents).astype(np.int32),
                    _np(js.bind_t).astype(np.float32),
                    _np(js.bind_r).astype(np.float32),
                    _np(js.bind_s).astype(np.float32),
                    _np(js.inverse_bind).astype(np.float32))


def clip(jc) -> "AnimationClip":
    from .models.animation import AnimationClip
    return AnimationClip(jc.name, _np(jc.t), _np(jc.r), _np(jc.s),
                         float(jc.duration), bool(jc.loop))


def entity(je) -> "Entity":
    """A JAX Entity with its pose (current and previous composed
    matrices) as the port's."""
    from .models.entity import Entity

    def opt(a):
        return None if a is None else _np(a).astype(np.float32)
    return Entity(mesh=mesh_data(je.mesh),
                  material=je.material, image=je.image,
                  position=_np(je.position).astype(np.float32),
                  yaw=float(je.yaw), scale=float(je.scale),
                  entity_id=int(je.entity_id), joint_mats=opt(je.joint_mats),
                  prev_joint_mats=opt(je.prev_joint_mats))


def character(jch) -> "Character":
    """A JAX Character (its physics and locomotion state, its entity) as
    the port's."""
    from .core.config import CharacterMovementSettings
    from .models.character import Character
    ch = Character(
        cfg_world=WorldConfig(**{f.name: getattr(jch.cfg_world, f.name)
                                 for f in dataclasses.fields(WorldConfig)}),
        move=CharacterMovementSettings(**dataclasses.asdict(jch.move)),
        position=_np(jch.position).astype(np.float32),
        velocity=_np(jch.velocity).astype(np.float32),
        yaw=float(jch.yaw), target_yaw=float(jch.target_yaw),
        on_ground=bool(jch.on_ground), anim_time=float(jch.anim_time),
        state=jch.state, blend=float(jch.blend), prev_state=jch.prev_state,
        entity=entity(jch.entity))
    if hasattr(jch, "_placing"):
        ch._placing = bool(jch._placing)
    return ch


def shade_tables(lf, li, envf, envi, k_slots: int, device="cpu"):
    """The JAX package's packed fused-shade tables — (N_LF·R, 128) f32 and
    (N_LI·R, 128) i32 light rows (row `f·R + h` holds slots h·128 ..
    h·128+127 of field f), (2, 128) f32 and (1, 128) i32 env rows — as
    the port's flat (N_LF, K), (N_LI, K), (2, ENV_N), (1, ENV_N)."""
    from .render.ris_kernel import ENV_N

    lf, li = _np(lf).astype(np.float32), _np(li).astype(np.int32)
    R = -(-k_slots // lf.shape[1])

    def rows(a):
        n = a.shape[0] // R
        return np.ascontiguousarray(a.reshape(n, R * a.shape[1])[:, :k_slots])
    return (_t(rows(lf), device), _t(rows(li), device),
            _t(np.ascontiguousarray(_np(envf).astype(np.float32)[:, :ENV_N]),
               device),
            _t(np.ascontiguousarray(_np(envi).astype(np.int32)[:, :ENV_N]),
               device))


def engine_from_jax(jax_engine, engine):
    """Overwrite the port engine's world (with its configuration: a grown
    exception list), tables, trace parameters, lights and their pending
    slot remap, sky, atlas, cameras, feedback states, accumulation, UI
    overlay and entities (with their current and previous poses) with the
    JAX engine's, and rebuild the soup's static rows from the carried
    world (same settings assumed; the internal and output sizes must
    agree)."""
    from .ops.dda import TraceParams, trace_tables
    sizes = [(e.width, e.height, e.out_width, e.out_height)
             for e in (jax_engine, engine)]
    if sizes[0] != sizes[1]:
        raise ValueError(f"engine sizes differ (internal w, h, output w, "
                         f"h): JAX {sizes[0]}, port {sizes[1]}")
    dev = engine.device
    engine.cfg = WorldConfig(**{f.name: getattr(jax_engine.cfg, f.name)
                                for f in dataclasses.fields(WorldConfig)})
    engine._tp = TraceParams(*(int(v) for v in jax_engine._tp))
    engine.world = world(jax_engine.world, dev)
    engine.materials = materials(jax_engine.materials, dev)
    engine.lights = lights(jax_engine.lights, dev)
    engine.sky_state = sky(jax_engine.sky_state, dev)
    if jax_engine.texture_atlas is not None:
        engine.texture_atlas = atlas(jax_engine.texture_atlas, dev)
    engine.camera = camera(jax_engine.camera, dev)
    engine.history_camera = camera(jax_engine.history_camera, dev)
    engine.frame_index = int(jax_engine.frame_index)
    engine.restir_state = (None if jax_engine.restir_state is None
                           else restir_state(jax_engine.restir_state, dev))
    engine.denoiser_state = (None if jax_engine.denoiser_state is None
                             else denoiser_state(jax_engine.denoiser_state,
                                                 dev))
    engine.post_state = post_state(jax_engine.post_state, dev)
    engine._light_remap = _t(jax_engine._light_remap, dev, torch.int32)
    engine._accum = (None if jax_engine._accum is None
                     else _t(jax_engine._accum, dev, torch.float32))
    engine._accum_n = int(jax_engine._accum_n)
    engine._ui_overlay = _t(jax_engine._ui_overlay, dev, torch.uint8)
    engine._tables = trace_tables(engine.world, engine.materials)
    engine.entities = [entity(e) for e in jax_engine.entities]
    engine._decor_np = None          # rebuilt from the carried world
    engine._soup_key = None
    return engine
