"""Engine: owns world + assets + camera and runs the real-time frame
(port of rtvb_tpu/render/renderer.py).

The frame is the JAX package's `_build_run`: path trace → denoise → post →
u8, with the three feedback states (ReSTIR reservoirs, denoiser history,
adapted exposure) held as tensors on the engine's device and rebound every
frame.  `Engine()` runs the shipped `Settings()`: fused shading (the K4
kernel) at native resolution.  `slice_settings()` is the same with the
in-line shading composition (fused_shading False).  Below render_scale 1
(the dynamic-resolution rungs 3/4, 2/3, 1/2) the frame path traces and
denoises at the internal size and post upscales to the output size with
EASU (the K7 kernel).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch.profiler import record_function

from ..assets.blocks import BlockRegistry
from ..core.config import Settings
from ..core.scene import SceneConfig

from ..assets import image_textures
from ..assets.decorations import DecorationMeshes
from ..assets.materials import MaterialRegistry
from ..assets.textures import TEXTURE_IDS
from ..core.camera import make_camera
from ..ops.dda import trace_params, trace_tables
from ..world import gen, lighting
from . import pathtracer, postprocess
from . import restir as restir_mod
from . import sky as sky_mod
from .denoiser import denoise_frame, initial_denoiser_state

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")

# profiler ranges of render_realtime_device, in frame order
STAGES = ("rtvb.pathtrace", "rtvb.denoise", "rtvb.post")


def slice_settings(width: int = 1920, height: int = 1080) -> Settings:
    """The shipped defaults at render_scale 1.0 with the in-line shading
    composition (fused_shading False) in place of the fused kernel."""
    return Settings().replace(rendering={
        "render_width": width, "render_height": height,
        "render_scale": 1.0, "fused_shading": False})


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Engine:
    def __init__(self, settings: Settings | None = None,
                 scene: SceneConfig | None = None,
                 width: int | None = None, height: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        # f32 products and convolutions stay full precision on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.settings = settings or Settings()
        rs = self.settings.rendering
        self.scene = scene or SceneConfig()
        self.out_width = width or rs.render_width
        self.out_height = height or rs.render_height
        # output (display) size against the internal render size: the
        # frame path traces and denoises at output × render_scale and
        # post upscales
        self.render_scale = float(rs.render_scale)
        self.width, self.height = self._internal_size(self.render_scale)

        asset_dir = os.path.join(_DATA, "assets")
        blocks_yaml = os.path.join(asset_dir, "blocks.yaml")
        mats_yaml = os.path.join(asset_dir, "materials.yaml")
        self.block_registry = BlockRegistry.from_yaml(blocks_yaml) \
            if os.path.exists(blocks_yaml) else BlockRegistry.builtin()
        self.material_registry = MaterialRegistry.from_yaml(mats_yaml) \
            if os.path.exists(mats_yaml) else MaterialRegistry()
        self.decor = DecorationMeshes()

        # entity textures named by the model registry always load; the
        # material textures join when authored_textures is on
        wanted = sorted({e.get("image")
                         for e in self.decor.registry.entries.values()
                         if e.get("image")})
        if rs.authored_textures:
            wanted += sorted({mt.image for mt in
                              self.material_registry.materials
                              if mt.image is not None
                              and mt.image not in wanted})
        self.texture_atlas, self.texture_atlas_names = \
            image_textures.load_atlas(os.path.join(_DATA, "textures"),
                                      wanted, device=self.device)
        image_names = ({n: i for i, n in enumerate(self.texture_atlas_names)}
                       if self.texture_atlas is not None else None)
        self.materials = self.material_registry.build_table(
            self.block_registry, TEXTURE_IDS, image_names, device=self.device)

        self.cfg, self.world = gen.generate_world(
            seed=self.scene.world_seed, nonsolid_ids=self._nonsolid_ids(),
            device=self.device)
        self.lights = lighting.build_light_table(
            self.cfg, self.world, self.materials, self.block_registry,
            self.decor, device=self.device)
        self.sky_state = sky_mod.make_sky_state(self.settings.sky,
                                                device=self.device)
        self.camera = self._make_camera(self.scene.camera_pos,
                                        self.scene.camera_yaw,
                                        self.scene.camera_pitch)
        self.history_camera = self.camera

        self.frame_index = 0
        self.post_state = postprocess.initial_post_state(self.device)
        self.denoiser_state = None
        self.restir_state = None
        self._light_remap = torch.arange(self.lights.key.shape[0],
                                         dtype=torch.int32,
                                         device=self.device)
        self._tp = trace_params(self.cfg, rs.max_trace_steps)
        self._tables = trace_tables(self.world, self.materials)
        self._entity_cache = None

    # ------------------------------------------------------------------

    def _make_camera(self, pos, yaw, pitch):
        return make_camera(
            pos=pos, yaw=yaw, pitch=pitch,
            fov_y_degrees=self.settings.camera_movement.fov_y_degrees,
            aspect=self.out_width / self.out_height, device=self.device)

    def _internal_size(self, scale: float) -> tuple[int, int]:
        """Internal render size = output × scale, rounded to even pixels
        and capped at the output size."""
        w = max(8, int(round(self.out_width * scale / 2.0)) * 2)
        h = max(8, int(round(self.out_height * scale / 2.0)) * 2)
        return min(w, self.out_width), min(h, self.out_height)

    def set_render_scale(self, scale: float):
        """Switch the internal render size (a dynamic-resolution rung).  A
        size change resets the per-resolution states (ReSTIR reservoirs,
        denoiser history)."""
        w, h = self._internal_size(scale)
        self.render_scale = scale
        if (w, h) == (self.width, self.height):
            return
        self.width, self.height = w, h
        self.restir_state = None
        self.denoiser_state = None

    def _nonsolid_ids(self):
        return tuple(b.id for b in self.block_registry.blocks if b.instanced)

    @property
    def _n_local(self) -> int:
        return self.settings.rendering.local_light_candidates \
            if self.lights.count > 0 else 0

    def set_camera(self, pos=None, yaw=None, pitch=None, keep_history=False):
        if not keep_history:
            self.history_camera = self.camera
        cam = self.camera
        self.camera = self._make_camera(
            pos if pos is not None else (float(cam.pos_x), float(cam.pos_y),
                                         float(cam.pos_z)),
            yaw if yaw is not None else float(cam.yaw),
            pitch if pitch is not None else float(cam.pitch))

    # ------------------------------------------------------------------
    # decoration triangle soup
    # ------------------------------------------------------------------

    def _decoration_triangles(self):
        blocks = self.world.blocks.cpu().numpy()
        cfg = self.cfg
        v0s, v1s, v2s, mats, slots = [], [], [], [], []
        for b in self.block_registry.blocks:
            if not b.instanced:
                continue
            pos = np.argwhere(blocks == b.id)
            if len(pos) == 0:
                continue
            base_mat = self.material_registry.index_of(
                self.decor.base_material(b.name, b.material))
            light_mat = self.material_registry.index_of(b.material)
            for (x, y, z) in pos:
                v0, v1, v2, is_light = self.decor.decoration_triangles(
                    b.name, np.array([[x, y, z]], np.float32))
                if len(v0) == 0:
                    continue
                v0s.append(v0)
                v1s.append(v1)
                v2s.append(v2)
                mats.append(np.where(is_light, light_mat, base_mat
                                     ).astype(np.int32))
                vkey = (int(x) * cfg.z + int(z)) * cfg.y + int(y)
                sl = np.full(len(v0), -1, np.int32)
                ordinal = 0
                for t in range(len(v0)):
                    if is_light[t]:
                        sl[t] = lighting.light_slot_of(self.lights, vkey,
                                                       ordinal)
                        ordinal += 1
                slots.append(sl)
        if not v0s:
            z = np.zeros((0, 3), np.float32)
            zi = np.zeros(0, np.int32)
            return z, z, z, zi, zi
        return (np.concatenate(v0s), np.concatenate(v1s), np.concatenate(v2s),
                np.concatenate(mats), np.concatenate(slots))

    def entity_buffers(self):
        """EntityBuffers of the decorations (padded to a pow2 ≥ 16), or
        None when the world holds none.  Built once: this slice has no
        edits and no live entities."""
        if self._entity_cache is not None:
            return self._entity_cache[0]
        dv0, dv1, dv2, dmat, dslot = self._decoration_triangles()
        n_tris = len(dv0)
        if n_tris == 0:
            self._entity_cache = (None,)
            return None
        t_max = 16
        while t_max < n_tris:
            t_max *= 2
        pad = t_max - n_tris
        nrm = np.cross(dv1 - dv0, dv2 - dv0)
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-12)
        z3 = np.zeros((pad, 3), np.float32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        buf = pathtracer.EntityBuffers(
            tri_packed=t(np.concatenate(
                [np.concatenate([dv0, dv1 - dv0, dv2 - dv0], axis=-1),
                 np.zeros((pad, 9), np.float32)]).astype(np.float32)),
            normals=t(np.concatenate([nrm.astype(np.float32), z3])),
            prev_v0=t(np.concatenate([dv0, z3])),
            prev_v1=t(np.concatenate([dv1, z3])),
            prev_v2=t(np.concatenate([dv2, z3])),
            mat_index=t(np.concatenate([dmat, np.zeros(pad, np.int32)])),
            light_slot=t(np.concatenate([dslot, np.full(pad, -1, np.int32)])),
            uvs=t(np.zeros((t_max, 6), np.float32)),
            image_id=t(np.full(t_max, -1, np.int32)))
        self._entity_cache = (buf,)
        return buf

    # ------------------------------------------------------------------
    # the frame
    # ------------------------------------------------------------------

    def _ensure_states(self):
        if self.settings.rendering.use_restir and self.restir_state is None:
            self.restir_state = restir_mod.initial_state(
                self.height, self.width, device=self.device)
        if self.denoiser_state is None:
            self.denoiser_state = initial_denoiser_state(
                self.height, self.width, device=self.device)

    def render_gbuffers(self):
        """Path trace one frame from the current states → (GBuffers, new
        ReSTIR state); advances nothing."""
        rs_cfg = dataclasses.replace(self.settings.rendering,
                                     local_light_candidates=self._n_local)
        use_restir = rs_cfg.use_restir
        return pathtracer.render_frame(
            self.cfg, self._tables, self._tp, self.materials, self.lights,
            self.sky_state, self.camera, self.history_camera,
            self.frame_index, self.width, self.height, rs_cfg,
            prev_restir=self.restir_state if use_restir else None,
            light_remap=self._light_remap, entities=self.entity_buffers(),
            atlas=self.texture_atlas, half_res_gi=rs_cfg.half_res_gi)

    def render_realtime_device(self, dt: float = 1.0 / 60.0) -> torch.Tensor:
        """One interactive frame: 1 spp + denoiser + post.  Returns the
        (out_h, out_w, 3) u8 frame on the engine's device.  The stages are
        profiler ranges (STAGES); outside a profiler they cost a few µs."""
        self._ensure_states()
        with record_function("rtvb.pathtrace"):
            g, new_restir = self.render_gbuffers()
        with record_function("rtvb.denoise"):
            rgb, self.denoiser_state = denoise_frame(g, self.denoiser_state,
                                                     self.settings.denoising)
        with record_function("rtvb.post"):
            out, self.post_state = postprocess.run(
                rgb, self.post_state, self.settings.post_processing,
                self.settings.tone_mapping, dt, self.out_height,
                self.out_width)
            out_u8 = (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        if new_restir is not None:
            self.restir_state = new_restir
        self.frame_index += 1
        self.history_camera = self.camera
        return out_u8

    def render_realtime(self, dt: float = 1.0 / 60.0) -> np.ndarray:
        """Like render_realtime_device, fetched to a host numpy array."""
        return self.render_realtime_device(dt).cpu().numpy()
