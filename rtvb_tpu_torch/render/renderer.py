"""Engine: owns world + assets + camera, runs the real-time frame and
takes the interactive app's calls (port of rtvb_tpu/render/renderer.py).

The frame is the JAX package's `_build_run`: path trace → denoise → post →
u8, a function of explicit arguments (`_build_run`).  Its per-frame inputs
(frame index, dt, camera, history camera, light remap) sit in one fixed
device buffer written from host copies before each frame
(`frame_graph.FrameInputs`), and the three feedback states (ReSTIR
reservoirs, denoiser history, adapted exposure) are fixed buffers written
in place at the end of each frame.  On a CUDA device
`render_realtime_device` replays a captured CUDA graph of the frame and
`render_realtime_device_batch(nb)` one of nb frames (the JAX package's
jitted `_frame_fn` and `lax.scan` `_frame_batch_fn`); the first frame of
a graph runs eagerly and captures it, and a graph whose tensors were
replaced (an edit, a sky, settings) is released and captured anew.
`_eager_frame` runs the captured function eagerly, for code that must see
the frame's own calls; on the CPU every frame runs so.  Each frame and
edit records its host phases as spans of `utils.perf.TRACER`, and on a
CUDA device the frame body five device stamps, which a graph replays.
`Engine()` runs the shipped `Settings()`: fused shading (the K4 kernel)
at native resolution.  `slice_settings()` is the same with the in-line
shading composition (fused_shading False).  Below render_scale 1 (the
dynamic-resolution rungs 3/4, 2/3, 1/2) the frame path traces and
denoises at the internal size and post upscales to the output size with
EASU (the K7 kernel).

The gameplay calls: world edits (`set_block`, `set_blocks`,
`delete_block`: the tables rebuilt on the host from the engine's host
copy of the world, then written into the device tables in place while
their shapes stand, a light-slot remap consumed by the next frame),
`pick_block` (one camera-centre ray through K1), `add_entity` (a live
entity: its triangles join the soup, packed from its pose before each
frame), `apply_settings` / `set_sky` / `set_ui_overlay`, the offline
accumulation (`path_trace`, `render_accumulated`, `reset_accumulation`)
and `warm_light_variant_async`.  A captured graph stays valid across
edits, a moving entity and a new overlay; the engine captures anew
where the JAX package compiles anew: the exception list grew, the light
table's K slots or the soup's rows changed, the local-light count
changed (no light ↔ some), or the settings, the sky or the render size
changed.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import traceback
import types
import warnings

import numpy as np
import torch

from ..assets.blocks import BlockRegistry
from ..core.config import Settings
from ..core.scene import SceneConfig

from ..assets import image_textures
from ..assets.decorations import DecorationMeshes
from ..assets.materials import MaterialRegistry
from ..assets.textures import TEXTURE_IDS
from ..core.camera import Camera, camera_leaves
from ..ops.dda import TraceTables, trace, trace_params, trace_tables
from ..utils.perf import TRACER, Stamps
from ..world import gen, lighting, voxel
from . import frame_graph, pathtracer, postprocess
from . import restir as restir_mod
from . import sky as sky_mod
from . import soup as soup_mod
from .denoiser import DenoiserState, denoise_frame, initial_denoiser_state
from .postprocess import PostState

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")

# the frame's stage spans (TRACER), as profiler ranges, in frame order
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

        # the world's and the light table's host copies: edits rebuild on
        # the host from these and read nothing back from the device
        self.cfg = voxel.WorldConfig()
        tables = gen.generate_tables(self.cfg, seed=self.scene.world_seed,
                                     nonsolid_ids=self._nonsolid_ids())
        self.world = voxel.world_from_numpy(tables, self.device)
        self._world_np = (self.world, tables)
        self.world_version = 0
        self._mats_np = None
        light_arrays = lighting.build_light_arrays(
            self.cfg, types.SimpleNamespace(**tables), self._host_mats(),
            self.block_registry, self.decor)
        self.lights = lighting.light_table_from_numpy(light_arrays,
                                                      self.device)
        self._lights_np = (self.lights, light_arrays)
        self.sky_state = sky_mod.make_sky_state(self.settings.sky,
                                                device=self.device)
        # the cameras' leaves on the host; the device copies are views of
        # the fixed input buffer, written before each frame
        self._cam_host = self._camera_leaves(self.scene.camera_pos,
                                             self.scene.camera_yaw,
                                             self.scene.camera_pitch)
        self._hist_host = self._cam_host.copy()

        self.frame_index = 0
        self.post_state = postprocess.initial_post_state(self.device)
        # UI overlay (out_h, out_w, 4) u8 RGBA; zeros = invisible
        self._ui_overlay = torch.zeros(
            (self.out_height, self.out_width, 4), dtype=torch.uint8,
            device=self.device)
        self.denoiser_state = None
        self.restir_state = None
        self._identity_remaps: dict[int, torch.Tensor] = {}
        self._light_remap = self._identity_remap()
        self._remap_host = (self._light_remap, None)
        self._accum = None
        self._accum_n = 0
        self._tp = trace_params(self.cfg, rs.max_trace_steps)
        self._tables = trace_tables(self.world, self.materials)
        # the triangle soup: decorations and live entities
        self.entities: list = []
        self.max_entity_tris = 256
        self._decor_np = None          # host decoration rows (None: stale)
        self._decor_epoch = 0
        self._soup = None              # soup.Soup, or None: no triangles
        self._soup_key = None          # what its static rows were made of
        self._entity_static_cache: dict = {}
        self._poses = None             # (layout, HostStaged pose matrices)
        self.last_edit: dict = {}
        self._post_consts = None
        self._inputs = None
        self._dt = 1.0 / 60.0
        self._staged = False
        # captured frame graphs by the JAX package's key, each valid for
        # the identity of the tensors it read; capture times, oldest first
        self._graphs: dict = {}
        self._graph_identity = None
        self.graph_log: list = []
        # the device stamps of frames run eagerly (a graph owns its own)
        self._stamps = Stamps(self.device) \
            if self.device.type == "cuda" else None

    def __copy__(self):
        """A shallow copy with its own input buffer, feedback states,
        graphs, world and light tables, soup and overlay (an edit writes
        those in place, a frame the soup's entity rows); the assets, the
        host copies (replaced, never written, by an edit) and the entities
        themselves stay shared."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._inputs = None
        new._staged = False
        new._graphs = {}
        new._graph_identity = None
        new.graph_log = []
        new._stamps = None if self._stamps is None else Stamps(self.device)
        new.world = voxel.VoxelWorld(*(t.clone() for t in self.world))
        new._world_np = (new.world, self._host_tables())
        new._tables = trace_tables(new.world, self.materials)
        new.lights = lighting.LightTable(*(t.clone() for t in self.lights))
        new._lights_np = (new.lights, self._host_lights())
        new.entities = list(self.entities)
        new._soup = None if self._soup is None else self._soup.clone()
        new._poses = None
        new._ui_overlay = self._ui_overlay.clone()
        new._hist_host = self._hist_host.copy()
        new._cam_host = self._cam_host.copy()
        if self.restir_state is not None:
            new.restir_state = restir_mod.ReSTIRState(
                data=self.restir_state.data.clone())
        if self.denoiser_state is not None:
            new.denoiser_state = DenoiserState(
                *(t.clone() for t in self.denoiser_state))
        new.post_state = PostState(exposure=self.post_state.exposure.clone())
        return new

    # ------------------------------------------------------------------
    # the cameras: host leaves, device views written before each frame
    # ------------------------------------------------------------------

    def _camera_leaves(self, pos, yaw, pitch) -> np.ndarray:
        return camera_leaves(
            pos=pos, yaw=yaw, pitch=pitch,
            fov_y_degrees=self.settings.camera_movement.fov_y_degrees,
            aspect=self.out_width / self.out_height)

    @property
    def camera(self) -> Camera:
        """The camera: 0-d views of the fixed input buffer (they change in
        place when the camera moves; clone to keep a value)."""
        return self._staged_inputs().camera

    @camera.setter
    def camera(self, cam: Camera):
        self._cam_host = np.array([float(v) for v in cam], np.float32)
        self._staged = False

    @property
    def history_camera(self) -> Camera:
        """The camera the previous frame saw (views, as `camera`)."""
        return self._staged_inputs().history_camera

    @history_camera.setter
    def history_camera(self, cam: Camera):
        self._hist_host = np.array([float(v) for v in cam], np.float32)
        self._staged = False

    def camera_pose(self):
        """((x, y, z), yaw, pitch) of the camera, from the host copy."""
        c = self._cam_host
        return (float(c[0]), float(c[1]), float(c[2])), float(c[3]), \
            float(c[4])

    # ------------------------------------------------------------------
    # the per-frame input buffer
    # ------------------------------------------------------------------

    def _remap_words(self) -> int:
        """Slots of the input buffer's remap: every slot a stored
        reservoir of this table or the previous one can name."""
        return max(lighting.MAX_LIGHT_TRIS, self.lights.key.shape[0],
                   self._light_remap.shape[0])

    def _remap_np(self):
        """The pending light remap on the host (None: the identity)."""
        r = self._light_remap
        if r is self._identity_remap():
            return None
        if self._remap_host[0] is not r:
            self._remap_host = (r, r.cpu().numpy())
        return self._remap_host[1]

    def _stage(self, dt: float | None = None) -> frame_graph.FrameInputs:
        """Write the frame index, dt, the cameras and the remap into the
        fixed input buffer (on the current stream)."""
        if dt is not None:
            self._dt = float(dt)
        n = self._remap_words()
        if self._inputs is None or self._inputs.n_remap != n:
            self._inputs = frame_graph.FrameInputs(self.device, n)
        self._inputs.write(self.frame_index, self._dt, self._cam_host,
                           self._hist_host, self._remap_np())
        self._staged = True
        return self._inputs

    def _staged_inputs(self) -> frame_graph.FrameInputs:
        return self._inputs if self._staged else self._stage()

    def _internal_size(self, scale: float) -> tuple[int, int]:
        """Internal render size = output × scale, rounded to even pixels
        and capped at the output size."""
        w = max(8, int(round(self.out_width * scale / 2.0)) * 2)
        h = max(8, int(round(self.out_height * scale / 2.0)) * 2)
        return min(w, self.out_width), min(h, self.out_height)

    def set_render_scale(self, scale: float):
        """Switch the internal render size (a dynamic-resolution rung).  A
        size change resets the per-resolution states (ReSTIR reservoirs,
        denoiser history, accumulation); the same size returns early."""
        w, h = self._internal_size(scale)
        self.render_scale = scale
        if (w, h) == (self.width, self.height):
            return
        self.width, self.height = w, h
        self.restir_state = None
        self.denoiser_state = None
        self._accum = None
        self._accum_n = 0

    def apply_settings(self, settings: Settings) -> None:
        """Live settings swap (the dev panel's edit path).  Temporal state
        resets where its estimator changed: ReSTIR on a rendering edit,
        the denoiser history on a denoising edit; a sky edit goes through
        set_sky; an output-size edit re-derives the internal size.  As in
        the JAX package, the trace parameters (max_trace_steps) are not
        rebuilt."""
        old = self.settings
        if settings == old:
            return
        self.settings = settings
        self.release_graphs()
        if settings.sky != old.sky:
            self.set_sky(**{f.name: getattr(settings.sky, f.name)
                            for f in dataclasses.fields(settings.sky)
                            if getattr(settings.sky, f.name)
                            != getattr(old.sky, f.name)})
        if settings.rendering != old.rendering:
            self.restir_state = None
        if settings.denoising != old.denoising:
            self.denoiser_state = None
        if (settings.rendering.render_width != old.rendering.render_width
                or settings.rendering.render_height
                != old.rendering.render_height):
            self.out_width = settings.rendering.render_width
            self.out_height = settings.rendering.render_height
            self.set_render_scale(self.render_scale)

    def set_sky(self, **sky_updates) -> None:
        """Change sky parameters (time_of_day, turbidity, model, ...) and
        rebuild the sky state.  Also resets the ReSTIR reservoirs: they
        cache their sample's radiance, which a sun change makes stale."""
        self.settings = self.settings.replace(sky=sky_updates)
        self.sky_state = sky_mod.make_sky_state(self.settings.sky,
                                                device=self.device)
        if self.restir_state is not None:
            self.restir_state.data.copy_(restir_mod.initial_state(
                self.height, self.width, device=self.device).data)

    def set_ui_overlay(self, rgba_u8) -> None:
        """Upload a host-rastered (out_h, out_w, 4) u8 RGBA overlay that
        every frame composites over its output; None clears it.  Written
        into the overlay buffer in place while its size stands (as the
        JAX package passes a new array of the same shape without
        compiling anew)."""
        if rgba_u8 is None:
            rgba_u8 = np.zeros((self.out_height, self.out_width, 4),
                               np.uint8)
        shape = (self.out_height, self.out_width, 4)
        if tuple(rgba_u8.shape) != shape:
            raise ValueError(f"overlay shape {tuple(rgba_u8.shape)}, "
                             f"expected {shape}")
        arr = np.asarray(rgba_u8, np.uint8)
        if tuple(self._ui_overlay.shape) == shape:
            frame_graph.copy_in(self._ui_overlay, arr)
        else:
            self._ui_overlay = torch.as_tensor(arr, device=self.device)

    def _nonsolid_ids(self):
        return tuple(b.id for b in self.block_registry.blocks if b.instanced)

    @property
    def _n_local(self) -> int:
        """Local-light RIS candidates the frame streams: 0 without a light
        (read from the host copy of the light table)."""
        return self.settings.rendering.local_light_candidates \
            if int(self._host_lights()["count"]) > 0 else 0

    def set_camera(self, pos=None, yaw=None, pitch=None, keep_history=False):
        """Move the camera (None keeps a value; read from the host copy,
        never from the device); the history camera takes the old pose
        unless keep_history."""
        if not keep_history:
            self._hist_host = self._cam_host.copy()
        old_pos, old_yaw, old_pitch = self.camera_pose()
        self._cam_host = self._camera_leaves(
            pos if pos is not None else old_pos,
            yaw if yaw is not None else old_yaw,
            pitch if pitch is not None else old_pitch)
        self._staged = False

    # ------------------------------------------------------------------
    # world edits and the pick
    # ------------------------------------------------------------------

    def set_block(self, x: int, y: int, z: int, block_id: int):
        """Place (or, with id 0, remove) one block; returns the light-slot
        remap (previous slot → current, -1 where gone)."""
        return self.set_blocks([[x, y, z]], [block_id])

    def set_blocks(self, xyz, ids):
        """Bulk edit: N placements / removals, one table + light rebuild
        on the host (span `edit.rebuild`, whose ms `last_edit["host_ms"]`
        holds), the upload (`edit.upload`, counting the bytes) and the
        soup's static rows (`edit.soup`, the same)."""
        with TRACER.span("edit.rebuild") as rebuild:
            blocks = self._host_tables()["blocks"].copy()
            xyz = np.asarray(xyz, np.int64).reshape(-1, 3)
            blocks[xyz[:, 0], xyz[:, 1], xyz[:, 2]] = np.asarray(ids,
                                                                 np.uint8)
            tables, light_arrays, remap = self._rebuild(blocks)
        with TRACER.span("edit.upload"):
            remap_t = self._upload_edit(tables, light_arrays, remap)
        with TRACER.span("edit.soup"):
            self._soup_static()
        self.last_edit = dict(host_ms=rebuild.ms)
        return remap_t

    def delete_block(self, x: int, y: int, z: int):
        return self.set_block(x, y, z, 0)

    def _identity_remap(self) -> torch.Tensor:
        """The identity light remap for the table's size, cached."""
        n = self.lights.key.shape[0]
        r = self._identity_remaps.get(n)
        if r is None:
            r = torch.arange(n, dtype=torch.int32, device=self.device)
            self._identity_remaps[n] = r
        return r

    # host copies of the device tables (read back only when a table was
    # replaced from outside, as interop.engine_from_jax does)

    def _host_tables(self) -> dict:
        """The world's tables on the host (build_tables_np's layout)."""
        if self._world_np[0] is not self.world:
            self._world_np = (self.world, voxel.world_to_numpy(self.world))
            self.world_version += 1
        return self._world_np[1]

    def _host_lights(self) -> dict:
        """The light table's fields on the host."""
        if self._lights_np[0] is not self.lights:
            self._lights_np = (self.lights, {
                f: t.cpu().numpy()
                for f, t in zip(lighting.LightTable._fields, self.lights)})
        return self._lights_np[1]

    def _host_mats(self):
        """The material table's block map and emissive colours on the
        host (what the light table's build reads)."""
        if self._mats_np is None or self._mats_np[0] is not self.materials:
            self._mats_np = (self.materials, types.SimpleNamespace(
                block_to_mat=self.materials.block_to_mat.cpu().numpy(),
                emissive=self.materials.emissive.cpu().numpy()))
        return self._mats_np[1]

    @property
    def host_world(self) -> voxel.HostWorld:
        """The block grid on the host and the world version (bumped on
        every edit): what a Character collides against."""
        return voxel.HostWorld(blocks=self._host_tables()["blocks"],
                               version=self.world_version)

    def _rebuild(self, blocks: np.ndarray):
        """Rebuild the world's tables, the light table, the slot remap and
        the decoration rows on the host from the edited grid (growing the
        exception list to the next power of two if the edit overflowed
        it) → (tables, light arrays, remap)."""
        host = self._host_tables()
        nonsolid = self._nonsolid_ids()
        tables = voxel.build_tables_np(self.cfg, blocks, host["schema"],
                                       nonsolid)
        n_exc = voxel.exception_count_np(self.cfg, tables)
        if n_exc > self.cfg.max_exceptions:
            cap = self.cfg.max_exceptions
            while cap < n_exc:
                cap *= 2
            self.cfg = dataclasses.replace(self.cfg, max_exceptions=cap)
            tables = voxel.build_tables_np(self.cfg, blocks, host["schema"],
                                           nonsolid)
        prev_key = self._host_lights()["key"]
        light_arrays = lighting.build_light_arrays(
            self.cfg, types.SimpleNamespace(**tables), self._host_mats(),
            self.block_registry, self.decor)
        remap = lighting.light_id_remap_np(prev_key, light_arrays["key"])
        self._world_np = (self.world, tables)
        self._lights_np = (self.lights, light_arrays)
        self.world_version += 1
        self._decor_np = None
        self._decoration_triangles()
        return tables, light_arrays, remap

    def _upload_edit(self, tables: dict, light_arrays: dict,
                     remap: np.ndarray) -> torch.Tensor:
        """Write the rebuilt tables into the device tables in place where
        the shapes stand — after every frame queued so far, before the
        next — or replace the tables that changed shape (their bytes
        counted, as `frame_graph.copy_in` counts the rest), and upload the
        remap the next frame consumes → the remap on the device."""
        if not frame_graph.write_fields(self.world, tables):
            self.world = voxel.world_from_numpy(tables, self.device)
            self._world_np = (self.world, tables)
            self._tables = trace_tables(self.world, self.materials)
            TRACER.count("bytes", sum(t.nbytes for t in self.world))
        if not frame_graph.write_fields(self.lights, light_arrays):
            self.lights = lighting.light_table_from_numpy(light_arrays,
                                                          self.device)
            self._lights_np = (self.lights, light_arrays)
            TRACER.count("bytes", sum(t.nbytes for t in self.lights))
        remap_t = frame_graph.upload(remap, self.device)
        self._light_remap = remap_t     # consumed by the next frame
        self._remap_host = (remap_t, remap)
        self._staged = False
        self._tp = trace_params(self.cfg, self._tp.max_steps)
        return remap_t

    def pick_block(self, max_dist: float = 8.0):
        """Camera-centre voxel pick: one ray through the trace (K1 on the
        card), capped at max_dist.  Returns (hit, (x, y, z), (nx, ny,
        nz)); span `edit.pick`, the read to the host included."""
        with TRACER.span("edit.pick"):
            cam = self.camera
            half = torch.tensor(0.5, dtype=torch.float32, device=self.device)
            d = cam.uv_to_dir(half, half)
            o = tuple(v.reshape(1) for v in cam.pos)
            d = tuple(v.reshape(1) for v in d)
            rec = trace(o, d, self._tables, self._tp,
                        t_cap=torch.full((1,), max_dist, dtype=torch.float32,
                                         device=self.device))
            vals = torch.stack([rec.hit.to(torch.float32), *(
                c.to(torch.float32) for c in (rec.ix, rec.iy, rec.iz, rec.nx,
                                              rec.ny, rec.nz))]).cpu()
        hit, ix, iy, iz, nx, ny, nz = vals[:, 0].tolist()
        return (bool(hit), (int(ix), int(iy), int(iz)),
                (float(nx), float(ny), float(nz)))

    # ------------------------------------------------------------------
    # the triangle soup: decorations and live entities
    # ------------------------------------------------------------------

    def add_entity(self, entity):
        self.entities.append(entity)

    def _decoration_triangles(self):
        """The decoration rows on the host (v0, v1, v2, material, light
        slot), from the host grid and light keys; rebuilt after an edit."""
        if self._decor_np is not None:
            return self._decor_np
        blocks = self._host_tables()["blocks"]
        keys = self._host_lights()["key"]
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
                        sl[t] = lighting.light_slot_of(keys, vkey, ordinal)
                        ordinal += 1
                slots.append(sl)
        if v0s:
            self._decor_np = (np.concatenate(v0s), np.concatenate(v1s),
                              np.concatenate(v2s), np.concatenate(mats),
                              np.concatenate(slots))
        else:
            z = np.zeros((0, 3), np.float32)
            zi = np.zeros(0, np.int32)
            self._decor_np = (z, z, z, zi, zi)
        self._decor_epoch += 1
        return self._decor_np

    def _entity_static(self, e) -> soup_mod.EntityStatic:
        """An entity's mesh on the device, uploaded once (cached by the
        entity's id, held with its mesh so that a reused id misses)."""
        hit = self._entity_static_cache.get(id(e))
        if hit is None or hit[0] is not e.mesh:
            hit = (e.mesh, soup_mod.entity_static(e.mesh, self.device))
            self._entity_static_cache[id(e)] = hit
        return hit[1]

    def _soup_static(self):
        """The soup with its static rows current, or None without
        triangles: a new soup when the row count changes, else the
        decoration rows and every row's metadata written in place when
        the decorations or the entity set changed (the JAX package's
        metadata cache key: decoration epoch, entity ids, rows)."""
        dv0 = self._decoration_triangles()[0]
        n_tris = len(dv0) + sum(e.mesh.n_triangles for e in self.entities)
        if n_tris == 0:
            self._soup = None
            self._soup_key = None
            return None
        assert n_tris <= self.max_entity_tris, \
            f"entity triangle budget exceeded: {n_tris}"
        t_max = soup_mod.soup_rows(n_tris)
        key = (self._decor_epoch, tuple(id(e) for e in self.entities), t_max)
        if self._soup is None or self._soup.t_max != t_max:
            self._soup = soup_mod.Soup(t_max, self.device)
            self._soup_key = None
        if self._soup_key != key:
            img_slots = {n: i for i, n in enumerate(self.texture_atlas_names)}
            ents = []
            for e in self.entities:
                m = e.mesh
                idx = m.indices
                uv = (np.concatenate([m.uvs[idx[:, 0]], m.uvs[idx[:, 1]],
                                      m.uvs[idx[:, 2]]], axis=-1)
                      if m.uvs is not None
                      else np.zeros((m.n_triangles, 6), np.float32))
                ents.append((m.n_triangles,
                             self.material_registry.index_of(e.material),
                             uv, img_slots.get(e.image, -1)))
            self._soup.write_static(soup_mod.static_arrays(
                t_max, self._decoration_triangles(), ents))
            self._soup_key = key
        return self._soup

    def _pack_entities(self):
        """Write every entity's rows of the soup from its current and
        previous pose (composed model ∘ skinning matrices; the model
        matrix alone before its first pose): the matrices cross to the
        device in one copy through pinned memory, then the pack runs on
        the current stream."""
        mats = []
        for e in self.entities:
            cm = e.joint_mats if e.joint_mats is not None \
                else e.model_matrix_np()[None]
            pm = e.prev_joint_mats if e.prev_joint_mats is not None else cm
            mats.append((cm, pm))
        layout = tuple(cm.shape[0] for cm, _ in mats)
        if self._poses is None or self._poses[0] != layout:
            self._poses = (layout, frame_graph.HostStaged(
                self.device, 2 * 16 * sum(layout), torch.float32))
        staged = self._poses[1]
        host = staged.host()
        off = 0
        for cm, pm in mats:
            for m in (cm, pm):
                host[off:off + m.size] = np.asarray(m, np.float32).reshape(-1)
                off += m.size
        staged.commit()
        off = 0
        row = len(self._decoration_triangles()[0])
        for e, (cm, _) in zip(self.entities, mats):
            n = cm.size
            cur = staged.buf[off:off + n].view(-1, 4, 4)
            prev = staged.buf[off + n:off + 2 * n].view(-1, 4, 4)
            self._soup.pack_entity(row, self._entity_static(e), cur, prev)
            off += 2 * n
            row += e.mesh.n_triangles

    def entity_buffers(self):
        """The soup's EntityBuffers for the current poses, or None when the
        scene has no triangles: decorations first, then each entity's
        triangles, zero rows up to a power of two ≥ 16.  The same tensors
        while the row count stands; the entities' rows are packed anew at
        each call (before the frame that reads them)."""
        soup = self._soup_static()
        if soup is None:
            return None
        if self.entities:
            self._pack_entities()
        return soup.buffers

    def _ent(self):
        """The soup's buffers as they stand (no pack)."""
        return None if self._soup is None else self._soup.buffers

    # ------------------------------------------------------------------
    # the frame
    # ------------------------------------------------------------------

    def _ensure_states(self):
        """Allocate the feedback states that are missing or of another
        size: the fixed buffers the frames write in place."""
        H, W = self.height, self.width
        if self.settings.rendering.use_restir and (
                self.restir_state is None
                or tuple(self.restir_state.data.shape[1:]) != (H, W)):
            self.restir_state = restir_mod.initial_state(
                H, W, device=self.device)
        if self.denoiser_state is None \
                or tuple(self.denoiser_state.hist_len.shape) != (H, W):
            self.denoiser_state = initial_denoiser_state(
                H, W, device=self.device)

    def _write_states(self, restir=None, dstate=None, pstate=None):
        """Write new feedback states into the engine's fixed buffers."""
        if restir is not None and restir is not self.restir_state:
            self.restir_state.data.copy_(restir.data)
        if dstate is not None and dstate is not self.denoiser_state:
            for dst, src in zip(self.denoiser_state, dstate):
                dst.copy_(src)
        if pstate is not None and pstate is not self.post_state:
            self.post_state.exposure.copy_(pstate.exposure)

    def _trace_fn(self, n_local: int, half_res_gi: bool,
                  block_highlight: bool):
        """render_frame with the engine's static configuration bound now
        (sizes, world shape, settings): trace(tables, mats, lights, sky,
        cam, hist_cam, frame_idx, prev_restir, light_remap, ent, atlas) →
        (GBuffers, new ReSTIR state | None)."""
        rs_cfg = dataclasses.replace(self.settings.rendering,
                                     local_light_candidates=n_local)
        cfg, tp, W, H = self.cfg, self._tp, self.width, self.height

        def run(tables, mats, lights, sky_state, cam, hist_cam, frame_idx,
                prev_restir, light_remap, ent, atlas):
            return pathtracer.render_frame(
                cfg, tables, tp, mats, lights, sky_state, cam, hist_cam,
                frame_idx, W, H, rs_cfg,
                prev_restir=prev_restir if rs_cfg.use_restir else None,
                light_remap=light_remap, entities=ent, atlas=atlas,
                half_res_gi=half_res_gi, block_highlight=block_highlight)
        return run

    def _frame_constants(self) -> postprocess.PostConstants:
        """The post chain's constants for the current settings, built once
        outside the frame."""
        st = self.settings
        key = (st.post_processing, st.tone_mapping)
        if self._post_consts is None or self._post_consts[0] != key:
            self._post_consts = (key, postprocess.frame_constants(
                st.post_processing, st.tone_mapping, self.device))
        return self._post_consts[1]

    def _build_run(self, n_local_override: int | None = None):
        """The whole frame (path trace → denoise → post → u8) as a
        function of explicit arguments, the engine's static configuration
        bound now: run(tables, mats, lights, sky, cam, hist_cam,
        frame_idx, prev_restir, light_remap, dstate, post_state, dt, ent,
        atlas, overlay) → (u8, new_restir, new_dstate, new_post_state).
        frame_idx and dt are 0-d device tensors.  The stages are TRACER's
        spans (STAGES), each followed by a device stamp, after one before
        the path trace (`Tracer.stamp`: recorded only in a frame body's
        `Tracer.stamping`)."""
        n_local = self._n_local if n_local_override is None \
            else n_local_override
        rs = self.settings.rendering
        trace_fn = self._trace_fn(n_local, rs.half_res_gi, rs.block_highlight)
        dn_cfg = self.settings.denoising
        pp = self.settings.post_processing
        tm = self.settings.tone_mapping
        out_h, out_w = self.out_height, self.out_width
        consts = self._frame_constants()

        def run(tables, mats, lights, sky_state, cam, hist_cam, frame_idx,
                prev_restir, light_remap, dstate, post_state, dt, ent,
                atlas=None, overlay=None):
            TRACER.stamp("begin")
            with TRACER.span("pathtrace"):
                g, new_restir = trace_fn(tables, mats, lights, sky_state,
                                         cam, hist_cam, frame_idx,
                                         prev_restir, light_remap, ent,
                                         atlas)
            TRACER.stamp("pathtrace")
            with TRACER.span("denoise"):
                rgb, new_dstate = denoise_frame(g, dstate, dn_cfg)
            TRACER.stamp("denoise")
            with TRACER.span("post"):
                out, new_pstate = postprocess.run(
                    rgb, post_state, pp, tm, dt, out_h, out_w,
                    overlay_u8=overlay, highlight=g.highlight, consts=consts)
                out_u8 = (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(
                    torch.uint8)
            TRACER.stamp("post")
            return out_u8, new_restir, new_dstate, new_pstate
        return run

    def _trace_inputs(self):
        inp = self._stage()
        return (self._tables, self.materials, self.lights, self.sky_state,
                inp.camera, inp.history_camera, inp.frame,
                self.restir_state, inp.remap)

    def render_gbuffers(self):
        """Path trace one frame of the real-time path from the current
        states → (GBuffers, new ReSTIR state); advances nothing."""
        rs = self.settings.rendering
        return self._trace_fn(self._n_local, rs.half_res_gi,
                              rs.block_highlight)(
            *self._trace_inputs(), self.entity_buffers(), self.texture_atlas)

    # ------------------------------------------------------------------
    # the real-time frame: eager, or replayed from a captured graph
    # ------------------------------------------------------------------

    def _frame_body(self, nb: int, run, stamps=None):
        """nb frames from the fixed buffers — frame k at frame index
        frame + k, frame 0 with the history camera and frames 1… with the
        camera as their history, every frame with the same dt and remap,
        each frame's states feeding the next — then the last frame's
        states written into the fixed state buffers, and the closing
        stamp.  One frame records its stamps into `stamps` (a Stamps or
        None); a batch none.  Returns the u8 frame (nb 1) or the (nb, h,
        w, 3) stack.  This is the function a graph captures;
        `_eager_frame` runs it as it is."""
        inp = self._inputs
        restir, dstate, pstate = (self.restir_state, self.denoiser_state,
                                  self.post_state)
        ent, atlas = self._ent(), self.texture_atlas
        outs = []
        with TRACER.stamping(stamps if nb == 1 else None):
            for k in range(nb):
                hist = inp.history_camera if k == 0 else inp.camera
                frame = inp.frame if k == 0 else inp.frame + k
                u8, new_restir, dstate, pstate = run(
                    self._tables, self.materials, self.lights,
                    self.sky_state, inp.camera, hist, frame, restir,
                    inp.remap, dstate, pstate, inp.dt, ent, atlas,
                    self._ui_overlay)
                if new_restir is not None:
                    restir = new_restir
                outs.append(u8)
            self._write_states(restir, dstate, pstate)
            TRACER.stamp("end")
        return outs[0] if nb == 1 else torch.stack(outs)

    def _advance(self, nb: int):
        """The host side of nb frames: the remap consumed, the frame index
        advanced, the history camera the camera."""
        self._light_remap = self._identity_remap()
        self.frame_index += nb
        self._hist_host = self._cam_host.copy()
        self._staged = False

    def _frames(self, nb: int, dt: float, graph: bool) -> torch.Tensor:
        """nb frames in TRACER's span `engine.frame`: the soup brought up
        to date (`engine.soup`; the entities packed once for all nb, as
        the JAX package passes one soup to its batch), the inputs staged
        (`engine.stage`), the graph looked up (`engine.identity`; no graph
        runs eagerly, and the span is empty), then the frames launched
        (`engine.launch`)."""
        with TRACER.frame():
            self._ensure_states()
            with TRACER.span("engine.soup"):
                self.entity_buffers()
            with TRACER.span("engine.stage"):
                self._stage(dt)
            with TRACER.span("engine.identity"):
                key, g = self._graph_lookup(nb) if graph else (None, None)
            with TRACER.span("engine.launch"):
                if g is not None:
                    out = g.replay().clone()
                elif key is not None:
                    out = self._capture(key, nb)
                else:
                    out = self._frame_body(nb, self._build_run(),
                                           self._stamps)
            self._advance(nb)
        return out

    def _eager_frame(self, dt: float = 1.0 / 60.0) -> torch.Tensor:
        """One frame run eagerly, op by op: the function the graphs
        capture, for code that has to see the frame's own calls (hooks,
        profiles, tests).  Advances the engine like render_realtime_device
        and returns its u8 frame."""
        return self._frames(1, dt, graph=False)

    def _graph_inputs(self) -> tuple:
        """What a captured frame reads or writes by address (and the
        values its launches took)."""
        return (self._tables, self.materials, self.lights, self.sky_state,
                self.texture_atlas, self._ent(), self._ui_overlay,
                self._frame_constants(), self.restir_state,
                self.denoiser_state, self.post_state, self._inputs.words)

    def release_graphs(self):
        """Release every captured graph (its memory pool goes with it)."""
        for g in self._graphs.values():
            g.release()
        self._graphs = {}
        self._graph_identity = None

    def _graph_lookup(self, nb: int) -> tuple:
        """(key, its captured graph or None) of nb frames, keyed as the JAX
        package keys its jitted frame functions; the graphs are dropped
        when any tensor they read was replaced."""
        use_restir = self.settings.rendering.use_restir
        key = ("frame" if nb == 1 else ("frame_batch", nb), self.width,
               self.height, self.out_width, self.out_height, use_restir,
               self._n_local)
        ident = (frame_graph.identity(self._graph_inputs()), self.settings,
                 self.cfg, self._tp)
        if ident != self._graph_identity:
            self.release_graphs()
            self._graph_identity = ident
        return key, self._graphs.get(key)

    def _capture(self, key: tuple, nb: int) -> torch.Tensor:
        """A key's first call: its nb frames eagerly (on a side stream, as
        capture asks), then the capture, with stamps of its own."""
        run = self._build_run()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._frame_body(nb, run, self._stamps)
        cur.wait_stream(side)
        out.record_stream(cur)
        torch.cuda.synchronize(self.device)
        stamps = Stamps(self.device) if nb == 1 else None
        g = frame_graph.capture(lambda: self._frame_body(nb, run, stamps),
                                frame_graph.tensors(self._graph_inputs()),
                                stamps)
        self._graphs[key] = g
        self.graph_log.append(dict(key=key, capture_ms=g.capture_ms))
        return out

    def render_realtime_device(self, dt: float = 1.0 / 60.0) -> torch.Tensor:
        """One interactive frame: 1 spp + denoiser + post, with the UI
        overlay.  Returns the (out_h, out_w, 3) u8 frame on the engine's
        device; consumes the light remap of an edit.  On a CUDA device a
        replay of the captured frame."""
        return self._frames(1, dt, graph=self.device.type == "cuda")

    def render_realtime_device_batch(self, nb: int,
                                     dt: float = 1.0 / 60.0) -> torch.Tensor:
        """nb frames in one call (the JAX package's `lax.scan` batch):
        frame k at frame_index + k, frame 0 with the history camera and
        the rest with the camera as their history, every frame with the
        same dt and the same light remap.  Returns the device-resident
        (nb, out_h, out_w, 3) u8 stack; afterwards the frame index has
        grown by nb, the history camera is the camera and the remap is the
        identity.  On a CUDA device one replay of a graph of nb frames; on
        the CPU the same function, eagerly."""
        if nb < 1:
            raise ValueError(f"nb must be at least 1, got {nb}")
        out = self._frames(nb, dt, graph=self.device.type == "cuda")
        return out[None] if nb == 1 else out

    def render_realtime(self, dt: float = 1.0 / 60.0) -> np.ndarray:
        """Like render_realtime_device, fetched to a host numpy array."""
        return self.render_realtime_device(dt).cpu().numpy()

    def warm_light_variant_async(self):
        """Run one throwaway frame of the lights-on variant (the
        configured local-light candidates in place of 0) in a background
        thread, on its own CUDA stream with throwaway feedback states and
        copies of the per-frame inputs, the tables, the soup and the
        overlay (an edit, a pack or an overlay may write those in place
        while the variant runs), so
        that the first lit frame finds K4's lit instances loaded (CUDA
        loads a kernel's module at its first launch).  Returns the
        Thread, or None when the variant is already live or the engine
        has not rendered yet.  The live states are not touched."""
        n_local = self.settings.rendering.local_light_candidates
        if self._n_local == n_local or self.restir_state is None \
                or self.denoiser_state is None:
            return None
        run = self._build_run(n_local_override=n_local)
        inp = self._staged_inputs()
        cam = Camera(*(t.clone() for t in inp.camera))
        hist = Camera(*(t.clone() for t in inp.history_camera))
        ent = self._ent()
        args = (TraceTables(*(t.clone() if isinstance(t, torch.Tensor)
                              else t for t in self._tables)),
                self.materials,
                lighting.LightTable(*(t.clone() for t in self.lights)),
                self.sky_state, cam, hist, inp.frame.clone(),
                restir_mod.initial_state(self.height, self.width,
                                         device=self.device),
                inp.remap.clone(),
                initial_denoiser_state(self.height, self.width,
                                       device=self.device),
                PostState(exposure=self.post_state.exposure.clone()),
                inp.dt.clone(),
                None if ent is None else pathtracer.EntityBuffers(
                    *(t.clone() for t in ent)),
                self.texture_atlas, self._ui_overlay.clone())
        stream = None
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            # the side stream starts after everything queued so far
            stream.wait_stream(torch.cuda.current_stream(self.device))

        def work():
            try:
                with torch.cuda.stream(stream):     # None: no-op (CPU)
                    run(*args)
                if stream is not None:
                    stream.synchronize()
            except Exception:     # best effort: the live frame is unharmed
                warnings.warn("light-variant warm-up failed:\n"
                              + traceback.format_exc())

        t = threading.Thread(target=work, daemon=True,
                             name="rtvb-light-variant-warmup")
        t.start()
        return t

    # ------------------------------------------------------------------
    # offline accumulation
    # ------------------------------------------------------------------

    def path_trace(self) -> pathtracer.GBuffers:
        """One path-traced frame that advances the reservoirs and the frame
        index, as the JAX package's path_trace: full-resolution GI and no
        highlight whatever the settings say, and the history camera kept."""
        if self.settings.rendering.use_restir and self.restir_state is None:
            self.restir_state = restir_mod.initial_state(
                self.height, self.width, device=self.device)
        g, new_restir = self._trace_fn(self._n_local, False, False)(
            *self._trace_inputs(), self.entity_buffers(), self.texture_atlas)
        self._write_states(restir=new_restir)
        self._light_remap = self._identity_remap()
        self.frame_index += 1
        self._staged = False
        return g

    def render_accumulated(self, dt: float = 1.0 / 60.0) -> np.ndarray:
        """Offline path: the running mean of path_trace's radiance over the
        calls since the last reset (no denoiser), post-processed (no
        overlay) → (out_h, out_w, 3) f32 display values on the host."""
        g = self.path_trace()
        rgb = torch.stack([g.illum[i] * g.albedo[i] for i in range(3)], -1)
        if self._accum is None:
            self._accum = rgb
            self._accum_n = 1
        else:
            self._accum_n += 1
            self._accum = self._accum + (rgb - self._accum) / self._accum_n
        st = self.settings
        out, pstate = postprocess.run(
            self._accum, self.post_state, st.post_processing, st.tone_mapping,
            dt, self.out_height, self.out_width,
            consts=self._frame_constants())
        self._write_states(pstate=pstate)
        return out.cpu().numpy()

    def reset_accumulation(self):
        self._accum = None
        self._accum_n = 0
