"""Engine settings: typed parameter groups with YAML round-trip.

Capability parity with the reference's GlobalSettings singleton
(renderer/core/GlobalSettings.h:10-386 — 8 typed param structs, reflection
lists for the dev UI, YAML load/save of data/settings/global_settings.yaml).

Here each group is a frozen dataclass; `Settings` aggregates them.  Fields are
plain Python floats/ints/bools (static under jit — changing a value recompiles,
which matches how these are used: config, not per-frame state).  Per-frame
dynamic values (camera, time of day, exposure state…) live in render state
pytrees instead.

The port's own copy of rtvb_tpu/core/config.py (same classes, fields and
defaults), so that reference never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any

import yaml


@dataclass(frozen=True)
class RenderingSettings:
    # GlobalSettings.h RenderingParams; bounce limits per RayGen.cu:146-147.
    total_bounce_limit: int = 3
    diffuse_bounce_limit: int = 1
    local_light_candidates: int = 8     # RIS candidates, closesthit.cu:330-343
    # local-light candidates streamed at secondary vertices: each candidate
    # costs ~3.4 ms/bounce at 1080p on v5e (table gathers dominate), and
    # secondary vertices contribute far less — 2 keeps lantern GI alive at
    # a quarter of the cost (primary vertices keep the full count + ReSTIR)
    secondary_light_candidates: int = 2
    max_trace_steps: int = 96           # DDA column-step cap
    target_fps: float = 60.0
    dynamic_resolution: bool = True
    min_render_scale: float = 0.5
    render_scale: float = 1.0           # internal res = output × scale
    render_width: int = 1920            # output (display) resolution
    render_height: int = 1080
    use_restir: bool = True
    restir_m_cap: int = 20              # closesthit.cu M-cap 20
    restir_temporal_samples: int = 3    # temporal taps (closesthit.cu:636)
    normal_mapping: bool = True         # procedural normal perturbation
    # authored image textures (data/textures/*.png via assets/image_textures,
    # TextureManager.cu role).  ON by default since r5: the demand-paged
    # two-tier atlas kernel (512² base mips, 32 slots) samples at ~0.1 ms
    # fixed + ~2 ms clustered cost, so the authored look ships as THE
    # canonical (VERDICT r4 item 7); the procedural stack remains the
    # secondary-vertex / fallback path.
    authored_textures: bool = True
    # picked-block edge highlight drawn in the realtime frame (the
    # reference computes it every frame, VoxelEngine.cu:884-903, though its
    # shader consumption sits behind `if (0)`, closesthit.cu:136-158; here
    # it ships working).  Off by default so offline/canonical output is
    # unchanged; the interactive app turns it on.
    block_highlight: bool = False
    entity_shadows: bool = True         # entities block NEE visibility rays
    # entities visible in indirect bounces (reflections / GI): ON to match
    # the reference's IAS covering ALL geometry for ALL ray types
    # (OptixRenderer.cpp:1369-1529); affordable since ops/tri_kernel's
    # AABB-culled SMEM sweep (~1 ms clustered at 1080p, docs/PROFILE.md)
    entity_in_bounces: bool = True
    # Realtime GI ray budget: trace bounces >= 1 (and their NEE shadow
    # rays) at HALF resolution — one representative path per 2x2 quad,
    # upsampled by redistributing the quad's incoming radiance through each
    # pixel's own full-res primary throughput.  Primary visibility, the
    # G-buffer, ReSTIR direct lighting and motion vectors stay exact at
    # full res, so every denoiser guide is unaffected; the denoiser +
    # temporal accumulation absorb the correlated GI noise (the same bet
    # the reference's NRD-style pipeline makes on checkerboarded inputs —
    # HitDistReconstruction.h heritage).  Secondary waves were ~55% of all
    # trace time (docs/PROFILE.md r4); this quarters their ray count.
    # Offline accumulation renders ignore this (full-res GI per sample).
    half_res_gi: bool = True
    # blue-noise low-discrepancy sampling (RandGen.h:21-46 role): sobol
    # XOR-basis + void-and-cluster scrambling/ranking tiles
    # (ops/rng.bn_draw, data/assets/bluenoise.npz).  OFF falls back to the
    # PCG + golden-ratio white-noise sampler.
    blue_noise: bool = True
    # per-bounce direct lighting + BSDF continuation as ONE fused kernel
    # (render/ris_kernel.py) instead of the in-line XLA composition — the
    # XLA shading fusions were measured VPU-op-bound at ~23 ms/frame
    # (docs/PROFILE.md r3); same estimator, same RNG stream either way
    fused_shading: bool = True


@dataclass(frozen=True)
class DenoisingSettings:
    # GlobalSettings.h:82-141 DenoisingParams.
    # NOTE: the reference's hit-dist reconstruction toggle
    # (HitDistReconstruction.h:50) has no equivalent here BY DESIGN: it
    # patches holes in the hitDist that rides its radiance alpha channel
    # when checkerboarded paths skip pixels — this wavefront renderer
    # writes exact DDA depth for every pixel every frame, so there is
    # nothing to reconstruct.
    enabled: bool = True
    firefly_filter: bool = True
    pre_pass: bool = False              # Poisson-disk pre-blur (PrePass.h:6)
    temporal_accumulation: bool = True
    max_accumulated_frames: int = 30    # slow history
    max_fast_accumulated_frames: int = 6
    history_fix: bool = True
    history_clamping: bool = True
    atrous_iterations: int = 4
    phi_luminance: float = 2.0
    phi_normal: float = 64.0
    phi_depth: float = 0.05
    # relative depth tolerance for history reprojection (applied directly —
    # round 1 multiplied a 0.01 default by a hidden 20× fudge)
    disocclusion_threshold: float = 0.2


@dataclass(frozen=True)
class ToneMappingSettings:
    # GlobalSettings.h:145-186 ToneMappingParams.
    curve: str = "aces"                 # aces | uncharted2 | reinhard | none
    exposure_compensation: float = 0.0
    lift: float = 0.0
    gain: float = 1.0
    contrast: float = 1.0
    saturation: float = 1.0
    white_point: float = 11.2


@dataclass(frozen=True)
class PostProcessingSettings:
    # PostProcessingPipeline.cu pipeline toggles.
    auto_exposure: bool = True
    exposure_min_log: float = -8.0
    exposure_max_log: float = 8.0
    exposure_low_percentile: float = 0.6
    exposure_high_percentile: float = 0.95
    exposure_adapt_speed: float = 2.0
    bloom: bool = True
    bloom_intensity: float = 0.08
    bloom_threshold: float = 1.2
    lens_flare: bool = False
    lens_flare_intensity: float = 0.05
    vignette: bool = True
    vignette_strength: float = 0.25
    sharpen: bool = True
    sharpen_strength: float = 0.35
    upscale: str = "easu"               # easu | bicubic | none
    crosshair: bool = False


@dataclass(frozen=True)
class SkySettings:
    # GlobalSettings.h SkyParams + Sky.cu time-of-day driving.
    # model: "hosek" = the reference's 10-channel Hosek–Wilkie spectral fit
    # (Sky.cu:19-260 + SkyData.h) projected per sun position onto the RGB
    # basis (render/sky_spectral.py); "preetham" = the pre-r5 analytic look.
    model: str = "hosek"
    time_of_day: float = 10.0           # hours
    sun_axis_angle: float = 35.0        # degrees, sun rotation axis tilt
    turbidity: float = 2.5
    ground_albedo: float = 0.3
    sun_angular_diameter: float = 0.51  # degrees, miss.cu:41-77
    sky_intensity: float = 1.0
    sun_intensity: float = 1.0
    sky_res_w: int = 256                # equal-area env map (pdf/sampling aid)
    sky_res_h: int = 128


@dataclass(frozen=True)
class CharacterMovementSettings:
    walk_speed: float = 2.0
    run_speed: float = 4.5
    jump_velocity: float = 5.2
    gravity: float = 14.0
    eye_height: float = 1.62
    body_radius: float = 0.35
    body_height: float = 1.8
    yaw_smooth: float = 12.0


@dataclass(frozen=True)
class CharacterAnimationSettings:
    blend_time: float = 0.15
    walk_cycle_scale: float = 1.0
    additive_place_block: bool = True


@dataclass(frozen=True)
class CameraMovementSettings:
    fly_speed: float = 8.0
    mouse_sensitivity: float = 0.0025
    fov_y_degrees: float = 60.0
    follow_distance: float = 4.0
    follow_stiffness: float = 8.0


_GROUPS = {
    "rendering": RenderingSettings,
    "denoising": DenoisingSettings,
    "tone_mapping": ToneMappingSettings,
    "post_processing": PostProcessingSettings,
    "sky": SkySettings,
    "character_movement": CharacterMovementSettings,
    "character_animation": CharacterAnimationSettings,
    "camera_movement": CameraMovementSettings,
}


@dataclass(frozen=True)
class Settings:
    rendering: RenderingSettings = field(default_factory=RenderingSettings)
    denoising: DenoisingSettings = field(default_factory=DenoisingSettings)
    tone_mapping: ToneMappingSettings = field(default_factory=ToneMappingSettings)
    post_processing: PostProcessingSettings = field(default_factory=PostProcessingSettings)
    sky: SkySettings = field(default_factory=SkySettings)
    character_movement: CharacterMovementSettings = field(default_factory=CharacterMovementSettings)
    character_animation: CharacterAnimationSettings = field(default_factory=CharacterAnimationSettings)
    camera_movement: CameraMovementSettings = field(default_factory=CameraMovementSettings)

    # ---- YAML round-trip (GlobalSettings.h:355-356 equivalent) ----

    def to_dict(self) -> dict:
        return {k: dataclasses.asdict(getattr(self, k)) for k in _GROUPS}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def from_dict(cls, d: dict) -> "Settings":
        kwargs = {}
        for key, group_cls in _GROUPS.items():
            src = d.get(key, {}) or {}
            valid = {f.name for f in fields(group_cls)}
            unknown = set(src) - valid
            if unknown:
                raise ValueError(f"unknown settings in group '{key}': {sorted(unknown)}")
            kwargs[key] = group_cls(**src)
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str) -> "Settings":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def replace(self, **group_updates: Any) -> "Settings":
        """Functional update: settings.replace(rendering={'render_width': 1280})."""
        kwargs = {}
        for key, upd in group_updates.items():
            group = getattr(self, key)
            if isinstance(upd, dict):
                kwargs[key] = dataclasses.replace(group, **upd)
            else:
                kwargs[key] = upd
        return dataclasses.replace(self, **kwargs)

    def value_list(self):
        """Flat (group.field, value) pairs — the reflection list the dev
        overlay renders (DeveloperGUIOverlay.cpp:33-90 equivalent)."""
        out = []
        for key in _GROUPS:
            group = getattr(self, key)
            for f in fields(group):
                out.append((f"{key}.{f.name}", getattr(group, f.name)))
        return out

    def adjust(self, flat_name: str, direction: int) -> "Settings":
        """Live-edit one reflected field by ±1 step (the dev panel's
        slider role, DeveloperGUIOverlay.cpp:33-90): bools toggle, ints
        step by 1 (floored at 0), floats scale by 1.25× per step (or seed
        at ±0.1 from zero).  String fields are left unchanged — they cycle
        through domain-specific values the panel doesn't know."""
        group, field_name = flat_name.split(".", 1)
        val = getattr(getattr(self, group), field_name)
        if isinstance(val, bool):
            new: Any = (not val) if direction else val
        elif isinstance(val, int):
            new = max(0, val + direction)
        elif isinstance(val, float):
            if val == 0.0:
                new = 0.1 * direction
            else:
                new = val * (1.25 ** direction)
        else:
            return self
        return self.replace(**{group: {field_name: new}})
