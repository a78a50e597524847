"""Character: the rigged avatar, its physics against the voxel grid and
its locomotion (port of rtvb_tpu/models/character.py).

Gravity, jump, ground snap, ceiling check, horizontal cylinder collision
against the voxel grid, smooth yaw, and the idle / walk / run state
machine with an additive place-block layer.  The mesh is the shipped
data/models/character.glb, or the procedural cuboid rig when that file is
missing.

Physics reads the engine's host copy of the block grid
(`Engine.host_world`: the grid and a version the engine bumps on every
edit), never a device tensor: the collision loop samples ~28 voxels a
frame.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..core.config import CharacterMovementSettings
from ..world import voxel as voxel_mod
from .animation import AnimationClip
from .entity import Entity, MeshData, make_cuboid, merge_meshes
from .skeleton import Skeleton

# joints: 0 root/pelvis, 1 torso, 2 head, 3 armL, 4 armR, 5 legL, 6 legR
JOINT_NAMES = ["root", "torso", "head", "arm_l", "arm_r", "leg_l", "leg_r"]


def load_character_mesh() -> MeshData:
    """The shipped rigged character, data/models/character.glb; the
    procedural cuboid rig when the file is missing or has no skeleton or
    clips."""
    path = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "data", "models", "character.glb")
    if os.path.exists(path):
        from ..assets.models import load_model
        mesh = load_model(path)
        if mesh.skeleton is not None and mesh.clips:
            return mesh
    return build_character_mesh()


def build_character_mesh() -> MeshData:
    """Blocky humanoid (~1.8 units tall) with per-part rigid skinning."""
    parts = [
        (make_cuboid((0.0, 1.05, 0.0), (0.5, 0.6, 0.28)), 1),   # torso
        (make_cuboid((0.0, 1.55, 0.0), (0.4, 0.4, 0.4)), 2),    # head
        (make_cuboid((-0.35, 1.0, 0.0), (0.18, 0.6, 0.18)), 3), # arm L
        (make_cuboid((0.35, 1.0, 0.0), (0.18, 0.6, 0.18)), 4),  # arm R
        (make_cuboid((-0.12, 0.4, 0.0), (0.2, 0.75, 0.2)), 5),  # leg L
        (make_cuboid((0.12, 0.4, 0.0), (0.2, 0.75, 0.2)), 6),   # leg R
    ]
    mesh = merge_meshes(parts)
    j = len(JOINT_NAMES)
    parents = np.array([-1, 0, 1, 1, 1, 0, 0], np.int32)
    # joint origins (pivots)
    pivots = np.array([
        [0, 0.8, 0], [0, 1.05, 0], [0, 1.4, 0],
        [-0.35, 1.25, 0], [0.35, 1.25, 0],
        [-0.12, 0.75, 0], [0.12, 0.75, 0],
    ], np.float32)
    bind_t = pivots.copy()
    for i in range(j):
        if parents[i] >= 0:
            bind_t[i] = pivots[i] - pivots[parents[i]]
    bind_r = np.tile(np.array([[0, 0, 0, 1.0]], np.float32), (j, 1))
    bind_s = np.ones((j, 3), np.float32)
    # inverse bind: joints' global bind transform is a pure translation
    inv_bind = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
    inv_bind[:, :3, 3] = -pivots
    mesh.skeleton = Skeleton(JOINT_NAMES, parents, bind_t, bind_r, bind_s, inv_bind)
    mesh.clips = _make_locomotion_clips(mesh.skeleton)
    return mesh


def _swing_clip(name, skel: Skeleton, period, arm_amp, leg_amp, bob):
    """Procedural walk/run cycle: counter-phase limb swings about x."""
    f = 16
    times = np.linspace(0, period, f)
    tracks = {}
    for j in range(skel.n_joints):
        tt = np.tile(skel.bind_t[j], (f, 1)).astype(np.float32)
        rr = np.tile(skel.bind_r[j], (f, 1)).astype(np.float32)
        ss = np.ones((f, 3), np.float32)
        phase = 2 * np.pi * times / period
        if skel.names[j] in ("arm_l", "leg_r"):
            ang = np.sin(phase) * (arm_amp if "arm" in skel.names[j] else leg_amp)
        elif skel.names[j] in ("arm_r", "leg_l"):
            ang = -np.sin(phase) * (arm_amp if "arm" in skel.names[j] else leg_amp)
        else:
            ang = np.zeros(f)
        if skel.names[j] == "root":
            tt[:, 1] += np.abs(np.sin(phase)) * bob
        rr[:, 0] = np.sin(ang / 2)
        rr[:, 3] = np.cos(ang / 2)
        tracks[j] = (times, tt, rr, ss)
    return AnimationClip.from_keyframes(name, tracks, skel.n_joints, period)


def _make_locomotion_clips(skel: Skeleton):
    return {
        "idle": _swing_clip("idle", skel, 3.0, 0.06, 0.0, 0.01),
        "walk": _swing_clip("walk", skel, 1.0, 0.5, 0.6, 0.03),
        "run": _swing_clip("run", skel, 0.6, 0.9, 0.9, 0.06),
        "place": _swing_clip("place", skel, 0.4, 1.2, 0.0, 0.0),
    }


@dataclass
class Character:
    cfg_world: voxel_mod.WorldConfig
    move: CharacterMovementSettings = field(default_factory=CharacterMovementSettings)
    position: np.ndarray = field(default_factory=lambda: np.array([32.0, 20.0, 32.0], np.float32))
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0
    target_yaw: float = 0.0
    on_ground: bool = False
    anim_time: float = 0.0
    state: str = "idle"            # locomotion state machine
    blend: float = 0.0             # state blend weight
    prev_state: str = "idle"
    entity: Entity = None

    def __post_init__(self):
        if self.entity is None:
            from ..assets import decorations as deco
            self.entity = Entity(mesh=load_character_mesh(),
                                 material="default",
                                 image=deco.registry().entry("character")
                                 .get("image"))

    # ---- physics against the voxel grid ----

    def _host_blocks(self, world) -> np.ndarray:
        """The host block grid of `world` (a voxel.HostWorld), cached by
        the world's version: an edit bumps the version, so the next
        update reads the edited grid.  (The engine writes its device
        tables in place, so the identity of a device buffer would not
        change on an edit.)"""
        cached = getattr(self, "_blocks_cache", None)
        if cached is None or cached[0] != world.version:
            cached = (world.version, world.blocks)
            self._blocks_cache = cached
        return cached[1]

    def _solid(self, world, x, y, z) -> bool:
        cfg = self.cfg_world
        ix, iy, iz = int(np.floor(x)), int(np.floor(y)), int(np.floor(z))
        if not (0 <= ix < cfg.x and 0 <= iy < cfg.y and 0 <= iz < cfg.z):
            return False
        return int(self._host_blocks(world)[ix, iy, iz]) != 0

    def update(self, world, dt: float, move_input=(0.0, 0.0), run=False,
               jump=False, placing=False):
        """One physics and animation step of dt seconds against `world`
        (a voxel.HostWorld).  move_input: (forward, strafe) in [-1, 1]."""
        mv = self.move
        speed = mv.run_speed if run else mv.walk_speed
        fwd, strafe = move_input
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        wish = np.array([c * fwd - s * strafe, 0.0, s * fwd + c * strafe], np.float32)
        n = np.linalg.norm(wish)
        if n > 1e-5:
            wish = wish / n * speed
            self.target_yaw = float(np.arctan2(wish[2], wish[0]))

        # smooth yaw
        dy = (self.target_yaw - self.yaw + np.pi) % (2 * np.pi) - np.pi
        self.yaw += dy * min(1.0, mv.yaw_smooth * dt)

        self.velocity[0] = wish[0]
        self.velocity[2] = wish[2]
        self.velocity[1] -= mv.gravity * dt
        if jump and self.on_ground:
            self.velocity[1] = mv.jump_velocity
            self.on_ground = False

        p = self.position.copy()
        r = mv.body_radius
        h = mv.body_height

        # horizontal cylinder collision: test 4 sample points at feet+mid
        for axis in (0, 2):
            np_ = p.copy()
            np_[axis] += self.velocity[axis] * dt
            blocked = False
            for oy in (0.1, h * 0.5, h - 0.1):
                for sx, sz in ((r, 0), (-r, 0), (0, r), (0, -r)):
                    if self._solid(world, np_[0] + sx, np_[1] + oy, np_[2] + sz):
                        blocked = True
                        break
                if blocked:
                    break
            if not blocked:
                p[axis] = np_[axis]

        # vertical: ground snap & ceiling check
        ny = p[1] + self.velocity[1] * dt
        if self.velocity[1] <= 0:
            if (self._solid(world, p[0], ny - 0.01, p[2])
                    or self._solid(world, p[0] + r * 0.7, ny - 0.01, p[2])
                    or self._solid(world, p[0] - r * 0.7, ny - 0.01, p[2])):
                ny = float(np.floor(ny) + 1.0)
                self.velocity[1] = 0.0
                self.on_ground = True
            else:
                self.on_ground = False
        else:
            if self._solid(world, p[0], ny + h, p[2]):
                self.velocity[1] = 0.0
        p[1] = ny
        self.position = p

        # ---- locomotion state machine ----
        planar = float(np.hypot(self.velocity[0], self.velocity[2]))
        new_state = "idle" if planar < 0.1 else ("run" if run else "walk")
        if new_state != self.state:
            self.prev_state = self.state
            self.state = new_state
            self.blend = 0.0
        self.blend = min(1.0, self.blend + dt / 0.15)
        self.anim_time += dt
        self._placing = placing

        self._update_pose()

    def _update_pose(self):
        from . import animation as anim
        mesh = self.entity.mesh
        skel = mesh.skeleton
        clips = mesh.clips

        # pose math runs on the host in numpy; only the composed joint
        # matrices reach the device
        def pose_of(name):
            c = clips[name]
            return anim.evaluate(c.host_tracks(), self.anim_time, c.duration)

        cur = pose_of(self.state)
        if self.blend < 1.0 and self.prev_state in clips:
            cur = anim.blend(pose_of(self.prev_state), cur, self.blend)
        if getattr(self, "_placing", False):
            ref = skel.bind_pose_np()
            cur = anim.additive(cur, pose_of("place"), ref, 0.8)

        self.entity.position = self.position
        self.entity.yaw = -self.yaw + np.pi / 2
        mats = skel.skinning_matrices(*cur,
                                      model=self.entity.model_matrix_np())
        self.entity.set_pose(mats)

    def eye_position(self):
        return self.position + np.array([0, self.move.eye_height, 0], np.float32)
