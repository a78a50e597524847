"""The real-time frame is capture-safe: on the CPU, every frame the engine
can be asked for runs under a dispatch mode that fails on a host read of
a tensor (`aten._local_scalar_dense`: `.item()`, `int()`, `float()`,
`bool()`) and on a tensor made from host data (`aten.lift_fresh`:
`torch.tensor(...)`).  On the card either one would sync the frame or
upload host memory inside a captured CUDA graph, which then replays a
stale value.  The only reads allowed are in the plain versions of the
kernels, named below, which the card never runs: there a CUDA tensor
launches the kernel instead.  Also: the engine's camera moves, the
batch and the input staging read nothing from the device."""
import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rtvb_tpu_torch.assets import blocks as PB
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render.renderer import Engine

SIZE = 32
FORBIDDEN = {torch.ops.aten._local_scalar_dense.default: "host read",
             torch.ops.aten.lift_fresh.default: "host upload"}
# plain kernel versions (file, function): CPU only; on the card their
# wrapper launches the kernel
PLAIN = {("ops/dda.py", "trace_plain")}


class HostTouches(TorchDispatchMode):
    """Records each forbidden op with the port's innermost frame of the
    stack, unless a plain kernel version is on it."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.allowed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in FORBIDDEN:
            stack = [(f.filename.replace("\\", "/").split(
                "rtvb_tpu_torch/")[-1], f.name, f.lineno)
                for f in traceback.extract_stack()
                if "rtvb_tpu_torch" in f.filename]
            if any((fn, name) in PLAIN for fn, name, _ in stack):
                self.allowed += 1
            else:
                self.seen.append((FORBIDDEN[func], stack[-3:]))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def engine():
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": SIZE, "render_height": SIZE}), device="cpu")
    eng.render_realtime_device()
    return eng


def _frames_clean(eng, frames):
    with HostTouches() as mode:
        frames(eng)
    assert mode.seen == [], mode.seen
    return mode


DEV_PANEL = dict(
    rendering={"block_highlight": True, "restir_temporal_samples": 6},
    denoising={"pre_pass": True},
    post_processing={"lens_flare": True, "crosshair": True},
    tone_mapping={"curve": "uncharted2"}, sky={"model": "preetham"})


@pytest.mark.parametrize("case", ["shipped", "batch of 2", "in-line",
                                  "1/2 rung", "dev panel", "lit"])
def test_frame_reads_and_uploads_nothing(engine, case):
    eng = engine
    if case == "in-line":
        eng.apply_settings(eng.settings.replace(
            rendering={"fused_shading": False}))
    elif case == "1/2 rung":
        eng.set_render_scale(0.5)
    elif case == "dev panel":
        eng.apply_settings(eng.settings.replace(**DEV_PANEL))
    elif case == "lit":
        eng.set_sky(time_of_day=0.0)
        eng.set_camera(pos=(32.0, 14.0, 8.0), yaw=1.1, pitch=-0.9)
        hit, (x, y, z), _ = eng.pick_block()
        assert hit
        eng.set_block(x, y + 1, z, PB.LANTERN)
        assert eng._n_local > 0
    try:
        # a frame first, as the engine runs one eagerly before it captures
        # (it fills the caches: the blue-noise planes of a new size, the
        # post constants of new settings, the decoration soup); the next
        # is the function a graph captures
        if case == "batch of 2":
            eng.render_realtime_device_batch(2)
            mode = _frames_clean(eng, lambda e: e.render_realtime_device_batch(
                2))
        else:
            eng._eager_frame()
            mode = _frames_clean(eng, lambda e: e._eager_frame())
        # the plain trace's early exit is the one read, and it is there
        assert mode.allowed > 0
    finally:
        eng.apply_settings(engine.settings.replace(
            **{k: getattr(Settings(), k) for k in
               ("denoising", "post_processing", "tone_mapping", "sky")},
            rendering={"fused_shading": True, "block_highlight": False,
                       "restir_temporal_samples":
                       Settings().rendering.restir_temporal_samples}))
        eng.set_render_scale(1.0)


def test_camera_and_staging_read_nothing(engine):
    eng = engine
    _, yaw0, _ = eng.camera_pose()
    with HostTouches() as mode:
        eng.set_camera(pos=(30.0, 16.0, 9.0), yaw=0.9)
        eng.set_camera(pitch=-0.3, keep_history=True)
        pose = eng.camera_pose()
        eng._stage(1.0 / 30.0)
    assert mode.seen == [] and mode.allowed == 0, mode.seen
    assert pose == ((30.0, 16.0, 9.0), pytest.approx(0.9),
                    pytest.approx(-0.3))
    assert float(eng.camera.pitch) == pytest.approx(-0.3)
    # the history camera is the pose before the first move
    assert float(eng.history_camera.yaw) == pytest.approx(yaw0)


def test_walk_pack_and_edits_read_nothing():
    """A walking character's update (against the engine's host grid) and
    the soup's pack touch the device neither way (the pose matrices go
    through the engine's staged buffer); an edit written in place and its
    undo read nothing back (their host-built tables are uploads by
    design, outside any frame); then a frame, as clean as any other."""
    import numpy as np
    from rtvb_tpu_torch.models.character import Character
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": SIZE, "render_height": SIZE}), device="cpu")
    ch = Character(cfg_world=eng.cfg, move=eng.settings.character_movement)
    ch.position = np.array([31.5, 8.0, 45.0], np.float32)
    ch._update_pose()
    eng.add_entity(ch.entity)
    eng._eager_frame()              # caches filled, as before a capture
    x, z = 20, 30
    y = int(eng.host_world.blocks[x, :, z].nonzero()[0].max()) + 1
    with HostTouches() as mode:
        for _ in range(2):
            ch.update(eng.host_world, 1.0 / 30.0, (1.0, 0.0))
            eng.entity_buffers()
    assert mode.seen == [] and mode.allowed == 0, mode.seen
    with HostTouches() as mode:
        eng.set_block(x, y, z, PB.SAND)
        eng.set_block(x, y, z, 0)
        ch.update(eng.host_world, 1.0 / 30.0, (1.0, 0.0))
    reads = [s for s in mode.seen if s[0] == "host read"]
    assert reads == [] and mode.allowed == 0, reads
    assert ch._blocks_cache[0] == eng.world_version == 2
    mode = _frames_clean(eng, lambda e: e._eager_frame())
    assert mode.allowed > 0
