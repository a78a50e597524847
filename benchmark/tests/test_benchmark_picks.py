"""Every half.build click hits: the pick from every pose the traffic can
take (a grid over the glide's range and the yaw sway's, which covers
every seed's phases), and a soil block placed on the picked face and
deleted keeps the tables' shapes (no recapture)."""
import json
import os

import numpy as np
import pytest

import benchpaths
from rtvbbench.session import Session
from rtvbbench.traffic import Traffic

SEEDS = [3000000003, 2 ** 31 + 99, 5, 987654321987]


@pytest.fixture(scope="module")
def session():
    with open(os.path.join(benchpaths.BENCH, "traffic", "build.json")) as f:
        spec = json.load(f)
    with open(os.path.join(benchpaths.BENCH, "configs",
                           "half_1440p.json")) as f:
        cfg = json.load(f)
    s = Session(cfg, spec, 1, device="cpu", window=(64, 36))
    s.build()
    return s, spec


def grid(spec):
    c = spec["camera"]
    lo, hi = c["glide"]["range"]
    amp = c["yaw_sway"]["amp"]
    for g in np.linspace(lo, hi, 9):
        for dy in np.linspace(-amp, amp, 7):
            pos = (c["pos"][0] + g, c["pos"][1], c["pos"][2])
            yield pos, c["yaw"] + dy, c["pitch"]


def test_every_pose_picks_and_keeps_shapes(session):
    s, spec = session
    eng = s.eng
    from rtvb_tpu_torch.assets import blocks as B
    world, cap = eng.world, eng.cfg.max_exceptions
    for pos, yaw, pitch in grid(spec):
        eng.set_camera(pos=pos, yaw=yaw, pitch=pitch)
        hit, (x, y, z), n = eng.pick_block()
        assert hit, (pos, yaw)
        t = (int(x + n[0]), int(y + n[1]), int(z + n[2]))
        eng.set_block(*t, B.SOIL)
        assert eng.world is world and eng.cfg.max_exceptions == cap
        eng.delete_block(*t)
        assert eng.world is world and eng.cfg.max_exceptions == cap


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_poses_in_the_grid(session, seed):
    _, spec = session
    tr = Traffic(spec, seed)
    c = spec["camera"]
    for i in range(200):
        (x, y, z), yaw, pitch = tr.pose(spec["clicks"]["every_s"] * i)
        assert c["pos"][0] - 2.0 - 1e-9 <= x <= c["pos"][0] + 2.0 + 1e-9
        assert abs(yaw - c["yaw"]) <= c["yaw_sway"]["amp"] + 1e-9
        assert (y, z, pitch) == (c["pos"][1], c["pos"][2], c["pitch"])
