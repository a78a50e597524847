"""The frozen reference (benchmark/reference/, a copy of the port's plain
path) against the port on the CPU, where the port runs its plain path
too: two frames at a small size from the same inputs, under the bars of
the port's own whole-frame tests (u8 mean |Δ| ≤ 1.0 and ≥ 90% within
3/255; states ≥ 99.9% within 1e-4) — met here to the bit."""
import json
import os

import numpy as np
import pytest
import torch

import benchpaths
from rtvbbench import check as C
from rtvbbench.session import feedback_state, settings_of, soup_rows, tables


def config(name):
    with open(os.path.join(benchpaths.BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def engines(cfg, window):
    from reference.core.config import Settings as RS
    from reference.render.renderer import Engine as RE
    from rtvb_tpu_torch.core.config import Settings as PS
    from rtvb_tpu_torch.render.renderer import Engine as PE
    return (PE(settings=settings_of(PS, cfg, window), device="cpu"),
            RE(settings=settings_of(RS, cfg, window), device="cpu"))


def held(a_u8, b_u8, a_state, b_state):
    d = np.abs(a_u8.astype(np.int16) - b_u8.astype(np.int16))
    assert d.mean() <= 1.0 and (d <= 3).mean() >= 0.90
    assert C.state_far(a_state, b_state) <= 1e-3
    assert (d == 0).all()
    for k, v in a_state.items():
        assert torch.equal(v, b_state[k]), k


@pytest.mark.parametrize("name,window", [("native_1440p", (64, 36)),
                                         ("half_1440p", (96, 54))])
def test_two_frames_moving(name, window):
    port, ref = engines(config(name), window)
    for i, eng in enumerate((port, ref)):
        eng.set_camera(pos=(32.0, 18.0, 8.0), yaw=1.1, pitch=-0.35)
    for k in range(2):
        outs = []
        for eng in (port, ref):
            eng.set_camera(pos=(32.0 + 0.3 * k, 18.0, 8.0 + 0.2 * k),
                           yaw=1.1 + 0.05 * k)
            outs.append((eng.render_realtime(1 / 60), feedback_state(eng)))
        held(outs[0][0], outs[1][0], outs[0][1], outs[1][1])


def test_edit_and_character():
    from reference.assets import blocks as RB
    from reference.models.character import Character as RC
    from rtvb_tpu_torch.assets import blocks as PB
    from rtvb_tpu_torch.models.character import Character as PC
    port, ref = engines(config("half_1440p"), (64, 36))
    chars = []
    for eng, Ch in ((port, PC), (ref, RC)):
        eng.set_camera(pos=(32.0, 14.0, 8.0), yaw=1.1, pitch=-0.9)
        ch = Ch(cfg_world=eng.cfg, move=eng.settings.character_movement)
        ch.position = np.array([31.5, 9.0, 11.5], np.float32)
        ch.update(eng.host_world, 1 / 30)
        eng.add_entity(ch.entity)
        chars.append(ch)
    picks = [eng.pick_block() for eng in (port, ref)]
    assert picks[0] == picks[1] and picks[0][0]
    hit, (x, y, z), n = picks[0]
    port.set_block(int(x + n[0]), int(y + n[1]), int(z + n[2]), PB.SOIL)
    ref.set_block(int(x + n[0]), int(y + n[1]), int(z + n[2]), RB.SOIL)
    for k in range(2):
        outs = []
        for eng, ch in zip((port, ref), chars):
            ch.update(eng.host_world, 1 / 30, (1.0, 0.0), False, False,
                      False)
            outs.append((eng.render_realtime(1 / 60), feedback_state(eng)))
        held(outs[0][0], outs[1][0], outs[0][1], outs[1][1])
    for a, b in ((tables(port), tables(ref)), (soup_rows(port),
                                                soup_rows(ref))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_origin_recorded():
    with open(os.path.join(benchpaths.BENCH, "reference", "SOURCE.md")) as f:
        text = f.read()
    assert "a1822e46c661c7c805faaf6bbdcfda2fa6df3549" in text
    listed = {line.split("`")[1] for line in text.splitlines()
              if line.startswith("- `")}
    ref = os.path.join(benchpaths.BENCH, "reference")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py") and "__pycache__" not in d:
                rel = os.path.relpath(os.path.join(d, f), ref)
                assert rel in listed or rel == "kernels.py", rel
