"""The settle phase on the CPU with a fake clock: it runs before the
window, outside setup_s, and its frames are not the window's."""
import json
import os
import time

import pytest

import benchpaths
from rtvbbench import cli
from rtvbbench.session import Session
from rtvbbench.spec import Benchmark

SEED = 2 ** 31 + 4242


def ticking(step=0.01):
    ticks = iter(range(10 ** 9))
    return lambda: next(ticks) * step


@pytest.mark.parametrize("cell", ["half.build", "half.walk"])
def test_settle_frames_are_not_the_windows(cell):
    """No clicks, no character steps, the window's first pose; the window
    opens after them and counts none of them."""
    b = Benchmark()
    c = b.cell(cell)
    s = Session(b.config(c["config"]), b.traffic(c["traffic"]), SEED,
                device="cpu", window=(64, 36), clock=ticking())
    s.build()
    s.warm()
    s.start()
    steps, clicks = len(s.char_log), len(s.clicks)
    s.settle(0.1)
    settled = [f for f in s.frames if f["phase"] == "settle"]
    assert len(settled) >= 2
    assert len(s.char_log) == steps and len(s.clicks) == clicks
    assert all(f["pose"] == s.traffic.pose(0.0) and not f["clicks"]
               and f["char_upto"] == steps for f in settled)
    s.run_window(0.1)
    window = s.window_frames()
    assert window and settled[-1]["n"] < window[0]["n"]
    assert all(f["phase"] == "window" for f in window)
    assert len(s.intervals) == len(window)


def test_settle_is_outside_setup(monkeypatch):
    """setup_s ends before the settle phase starts."""
    seen = {}
    orig = Session.settle

    def settle(self, seconds):
        seen["at"] = time.perf_counter()
        seen["seconds"] = seconds
        seen["frames0"] = len(self.frames)
        orig(self, seconds)
        seen["frames1"] = len(self.frames)
    monkeypatch.setattr(Session, "settle", settle)
    monkeypatch.setattr(cli, "process_age_s", lambda: None)
    t_start = time.perf_counter()
    res = cli.run_cell(Benchmark(), "half.fly", SEED, 0.5, False,
                       device="cpu", window=(64, 36), t_start=t_start,
                       settle_s=0.5)
    assert res["correct"], res["checks"]
    assert seen["seconds"] == 0.5 and seen["frames1"] > seen["frames0"]
    assert res["metrics"]["setup_s"]["value"] <= seen["at"] - t_start


def test_cells_settle_as_their_files_say():
    b = Benchmark()
    for cell in b.cells:
        path = os.path.join(b.dir, "cells", cell + ".json")
        want = 0.0
        if os.path.exists(path):
            with open(path) as f:
                want = json.load(f)["settle_s"]
        assert b.settle_s(cell) == want >= 0
