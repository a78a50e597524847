"""The output check, driven on the CPU at a small window (the look for a
card skipped): sound runs come out correct; the run with the timed path
broken underneath, once for each fault a cell can have, and the control
(the reference in bfloat16 in the program's place) come out not correct.
The runs here have no settle phase, which test_benchmark_session
covers.  The check at the cells' own size runs on the card (marked
gpu)."""
import os
import subprocess
import sys

import pytest
import torch

import benchpaths
from rtvbbench import check as C
from rtvbbench.cli import run_cell
from rtvbbench.session import Session
from rtvbbench.spec import Benchmark

WINDOW = (64, 36)
SEED = 2 ** 31 + 17


def cpu_run(cell, trace=False, seconds=1.0, seed=SEED):
    import time
    return run_cell(Benchmark(), cell, seed, seconds, trace, device="cpu",
                    window=WINDOW, t_start=time.perf_counter(), settle_s=0.0)


@pytest.mark.parametrize("cell", ["native.fly", "half.build", "half.walk"])
def test_sound_runs_are_correct(cell):
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def test_traced_run_is_correct():
    res = cpu_run("half.fly", trace=True, seconds=3.0)
    assert res["correct"], res["checks"]
    assert "breakdown" in res and "busy_s" in res["device"]


def test_untraced_intervals_leave_out_the_profiled_frames():
    """The frames device.idle_share divides by: the window's frames
    before the profile, not the profiler's warm-up frame, the slice's
    frames or any after them."""
    ticks = iter(range(10 ** 9))
    b = Benchmark()
    c = b.cell("half.fly")
    s = Session(b.config(c["config"]), b.traffic(c["traffic"]), SEED,
                device="cpu", window=WINDOW,
                clock=lambda: next(ticks) * 0.01)
    s.build()
    s.warm()
    s.start()
    s.run_window(1.0, profile_slice=(0.5, lambda n, sec: n >= 3))
    assert s.profile[1] == 3
    k = len(s.untraced)
    assert k > 0 and s.untraced == s.intervals[:k]
    assert len(s.intervals) >= k + 4


def _state_unchanged(mp, E):
    mp.setattr(E, "_write_states", lambda self, *a, **k: None)


def _half_rows(mp, E):
    orig = E.render_realtime_device

    def frame(self, dt=1.0 / 60.0):
        out = orig(self, dt).clone()
        out[out.shape[0] // 2:] = 0
        return out
    mp.setattr(E, "render_realtime_device", frame)


def _tile_altered(mp, E):
    orig = E.render_realtime_device

    def frame(self, dt=1.0 / 60.0):
        out = orig(self, dt).clone()
        h, w = out.shape[0] // 16 or 1, out.shape[1] // 16 or 1
        out[:h, :w] = 255 - out[:h, :w]
        return out
    mp.setattr(E, "render_realtime_device", frame)


def _edit_dropped(mp, E):
    mp.setattr(E, "set_blocks", lambda self, xyz, ids: None)


def _pose_stale(mp, E):
    mp.setattr(E, "_pack_entities", lambda self: None)


FAULTS = [("native.fly", _state_unchanged), ("native.fly", _half_rows),
          ("native.fly", _tile_altered), ("half.build", _edit_dropped),
          ("half.walk", _pose_stale)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    from rtvb_tpu_torch.render.renderer import Engine
    fault(monkeypatch, Engine)
    res = cpu_run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["native.fly", "half.build"])
def test_control_is_not_correct(cell):
    """The reference with its stages' planes in bfloat16, in the
    program's place, fails the cell's limits."""
    b = Benchmark()
    c = b.cell(cell)
    s = Session(b.config(c["config"]), b.traffic(c["traffic"]), SEED,
                device="cpu", window=WINDOW)
    s.build()
    s.warm()
    s.start()
    s.run_window(1.0)
    prog = C.program_side(s)
    ref = C.reference_side(s, prog)
    ctrl = C.reference_side(s, prog, "bf16")
    numbers = C.compare(ctrl, dict(ref, picks_diff=ctrl["picks_diff"]),
                        s.traffic.clicks is not None,
                        s.traffic.character is not None)
    ok, rows = C.judge(numbers, b.limits(cell))
    assert not ok, rows
    assert C.judge(C.compare(prog, ref, s.traffic.clicks is not None,
                             s.traffic.character is not None),
                   b.limits(cell))[0]


@pytest.mark.parametrize("cell", ["native.fly", "half.build", "half.walk"])
def test_fresh_reference_follows_the_whole_run(cell):
    """The reference from its own first state, over every frame of the
    run (set-up and window), reads the program's check frames as the
    reference from the program's handed-over states does: the states
    handed over are the ones the reference works out itself."""
    b = Benchmark()
    c = b.cell(cell)
    s = Session(b.config(c["config"]), b.traffic(c["traffic"]), SEED,
                device="cpu", window=WINDOW)
    s.build()
    s.warm()
    s.start()
    s.run_window(1.0)
    prog = C.program_side(s)
    ref = C.reference_side(s, prog, fresh=True)
    numbers = C.compare(prog, ref, s.traffic.clicks is not None,
                        s.traffic.character is not None)
    assert len(s.frames) > len(prog["frames"]) + 3
    assert all(v == 0 for v in numbers.values()), numbers


def test_no_card_no_result():
    """run.py on a machine without a card exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, os.path.join(benchpaths.BENCH, "run.py"),
         "--workload", "native.fly", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=benchpaths.ROOT)
    assert res.returncode != 0
    assert not res.stdout.strip().startswith("{")


@pytest.mark.gpu
def test_cell_on_the_card():
    """A short run of half.fly at its own size on the card: correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time
    res = run_cell(Benchmark(), "half.fly", SEED, 3.0, False,
                   t_start=time.perf_counter())
    assert res["correct"], res["checks"]
