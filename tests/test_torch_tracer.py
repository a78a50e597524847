"""The engine's tracer (`rtvb_tpu_torch/utils/perf.py`) on the CPU: spans
and their parents, self time, the bounded ring, the switch, profiler
ranges only under a profiler, the Engine's frame phases and an edit's
spans and byte counts at 32×32, and `tools/device_trace`'s idle holes
named by the program span open at their start.  The device stamps run on
the card only (`tests/test_torch_gpu.py -k tracer`)."""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from rtvb_tpu_torch.utils import perf
from rtvb_tpu_torch.utils.perf import TRACER, Tracer


def _frame(tr, *names):
    """One frame of `tr` on the CPU with a span for each name in it."""
    with tr.frame():
        for name in names:
            with tr.span(name):
                pass


def test_spans_nest_with_their_parents():
    tr = Tracer()
    with tr.span("edit.pick") as pick:
        pass
    with tr.frame() as frame:
        with tr.span("engine.launch") as launch:
            with tr.span("pathtrace") as pt:
                tr.count("bytes", 5)
                tr.count("bytes", 7)
    rec = tr.records[-1]
    assert [s.name for s in rec.spans] == ["edit.pick", "pathtrace",
                                          "engine.launch", "engine.frame"]
    assert pick.parent is None and frame.parent is None
    assert launch.parent is frame and pt.parent is launch
    assert {s.frame for s in rec.spans} == {0} and rec.n == 0
    assert pt.counts == {"bytes": 12} and launch.counts is None
    assert frame.t0 <= launch.t0 <= pt.t0 <= pt.t1 <= launch.t1 <= frame.t1
    tr.count("bytes", 1)            # no span open: counted nowhere
    assert tr._record.spans == []


def test_self_time_is_the_span_less_its_children():
    tr = Tracer()
    _frame(tr, "engine.soup", "engine.stage")
    rec = tr.records[-1]
    frame = rec.spans[-1]
    soup, stage = rec.spans[:2]
    assert rec.self_ms(frame) == pytest.approx(
        frame.ms - soup.ms - stage.ms)
    assert rec.self_ms(soup) == soup.ms


def test_the_ring_is_bounded():
    tr = Tracer(capacity=3)
    for _ in range(5):
        _frame(tr, "engine.soup")
    assert [r.n for r in tr.records] == [2, 3, 4]
    tr.reset()
    assert len(tr.records) == 0 and tr._record.n == 0


def test_disabled_records_nothing():
    tr = Tracer()
    tr.enabled = False
    with tr.span("edit.rebuild") as sp:
        tr.count("bytes", 3)
    _frame(tr, "engine.soup")
    assert len(tr.records) == 0 and tr._record.spans == []
    assert sp.ms >= 0.0 and sp.counts is None     # still timed


def test_profiler_ranges_only_under_a_profiler(monkeypatch):
    tr = Tracer()
    opened = []
    real = perf.record_function

    def counting(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(perf, "record_function", counting)
    _frame(tr, "engine.soup")
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(tr, "engine.soup", "engine.launch")
    assert opened == ["rtvb.engine.frame", "rtvb.engine.soup",
                      "rtvb.engine.launch"]
    names = {e.name for e in prof.events()}
    assert {"rtvb.engine.frame", "rtvb.engine.soup",
            "rtvb.engine.launch"} <= names
    _frame(tr, "engine.soup")
    assert len(opened) == 3


@pytest.fixture(scope="module")
def engine():
    from rtvb_tpu_torch.render.renderer import Engine
    prev = TRACER.enabled
    TRACER.enabled = True
    TRACER.reset()
    eng = Engine(width=32, height=32, device="cpu")
    eng.set_camera(pos=(32.0, 14.0, 8.0), pitch=-0.9)
    yield eng
    TRACER.enabled = prev


def test_engine_frame_has_the_four_phases(engine):
    TRACER.reset()
    engine.render_realtime()
    rec = TRACER.records[-1]
    frame = rec.spans[-1]
    assert frame.name == "engine.frame"
    phases = [s.name for s in rec.spans if s.parent is frame]
    assert phases == ["engine.soup", "engine.stage", "engine.identity",
                      "engine.launch"]
    launch = rec.spans[-2]
    assert [s.name for s in rec.spans if s.parent is launch] == [
        "pathtrace", "denoise", "post"]
    # the CPU runs no stamps
    assert rec.device_ms is None and rec.gap_ms is None


def test_set_block_spans_and_bytes(engine):
    from rtvb_tpu_torch.assets import blocks as B
    from rtvb_tpu_torch.world import lighting, voxel
    TRACER.reset()
    hit, (x, y, z), n = engine.pick_block()
    assert hit
    engine.set_block(x + int(n[0]), y + int(n[1]), z + int(n[2]), B.BRICK)
    spans = {s.name: s for s in TRACER._record.spans}
    assert list(spans) == ["edit.pick", "edit.rebuild", "edit.upload",
                           "edit.soup"]
    tables, lights = engine._host_tables(), engine._host_lights()
    written = sum(np.asarray(tables[f]).nbytes
                  for f in voxel.VoxelWorld._fields) + sum(
        np.asarray(lights[f]).nbytes for f in lighting.LightTable._fields) \
        + engine._remap_host[1].nbytes
    assert spans["edit.upload"].counts == {"bytes": written}
    soup = engine._soup.buffers
    assert spans["edit.soup"].counts == {
        "bytes": sum(t.nbytes for t in soup)}
    assert engine.last_edit == {"host_ms": spans["edit.rebuild"].ms}
    engine.render_realtime()
    # the edit belongs to the frame that shows it
    assert {s.frame for s in TRACER.records[-1].spans} == {
        TRACER.records[-1].n}


def test_device_trace_holes_name_the_open_program_span():
    from rtvb_tpu_torch.tools import device_trace as DT
    ev = DT.Event
    events = [
        ev("rtvb.engine.frame", "range", 0, 100, 1),
        ev("rtvb.engine.stage", "range", 10, 30, 2),
        ev("rtvb.fn render/renderer.py:_stage", "range", 12, 20, 3),
        ev("aten::copy_", "op", 12, 14, 4),
        ev("aten::add", "op", 40, 42, 5),
        ev("k0", "kernel", 0, 11, 4),
        ev("k1", "kernel", 15, 16, 4),
        ev("k2", "kernel", 50, 60, 5),
        ev("k3", "kernel", 150, 160, 5),
        ev("k4", "kernel", 200, 210, 5),
    ]
    s = DT.summarize(events, 1)
    # the tool's own range (rtvb.fn ...) open at 16 names no hole
    assert [(round(h["ms"] * 1e3, 6), h["span"]) for h in s["holes"]] == [
        (90.0, "rtvb.engine.frame"), (40.0, DT.NO_SPAN),
        (34.0, "rtvb.engine.stage"), (4.0, "rtvb.engine.stage")]
