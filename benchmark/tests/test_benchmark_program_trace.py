"""The readers of the program's own trace (rtvbbench/program_trace.py) on
synthetic tracer records (a stand-in for the loaded port's tracer) and
session frames: the filter to the window's frames and clicks before the
profiled slice, `<name>.half` read by the base reader, None without
stamps, without a tracer (the parent program) or without a window."""
import sys
import types

import pytest

import benchpaths
from rtvbbench.spec import Benchmark

NS = 1_000_000_000


def span(name, t0_s, ms, counts=None):
    s = types.SimpleNamespace(name=name, t0=int(t0_s * NS),
                              t1=int(t0_s * NS + ms * 1e6), counts=counts)
    s.ms = ms
    return s


def frame(t0_s, spans=(), device=None, gap=None, soup_ms=1.0):
    """A frame record at t0_s: `spans` before it (clicks), its phases and
    its engine.frame span of 5 ms."""
    return types.SimpleNamespace(
        spans=list(spans) + [span("engine.soup", t0_s + 1e-4, soup_ms),
                             span("engine.launch", t0_s + 2e-3, 2.0),
                             span("engine.frame", t0_s, 5.0)],
        device_ms=device, gap_ms=gap)


def stamps(pt):
    return dict(pathtrace=pt, denoise=3.0, post=2.0, writeback=0.1,
                frame=pt + 5.1)


def run_of(t0=10.0, untraced=(0.05,) * 4):
    sess = types.SimpleNamespace(t0=t0, untraced=list(untraced), eng=None)
    return types.SimpleNamespace(sess=sess, setup_s=1.0, replay=None,
                                 extras=None)


@pytest.fixture
def port(monkeypatch):
    """port(records): the loaded port's tracer holds `records`; port(None):
    a port without a tracer."""
    from rtvbbench import program_trace

    def load(records):
        mod = types.SimpleNamespace() if records is None else \
            types.SimpleNamespace(
                TRACER=types.SimpleNamespace(records=records))
        monkeypatch.setitem(sys.modules, program_trace.PORT_TRACER[0], mod)
    return load


def synthetic():
    """Warm-up frame at 9.9 s, four untraced window frames at 10.0–10.15
    s (the second with a click before it), a profiled frame at 10.21 s
    with a click of its own: only the four and their click count."""
    click = [span("edit.pick", 10.04, 2.0),
             span("edit.rebuild", 10.043, 7.0),
             span("edit.upload", 10.051, 1.5, {"bytes": 1000}),
             span("edit.soup", 10.053, 0.5, {"bytes": 24})]
    late = [span("edit.pick", 10.205, 9.0),
            span("edit.upload", 10.207, 9.0, {"bytes": 99999})]
    return [frame(9.9, device=stamps(99.0), gap=9.0, soup_ms=9.0),
            frame(10.0, device=stamps(20.0), gap=None),
            frame(10.05, click, device=stamps(22.0), gap=2.0, soup_ms=3.0),
            frame(10.1, device=stamps(24.0), gap=1.0),
            frame(10.15, device=None, gap=None),       # dropped stamps
            frame(10.21, late, device=stamps(99.0), gap=9.0, soup_ms=9.0)]


def read(name, run):
    return Benchmark().reader(name).read(run)


def test_readers_filter_to_the_untraced_window(port):
    port(synthetic())
    run = run_of()
    assert read("engine.soup_ms", run) == pytest.approx(1.5)
    assert read("engine.launch_ms", run) == pytest.approx(2.0)
    assert read("engine.stage_ms", run) is None        # no such span
    assert read("pathtrace.replay_ms", run) == pytest.approx(22.0)
    assert read("denoise.replay_ms", run) == pytest.approx(3.0)
    assert read("post.replay_ms", run) == pytest.approx(2.0)
    assert read("device.gap_ms", run) == pytest.approx(1.5)
    assert read("edit.pick_ms", run) == pytest.approx(2.0)
    assert read("edit.upload_ms", run) == pytest.approx(1.5)
    assert read("edit.soup_ms", run) == pytest.approx(0.5)
    assert read("edit.upload_bytes", run) == pytest.approx(1024.0)


@pytest.mark.parametrize("name", [
    "engine.soup_ms", "engine.stage_ms", "engine.identity_ms",
    "engine.launch_ms", "pathtrace.replay_ms", "denoise.replay_ms",
    "post.replay_ms", "device.gap_ms"])
def test_half_is_read_by_the_base_reader(port, name):
    b = Benchmark()
    assert b.reader(name + ".half").__doc__ == b.reader(name).__doc__
    port(synthetic())
    run = run_of()
    assert b.reader(name + ".half").read(run) == b.reader(name).read(run)
    for m in b.spec["per_layer"]:
        if m["name"] in (name, name + ".half"):
            assert m["source"] == "program_span"


def test_none_without_stamps_or_tracer_or_window(port):
    port([frame(10.0 + 0.05 * k) for k in range(4)])
    run = run_of()
    for name in ("pathtrace.replay_ms", "denoise.replay_ms",
                 "post.replay_ms", "device.gap_ms"):
        assert read(name, run) is None
    assert read("engine.soup_ms", run) == pytest.approx(1.0)
    assert read("edit.upload_bytes", run) is None       # no edit
    names = ("engine.soup_ms", "pathtrace.replay_ms", "device.gap_ms",
             "edit.pick_ms", "edit.upload_bytes")
    port(synthetic())
    for name in names:
        assert read(name, run_of(untraced=())) is None
    port(None)                                # the parent program
    for name in names:
        assert read(name, run) is None
