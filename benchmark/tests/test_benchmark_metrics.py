"""The metric arithmetic on synthetic spans and events: the window rate,
the 95th percentile over every sample, the busy union, stage attribution,
idle holes and the roofline share."""
import statistics
import types

import pytest

import benchpaths
from rtvbbench import devtrace as D
from rtvbbench import roofline, stats
from rtvbbench.spec import Benchmark


def test_percentile_over_all_samples():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2


def test_window_rate():
    assert stats.window_rate_ms(2.0, 40) == 50.0
    with pytest.raises(ValueError):
        stats.window_rate_ms(1.0, 0)


def test_spread():
    v = [10, 11, 12, 13, 14, 15]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / med


def ev(name, kind, s, e, corr=0, thread=1, cupti=0):
    return D.Event(name, kind, s, e, corr, thread, cupti)


def test_busy_union():
    assert D.interval_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert D.interval_union([]) == 0


def test_stage_attribution_by_correlation():
    events = [
        ev("rtvb.pathtrace", "range", 0, 10, corr=100),
        ev("aten::add", "op", 1, 2, corr=1),
        ev("cudaLaunchKernel", "runtime", 1.5, 1.8, corr=1, cupti=501),
        ev("rtvb.denoise", "range", 10, 20, corr=101),
        ev("aten::mul", "op", 11, 12, corr=2),
        ev("k_add", "kernel", 30, 34, corr=1, thread=0),   # after both
        ev("k_mul", "kernel", 35, 36, corr=0, thread=0, cupti=502),
        ev("cudaLaunchKernel", "runtime", 11.5, 11.7, corr=2, cupti=502),
    ]
    st = D.stage_ms(events, frames=1)
    assert st["rtvb.pathtrace"] == pytest.approx(4e-3)
    assert st["rtvb.denoise"] == pytest.approx(1e-3)


def test_replay_slice_and_gaps():
    roles = {"trace": types.SimpleNamespace(PATTERN=r"\btrace_kernel\b")}
    events = [
        ev("bench.slice", "range", 0, 100),
        ev("bench.enqueue", "range", 0, 5),
        ev("bench.sync", "range", 5, 60),
        ev("bench.click", "range", 60, 80),
        ev("void trace_kernel<1>(...)", "kernel", 10, 20),
        ev("elementwise", "kernel", 20, 50),
        ev("elementwise", "kernel", 85, 95),
        ev("outside", "kernel", 200, 300),
    ]
    r = D.summarize_replays(events, frames=2, roles=roles)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(50e-6)
    assert r["hand"]["trace"] == (pytest.approx(5e-3), 0.5)
    assert r["kernels_per_frame"] == 1.5
    assert r["top_ops"][0] == ["elementwise", pytest.approx(40e-6)]
    assert r["idle_gaps"] == [["sync", pytest.approx(35e-6)]]


def test_roofline():
    assert roofline.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 33.5e9) == pytest.approx(1.0)
    assert roofline.bound_ms(3.35e9, 67e9) == pytest.approx(2.0)
    assert roofline.roofline_share(0.5, 2.0) == 25.0
    assert roofline.roofline_share(0.5, 0.0) is None


def test_readers_on_synthetic_runs():
    b = Benchmark()
    sess = types.SimpleNamespace(
        window=(10.0, 12.0), intervals=[0.05] * 39 + [0.1],
        untraced=[0.0625] * 30,
        spans={"enqueue": [0.001, 0.003]}, counters={"captures": 0},
        window_frames=lambda: [0] * 40,
        window_clicks=lambda: [dict(due=1.0, seen=1.05, call_s=0.01,
                                    profiled=False, rebuild_ms=4.0)] * 20)
    replay = dict(frames=2, busy_s=0.1, window_s=0.125,
                  kernels_per_frame=100.0,
                  hand={"a": (2.0, 3.0), "b": (3.0, 2.0)})
    run = types.SimpleNamespace(sess=sess, setup_s=9.5, replay=replay,
                                extras=dict(stages={"rtvb.post": 1.5},
                                            bounds={"a": 1.0, "b": 0.5}))
    r = {m: b.reader(m).read(run) for m in (
        "frame_ms", "frame_ms_p95", "edit_ms_p95", "setup_s",
        "engine.enqueue_ms", "graph.captures", "edit.call_ms",
        "edit.rebuild_ms", "post.device_ms", "pathtrace.device_ms",
        "hand_kernels.device_ms", "hand_kernels_roofline",
        "torch_ops.kernels_per_frame", "torch_ops.device_ms",
        "device.idle_share")}
    assert r["frame_ms"] == pytest.approx(50.0)
    assert r["frame_ms_p95"] == pytest.approx(50.0)
    assert r["edit_ms_p95"] == pytest.approx(50.0)
    assert r["setup_s"] == 9.5
    assert r["engine.enqueue_ms"] == pytest.approx(2.0)
    assert r["graph.captures"] == 0
    assert r["edit.call_ms"] == pytest.approx(10.0)
    assert r["edit.rebuild_ms"] == 4.0
    assert r["post.device_ms"] == 1.5
    assert r["pathtrace.device_ms"] is None
    assert r["hand_kernels.device_ms"] == 5.0
    assert r["hand_kernels_roofline"] == pytest.approx(30.0)
    assert r["torch_ops.kernels_per_frame"] == 95.0
    assert r["torch_ops.device_ms"] == pytest.approx(45.0)
    assert r["device.idle_share"] == pytest.approx(20.0)
