"""The port's profiling tools (rtvb_tpu_torch/tools/) on the CPU:
* each tool's function runs with device="cpu" at a small output (64×36;
  device_trace one 64×64 frame) and returns its documented keys, every
  time finite and non-negative, no capture or replay (a graph needs a
  card), and each raises with device="cuda" where there is no card;
* device_trace's summariser on synthetic events: the interval union, the
  idle holes with the device work on either side, attribution through
  the correlation id to the innermost rtvb_tpu_torch frame of the Python
  stack (the kernel launcher transparent, not the host's time order),
  stages, the int64 share, and range mirrors left out of the sums;
* device_trace on a real CPU profile of one 64×64 eager frame (each op's
  own host time standing in for device time): the port functions group
  names functions in assets/textures.py and ops/rng.py;
* ablate_pt's `full` variant gives the engine's own path-trace stage's
  G-buffers to the bit, on a copy of the same state; the ablating
  variants change what they remove;
* the notex and nosky patches are restored, also when the variant
  raises;
* the replays' spread over captures as the reports print it, and
  chip_smoke's timing-tools process refusing to run without a card.
The JAX comparison of the variants: tests/test_torch_tools_jax.py."""
import copy
import json
import math

import pytest
import torch

from rtvb_tpu_torch import kernels as K
from rtvb_tpu_torch.assets import textures
from rtvb_tpu_torch.core.config import Settings
from rtvb_tpu_torch.render import pathtracer
from rtvb_tpu_torch.render import sky as sky_mod
from rtvb_tpu_torch.render.renderer import Engine
from rtvb_tpu_torch.tools import (ablate_pt, device_trace, micro_post,
                                  micro_pt, profile_frame, timing)
from rtvb_tpu_torch.tools.device_trace import Event, summarize

torch.set_num_threads(2)

OUT_W, OUT_H = 64, 36


def check_times(result, path: str = "") -> None:
    """Raise unless every number under result (dicts and lists walked)
    whose key ends in "_ms" or "_s" is None or finite and non-negative (a
    difference, "_delta_ms", may be negative)."""
    if isinstance(result, dict):
        for k, v in result.items():
            where = f"{path}.{k}" if path else str(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and str(k).endswith(("_ms", "_s")):
                if not math.isfinite(v) or (
                        v < 0.0 and not str(k).endswith("_delta_ms")):
                    raise ValueError(f"{where}: time {v}")
            else:
                check_times(v, where)
    elif isinstance(result, (list, tuple)):
        for i, v in enumerate(result):
            check_times(v, f"{path}[{i}]")


# ---------------------------------------------------------------------------
# each tool on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_trace():
    """device_trace of one eager 64×64 frame on the CPU."""
    return device_trace.device_trace("cpu", 1.0, frames=1, width=64,
                                     height=64)


def test_device_trace_runs_on_cpu(cpu_trace):
    res = cpu_trace
    assert {"device", "card", "scale", "internal", "output", "build",
            "frames", "eager", "launches", "replay", "note"} <= set(res)
    assert res["device"] == "cpu" and res["card"] is None
    assert res["replay"] is None and res["build"] == {}
    e = res["eager"]
    assert e["times"] == "host (CPU)"
    for key in ("by_kernel", "by_op", "by_function", "by_stage", "copies",
                "holes", "stages", "hand_kernels", "runtime_calls"):
        assert key in e
    assert set(e["stages"]) == set(device_trace.STAGE_NAMES)
    assert all(st["ranges"] == 1 for st in e["stages"].values())
    assert e["device_kernels_per_frame"] > 1000
    assert 0.0 < e["int64_share"] < 1.0
    assert e["function_share"] > 0.95
    check_times(res)


def test_device_trace_cpu_profile_names_port_functions(cpu_trace):
    funcs = {r["name"]: r for r in cpu_trace["eager"]["by_function"]}
    tex = [f for f in funcs if f.startswith("assets/textures.py:")]
    rng = [f for f in funcs if f.startswith("ops/rng.py:")]
    assert tex and rng, sorted(funcs)[:40]
    assert "assets/textures.py:_sample_scale_plain" in funcs
    assert all(funcs[f]["ms_per_frame"] >= 0.0 for f in tex + rng)
    # every stage's ops carry the stage; the post stage is the cheapest
    stages = {r["name"]: r for r in cpu_trace["eager"]["by_stage"]}
    assert set(device_trace.STAGE_NAMES) <= set(stages)


def test_profile_frame_runs_on_cpu():
    res = profile_frame.profile_frame("cpu", 2.0 / 3.0, OUT_W, OUT_H,
                                      n_eager=1, n_replay=1)
    assert res["internal"] == [42, 24] and res["output"] == [OUT_W, OUT_H]
    assert list(res["stages"]) == list(profile_frame.STAGES)
    for t in res["stages"].values():
        assert t["capture_ms"] is None and t["replay_ms"] is None
        assert t["first_call_ms"] > 0.0 and t["eager_ms"] > 0.0
    check_times(res)


def test_ablate_pt_runs_on_cpu():
    res = ablate_pt.ablate_pt("cpu", 2.0 / 3.0, ablate_pt.VARIANTS, OUT_W,
                              OUT_H, n_eager=1)
    assert list(res["variants"]) == list(ablate_pt.VARIANTS)
    for t in res["variants"].values():
        assert t["replay_ms"] is None and t["replay_delta_ms"] is None
        assert t["eager_ms"] > 0.0
        assert math.isfinite(t["eager_delta_ms"])
    assert res["variants"]["full"]["eager_delta_ms"] == 0.0
    check_times(res)


def test_micro_pt_runs_on_cpu():
    res = micro_pt.micro_pt("cpu", OUT_W, OUT_H, n_eager=1)
    assert res["shape"] == [OUT_H, OUT_W]
    assert len(res["pieces"]) == 14          # 13 and K2 on the soup
    assert any(k.startswith("entity intersect K2") for k in res["pieces"])
    assert res["sizes"]["soup_rows"] > 0
    for t in res["pieces"].values():
        assert t["eager_ms"] > 0.0 and t["replay_ms"] is None
    check_times(res)


def test_micro_post_main_on_cpu(tmp_path, capsys):
    path = tmp_path / "post.json"
    assert micro_post.main(["--device", "cpu", "--width", str(OUT_W),
                            "--height", str(OUT_H), "--json",
                            str(path)]) == 0
    res = json.loads(path.read_text())
    assert res["shape"] == [16, 32] and res["output"] == [OUT_H, OUT_W]
    assert list(res["pieces"]) == ["auto_exposure", "bloom", "lens_flare",
                                   "vignette", "tone_map", "easu (K7)",
                                   "sharpen", "full run()"]
    assert "micro_post to 64x36" in capsys.readouterr().out
    check_times(res)


def test_ablate_pt_main_refuses_unknown_variants():
    with pytest.raises(SystemExit):
        ablate_pt.main(["--device", "cpu", "full", "nothing"])


@pytest.mark.parametrize("tool", ["device_trace", "profile_frame",
                                  "ablate_pt", "micro_pt", "micro_post"])
def test_tools_need_a_card_for_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    fn = {"device_trace": device_trace.device_trace,
          "profile_frame": profile_frame.profile_frame,
          "ablate_pt": ablate_pt.ablate_pt, "micro_pt": micro_pt.micro_pt,
          "micro_post": micro_post.micro_post}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()


def test_time_piece_on_cpu_has_no_graph():
    calls = []
    t = timing.time_piece(lambda: calls.append(1), "cpu", n_eager=2)
    assert len(calls) == 1 + 1 + 2       # first call, warm-up, timed
    assert t["capture_ms"] is None and t["replay_ms"] is None
    assert t["replay_ms_by_capture"] == []
    check_times(t)


def test_fmt_spread_names_the_captures():
    assert timing.fmt_spread({"replay_ms_by_capture": [26.7, 23.85, 26.6]}) \
        == "23.850-26.700 over 3 captures"
    assert timing.fmt_spread({"replay_ms_by_capture": []}) == ""
    assert timing.fmt_spread({"replay_ms": None}) == ""


def test_chip_smoke_timing_tools_need_a_card(tmp_path):
    """The timing tools' own process (`chip_smoke.py --timing-tools`)
    exits 2 and writes nothing where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run on it")
    import chip_smoke
    path = tmp_path / "t.json"
    assert chip_smoke.timing_tools(str(path)) == 2
    assert not path.exists()


def test_check_times_refuses_bad_times():
    check_times({"a_ms": 0.0, "b": {"c_s": None}, "n": -1,
                        "d_delta_ms": -2.0})
    for bad in ({"a_ms": -1.0}, {"x": [{"b_s": float("nan")}]},
                {"c_ms": float("inf")}, {"d_delta_ms": float("nan")}):
        with pytest.raises(ValueError):
            check_times(bad)


# ---------------------------------------------------------------------------
# device_trace's summariser on synthetic events
# ---------------------------------------------------------------------------

def test_interval_union():
    assert timing.interval_union([]) == 0.0
    assert timing.interval_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert timing.interval_union([(4, 5), (0, 1)]) == 2.0


def _synthetic():
    """Ops in their callers' ranges under the path-trace range and the
    denoiser's, a hand kernel's launch range; device work launched out of
    host order."""
    P = Event
    return [
        P("rtvb.pathtrace", "range", 0, 100, corr=1),
        P("rtvb.fn ops/rng.py:pcg_hash", "range", 3, 10, corr=3),
        P("aten::bitwise_and", "op", 4, 6, corr=11,
          dtypes=("long int", "Scalar")),
        P("rtvb.fn assets/textures.py:sample_scale", "range", 12, 20,
          corr=4),
        # a composite op: its kernel links to the innermost op
        P("aten::meshgrid", "op", 12.5, 19, corr=5, dtypes=("float",)),
        P("aten::mul", "op", 13, 15, corr=12, dtypes=("float", "float")),
        P("rtvb.kernel.trace ops/dda.py:trace_cuda", "range", 42, 58,
          corr=13),
        P("rtvb.denoise", "range", 100, 200, corr=2),
        P("aten::add", "op", 110, 112, corr=21, dtypes=("float", "float")),
        P("aten::copy_", "op", 120, 125, corr=22,
          dtypes=("float", "float", "")),
        P("rtvb.kernel.atrous None", "range", 130, 140, corr=23),
        P("cudaLaunchKernel", "runtime", 4.5, 5.5, corr=11),
        # device work: the mirrors of the ranges and the tracer's own
        # buffer requests are no work
        P("rtvb.pathtrace", "mirror", 300, 700),
        P("Activity Buffer Request", "overhead", 400, 680),
        P("void trace_kernel<false>(Rays, Tables, World, Record)", "kernel",
          300, 400, corr=13),
        P("elementwise_kernel<bitwise_and>", "kernel", 420, 450, corr=11),
        P("elementwise_kernel<mul>", "kernel", 440, 460, corr=12),
        P("elementwise_kernel<add>", "kernel", 560, 570, corr=21),
        P("Memcpy DtoD (Device -> Device)", "memcpy", 600, 610, corr=22),
        P("stray_kernel", "kernel", 700, 705, corr=99),
        # a kernel whose op id was lost: its runtime call's stands in
        P("cudaLaunchKernel", "runtime", 5, 5.2, corr=11, cupti=501),
        P("elementwise_kernel<bitwise_and>", "kernel", 710, 720,
          cupti=501),
        # a host event without an id claims nothing
        P("some host event", "op", 130, 131),
        P("lost_kernel", "kernel", 730, 731),
    ]


def test_summarize_attributes_through_correlation():
    s = summarize(iter(_synthetic()), frames=1)
    fn = {r["name"]: r["ms_per_frame"] * 1e3 for r in s["by_function"]}
    assert fn == {"ops/rng.py:pcg_hash": 30.0 + 10.0,   # one relinked
                  # the mul inside a composite op, called from here
                  "assets/textures.py:sample_scale": 20.0,
                  "ops/dda.py:trace_cuda": 100.0,
                  # the add, the copy, the stray and the lost kernel
                  device_trace.OUTSIDE: 26.0}
    ops = {r["name"]: r["ms_per_frame"] * 1e3 for r in s["by_op"]}
    assert ops["aten::bitwise_and(long int, Scalar)"] == 40.0
    assert ops["rtvb.kernel.trace"] == 100.0
    assert ops[device_trace.NO_OP] == 6.0
    assert "some host event" not in ops
    kern = {r["name"]: r["count"] for r in s["by_kernel"]}
    assert "Memcpy DtoD (Device -> Device)" not in kern   # apart
    assert [r["name"] for r in s["copies"]] == [
        "Memcpy DtoD (Device -> Device) ← aten::copy_(float, float)"]
    assert s["hand_kernels"]["trace"] == dict(count=1, ms_per_frame=0.1)
    assert s["hand_kernels"]["tri"]["count"] == 0
    st = {r["name"]: r["ms_per_frame"] * 1e3 for r in s["by_stage"]}
    assert st == {"rtvb.pathtrace": 160.0, "rtvb.denoise": 20.0,
                  device_trace.NO_STAGE: 6.0}
    assert s["stages"]["rtvb.pathtrace"]["host_ms"] == 0.1
    assert s["stages"]["rtvb.pathtrace"]["device_busy_ms"] == \
        pytest.approx(0.15)
    assert s["int64_share"] == pytest.approx(40.0 / 186.0)
    assert s["function_share"] == pytest.approx(160.0 / 186.0)
    assert s["runtime_calls"]["cudaLaunchKernel"]["per_frame"] == 2.0


def test_summarize_leaves_mirrors_out_and_finds_holes():
    s = summarize(_synthetic(), frames=1)
    # the mirror (300-700) would make the device busy 400 µs, the
    # buffer request 380
    assert s["device_busy_ms"] * 1e3 == pytest.approx(
        100 + 40 + 10 + 10 + 5 + 10 + 1)
    assert s["device_ms_per_frame"] * 1e3 == pytest.approx(186.0)
    assert s["device_kernels_per_frame"] == 8 and s["kernels_per_frame"] == 7
    assert s["device_span_ms"] * 1e3 == pytest.approx(431.0)
    holes = s["holes"]
    assert [round(h["ms"] * 1e3, 6) for h in holes] == [100.0, 90.0, 30.0,
                                                       20.0, 10.0, 5.0]
    first = holes[0]
    assert first["before"].startswith("elementwise_kernel<mul>")
    assert first["before"].endswith("[assets/textures.py:sample_scale]")
    assert first["after"].startswith("elementwise_kernel<add>")
    assert holes[1]["before"].startswith("Memcpy DtoD")
    assert holes[1]["after"].startswith("stray_kernel")


def test_summarize_windows_keep_holes_and_spans_apart():
    """With windows, the span is their sum and no hole or device span
    runs from one window into the next."""
    P = Event
    ev = [P("aten::add", "op", 0, 5, corr=1, dtypes=("float", "float")),
          P("aten::mul", "op", 1000, 1005, corr=2,
            dtypes=("float", "float")),
          P("k_add", "kernel", 10, 20, corr=1),
          P("k_add", "kernel", 50, 60, corr=1),
          P("k_mul", "kernel", 1010, 1040, corr=2)]
    s = summarize(ev, frames=2, windows=[(0, 100), (1000, 1100)])
    assert s["span_ms"] * 1e3 == pytest.approx(200.0)
    assert s["device_span_ms"] * 1e3 == pytest.approx(50.0 + 30.0)
    assert [round(h["ms"] * 1e3, 6) for h in s["holes"]] == [30.0]
    assert s["device_busy_ms"] * 1e3 == pytest.approx(50.0)
    one = summarize(ev, frames=2)        # one window: the gap is a hole
    assert [round(h["ms"] * 1e3, 6) for h in one["holes"]] == [950.0, 30.0]
    assert one["device_span_ms"] * 1e3 == pytest.approx(1030.0)


def test_profile_interleaved_splits_the_windows_on_cpu():
    """Eager frames and 'replays' in turns in one profile: each summary
    holds its own window's work only, the eager one with its callers
    named and its stages, and the launch counts are the eager frames'."""
    eng = device_trace.shipped_engine("cpu", 64, 36)
    eng._eager_frame()
    x = torch.arange(16.0)
    eager, replay, counts = device_trace.profile_interleaved(
        eng._eager_frame, lambda: torch.cumsum(x, 0), 2, "cpu")
    assert eager["frames"] == replay["frames"] == 2
    assert eager["stages"]["rtvb.pathtrace"]["ranges"] == 2
    assert replay["stages"] == {}
    funcs = {r["name"] for r in eager["by_function"]}
    assert "assets/textures.py:_sample_scale_plain" in funcs
    assert [r["name"] for r in replay["by_function"]] == [
        device_trace.OUTSIDE]
    assert "aten::cumsum" in {r["name"].split("(")[0]
                              for r in replay["by_op"]}
    assert replay["device_kernels_per_frame"] <= 4 < \
        eager["device_kernels_per_frame"]
    assert 0.0 < replay["span_ms"] < eager["span_ms"]
    assert set(counts) == set(K.ALL) and not any(counts.values())
    check_times(eager)
    check_times(replay)


def test_summarize_host_times_use_own_time():
    """On the CPU an op's own time (less its child ops') is its 'device'
    time: a composite op's children are not counted twice."""
    P = Event
    ev = [P("rtvb.post", "range", 0, 50, corr=1),
          P("rtvb.fn render/postprocess.py:vignette", "range", 1, 40,
            corr=5),
          P("aten::to", "op", 2, 12, corr=2, dtypes=("long int",)),
          P("aten::copy_", "op", 3, 11, corr=3, dtypes=("float",
                                                       "long int")),
          P("aten::mul", "op", 20, 25, corr=4, dtypes=("float", "float"))]
    s = summarize(ev, frames=2, device_times=False)
    ops = {r["name"]: r["ms_per_frame"] * 1e3 for r in s["by_op"]}
    assert ops == {"aten::to(long int)": 1.0,
                   "aten::copy_(float, long int)": 4.0,
                   "aten::mul(float, float)": 2.5}
    assert s["device_ms_per_frame"] * 1e3 == pytest.approx(7.5)
    assert s["device_busy_ms"] * 1e3 == pytest.approx(15.0)  # 2-12, 20-25
    assert [r["name"] for r in s["by_function"]] == [
        "render/postprocess.py:vignette"]
    assert s["int64_share"] == pytest.approx(10.0 / 15.0)
    assert s["times"] == "host (CPU)"


class _Kineto:
    """The accessors of a raw kineto event that events_from_kineto reads."""

    def __init__(self, name, cuda, start, dur, corr=0, linked=0,
                 dtypes=(), thread=1):
        from torch.autograd import DeviceType
        self._v = (name, DeviceType.CUDA if cuda else DeviceType.CPU,
                   start, dur, corr, linked, list(dtypes), thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def dtypes(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[7]


def test_events_from_kineto_kinds():
    raw = [_Kineto("aten::mul", False, 1000, 2000, corr=7,
                   dtypes=("float", "")),
           _Kineto("rtvb.denoise", False, 0, 9000, corr=3),
           _Kineto("cudaLaunchKernel", False, 1500, 100, corr=40, linked=7),
           _Kineto("vectorized_elementwise_kernel", True, 5000, 500,
                   corr=40, linked=7),
           _Kineto("rtvb.denoise", True, 4000, 3000, linked=3),
           _Kineto("Activity Buffer Request", True, 4000, 9000),
           _Kineto("Memcpy HtoD (Pinned -> Device)", True, 100, 10,
                   linked=9),
           _Kineto("Memset (Device)", True, 200, 10, linked=9)]
    evs = list(device_trace.events_from_kineto(raw))
    assert [e.kind for e in evs] == ["op", "range", "runtime", "kernel",
                                     "mirror", "overhead", "memcpy",
                                     "memset"]
    assert evs[0] == Event("aten::mul", "op", 1.0, 3.0, 7, ("float", ""), 1)
    assert evs[2].corr == evs[3].corr == 7       # linked to the op
    assert evs[2].cupti == evs[3].cupti == 40    # and to each other
    s = summarize(evs, frames=1)
    assert s["device_busy_ms"] * 1e3 == pytest.approx(0.5 + 0.01 + 0.01)
    assert s["by_op"][0]["name"] == "aten::mul(float)"


def test_summarize_attributes_a_launch_no_op_made():
    """A hand kernel's launch comes from ctypes, so no op links its CUDA
    runtime call or its kernel: the call takes its function, op key and
    stage from the host ranges around it, and the kernel the call's
    through their shared CUDA correlation id."""
    raw = [_Kineto("rtvb.pathtrace", False, 0, 50000, corr=1),
           _Kineto("rtvb.kernel.proctex assets/textures.py:_proctex_cuda",
                   False, 1000, 2000, corr=2),
           _Kineto("cudaLaunchKernel", False, 1500, 100, corr=41),
           _Kineto("void (anonymous namespace)::proctex_kernel<true>(int)",
                   True, 60000, 90000, corr=41),
           # the same outside every range: no function, no stage
           _Kineto("cuLaunchKernel", False, 70000, 100, corr=42),
           _Kineto("stray_kernel", True, 200000, 10000, corr=42)]
    evs = list(device_trace.events_from_kineto(raw))
    assert [(e.kind, e.corr, e.cupti) for e in evs[2:]] == [
        ("runtime", 0, 41), ("kernel", 0, 41), ("runtime", 0, 42),
        ("kernel", 0, 42)]
    s = summarize(evs, frames=1)
    fn = {r["name"]: r["ms_per_frame"] * 1e3 for r in s["by_function"]}
    assert fn == {"assets/textures.py:_proctex_cuda": 90.0,
                  device_trace.OUTSIDE: 10.0}
    ops = {r["name"]: r["ms_per_frame"] * 1e3 for r in s["by_op"]}
    assert ops == {"rtvb.kernel.proctex": 90.0, device_trace.NO_OP: 10.0}
    st = {r["name"]: r["ms_per_frame"] * 1e3 for r in s["by_stage"]}
    assert st == {"rtvb.pathtrace": 90.0, device_trace.NO_STAGE: 10.0}
    assert s["hand_kernels"]["proctex"] == dict(count=1, ms_per_frame=0.09)
    assert s["function_share"] == pytest.approx(0.9)
    assert s["runtime_calls"]["cudaLaunchKernel"]["per_frame"] == 1.0
    assert s["span_ms"] * 1e3 == pytest.approx(50.0)


def test_port_caller_outside_the_port_and_launch_restored():
    import sys
    assert device_trace.port_caller(sys._getframe()) is None
    launch = device_trace.K.CudaKernel.launch
    with pytest.raises(ZeroDivisionError):
        with device_trace.port_ranges():
            assert device_trace.K.CudaKernel.launch is not launch
            1 / 0
    assert device_trace.K.CudaKernel.launch is launch


def test_port_ranges_name_each_call_in_a_profile():
    from torch.profiler import ProfilerActivity, profile
    from rtvb_tpu_torch.assets import textures as tex
    u = torch.rand(4, 4)
    tid = torch.zeros(4, 4, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with device_trace.port_ranges():
            tex.sample_scale(tid, u, u, u)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "rtvb.fn assets/textures.py:_sample_scale_plain" in names
    assert "rtvb.fn assets/textures.py:lattice" in names
    assert "rtvb.fn ops/rng.py:pcg_hash" in names


# ---------------------------------------------------------------------------
# ablate_pt's variants and patches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_after_a_frame():
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": 64, "render_height": 64}), device="cpu")
    eng.render_realtime()          # live reservoirs and histories
    return eng


def _planes(g):
    out = [g.depth, g.roughness, g.motion_u, g.motion_v, g.emissive_first]
    for name in ("illum", "albedo", "normal"):
        out += list(getattr(g, name))
    return out


def test_ablate_full_is_the_engines_path_trace(engine_after_a_frame):
    eng = engine_after_a_frame
    twin = copy.copy(eng)
    g_eng, r_eng = eng.render_gbuffers()
    run = ablate_pt.variant_trace_fn(twin, "full")
    g_full, r_full = run(*ablate_pt.trace_args(twin, twin.restir_state))
    for a, b in zip(_planes(g_eng), _planes(g_full)):
        assert torch.equal(a, b)
    assert torch.equal(r_eng.data, r_full.data)


@pytest.mark.parametrize("variant,changed", [
    ("norestir", "illum"), ("noent", "illum albedo normal depth"),
    ("loc2", "illum"), ("b2", "illum"), ("b1", "illum"),
    ("nosky", "illum"),
    # the shipped scene has no local light, and an authored image replaces
    # the procedural texture of every material that has one: both leave
    # the G-buffers to the bit
    ("nolocal", ""), ("notex", "")])
def test_ablate_variants_change_what_they_remove(engine_after_a_frame,
                                                 variant, changed):
    eng = engine_after_a_frame
    args = ablate_pt.trace_args(eng, eng.restir_state)
    g_full, _ = ablate_pt.variant_trace_fn(eng, "full")(*args)
    with ablate_pt.patched(variant):
        g_var, r_var = ablate_pt.variant_trace_fn(eng, variant)(*args)
    assert (r_var is None) == (variant == "norestir")
    for name in ("illum", "albedo", "normal", "depth"):
        a, b = getattr(g_full, name), getattr(g_var, name)
        a, b = (torch.stack(a), torch.stack(b)) if name != "depth" \
            else (a, b)
        assert torch.isfinite(b).all() or name == "depth"
        assert torch.equal(a, b) == (name not in changed.split()), name


def test_ablate_patches_are_restored():
    originals = (textures.sample_scale, textures.sample_normal_delta,
                 sky_mod.sky_radiance)
    u = torch.rand(4, 4)
    tid = torch.zeros(4, 4, dtype=torch.int32)
    with ablate_pt.patched("notex"):
        assert textures.sample_scale is not originals[0]
        assert textures.sample_normal_delta is not originals[1]
        assert sky_mod.sky_radiance is originals[2]
        assert torch.equal(textures.sample_scale(tid, u, u, u),
                           torch.ones_like(u))
        assert not textures.sample_normal_delta(tid, u, u, u)[0].any()
    with pytest.raises(ZeroDivisionError):
        with ablate_pt.patched("nosky"):
            assert sky_mod.sky_radiance is not originals[2]
            1 / 0
    assert (textures.sample_scale, textures.sample_normal_delta,
            sky_mod.sky_radiance) == originals


def test_ablate_restores_patches_when_the_variant_raises(monkeypatch):
    originals = (textures.sample_scale, sky_mod.sky_radiance)
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": 32, "render_height": 32}), device="cpu")

    def broken(*a, **k):
        raise RuntimeError("variant failed")
    monkeypatch.setattr(pathtracer, "render_frame", broken)
    for variant in ("notex", "nosky"):
        with pytest.raises(RuntimeError, match="variant failed"):
            ablate_pt.ablate_pt("cpu", 1.0, (variant,), engine=eng)
        assert (textures.sample_scale, sky_mod.sky_radiance) == originals
    with pytest.raises(ValueError, match="unknown variant"):
        ablate_pt.variant_trace_fn(eng, "nothing")
