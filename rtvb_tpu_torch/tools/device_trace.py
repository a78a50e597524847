"""Device time of the real-time frame, from torch.profiler: the port's
counterpart of the JAX package's tools/device_trace.py.

    python -m rtvb_tpu_torch.tools.device_trace [--scale S] [--frames N]
        [--width W] [--height H] [--device cuda|cpu] [--json PATH]

Profiles N eager frames (`Engine._eager_frame`, op by op; default 3) with
the ops' shapes, and groups the device time a frame four ways: (a) by
kernel name, (b) by the launching op and its dtypes
(`aten::bitwise_and(long int, Scalar)`: what an int64 op costs), (c) by
the innermost function of rtvb_tpu_torch on the Python stack of the call
that launched it (`assets/textures.py:sample_scale`) and (d) by the
frame's stage ranges (`renderer.STAGES`).  A device event is attributed
through the profiler's correlation, the launching op's id, and never by
the time order of host ranges; a hand kernel, which no op launches,
through its CUDA runtime call's id to that call, and the call by the
host ranges around it, as an op is.  The Python stack is read where the
call is made: during the profile each torch call of the frame and each hand
kernel's launch runs inside a range named by its innermost port function
(`port_ranges`: a TorchFunctionMode, and `CudaKernel.launch` wrapped),
since the profiler's own stacks (`with_stack`) reach its event list in
some torch versions only (not in the card's 2.11).  Also: the window's
wall span and the device's busy share, device ops a frame, the largest
idle holes with the device ops on either side, and the copies and
memsets apart (the JAX tool's async copies); each hole also names the
innermost program span (the engine's tracer, `utils/perf.py`: a range
`rtvb.<span>` under a profiler) open on the host at its start.  Beside
it, N replays of
the captured frame, in turns with the eager frames in the same profile
(`profile_interleaved`): the device busy ms and kernels a frame that
the eager attribution must account for (a replay's kernels correlate to
one graph launch, not to the ops that captured them).  In turns, since
two profiles taken apart can time the same kernels some percent apart.

Naming each call makes the eager frame bound by the host, so the device
waits between ops: the kernels' own durations hold, the holes and the
busy share do not (the replays' do).  On the CPU (`--device cpu`) each
op's own host time (less its child ops') stands in for device time;
those numbers are the host's, never a device's.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import heapq
import os
import re
import sys
import time
from typing import NamedTuple

from torch.overrides import TorchFunctionMode
from torch.profiler import record_function

from .. import kernels as K
from . import timing

STAGE_NAMES = ("rtvb.pathtrace", "rtvb.denoise", "rtvb.post")
FN_RANGE = "rtvb.fn "            # + the caller: a torch call's range
KERNEL_RANGE = "rtvb.kernel."     # + name, " ", the caller: a launch's
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames that name no caller: the launcher every hand kernel shares, and
# the tools themselves
SKIPPED = (os.path.join(PKG_DIR, "kernels.py"),
           os.path.join(PKG_DIR, "tools") + os.sep)
OUTSIDE = "(outside rtvb_tpu_torch)"
NO_OP = "(no op)"
NO_STAGE = "(outside the stages)"
# the windows of one profile that interleaves eager frames and replays
EAGER_WINDOW = "rtvb.window.eager"
REPLAY_WINDOW = "rtvb.window.replay"
# ranges of this tool's own, not the program's spans
TOOL_RANGES = (FN_RANGE, KERNEL_RANGE, "rtvb.window.")
NO_SPAN = "(no span)"
# a hand kernel's CUDA function, by its registry name in kernels.ALL
HAND_KERNELS = {
    "trace": r"\btrace_kernel\b", "tri": r"\btri_kernel\b",
    "texture": r"\btexture_kernel\b", "shade": r"\bshade_kernel\b",
    "warp": r"\bwarp_(nearest|bilinear)_kernel\b",
    "atrous": r"\batrous_kernel\b", "easu": r"\beasu_kernel\b",
    "proctex": r"\bproctex_kernel\b"}
HOST_BOUND_NOTE = (
    "eager frames with each call named are bound by the host: each "
    "kernel's duration holds, the holes and the busy share do not; the "
    "replay profile gives the device's own busy ms")
_CALLERS: dict = {}      # code object → "path:function" or None
# device events of the tracer itself (CUPTI's overhead activities)
TRACER_OVERHEAD = ("Activity Buffer Request", "Activity Buffer Flush",
                   "Buffer Flush", "CUPTI Overhead")
# a CUDA API call on the host (cudaLaunchKernel,
# cuLaunchKernel, ...), which no op may have made: a hand kernel's launch
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


class Event(NamedTuple):
    """One profiler event.  kind: "op" (an aten op), "range" (a
    record_function range), "runtime" (a CUDA runtime call on the host),
    "kernel", "memcpy", "memset" (device work), "mirror" (a range's
    device mirror) or "overhead" (the tracer's own, as CUPTI's buffer
    requests): no work.  corr: an op's or a range's own correlation
    id; for device work and runtime calls, the id of the op that launched
    them (0: none recorded, as for a hand kernel's launch, which no op
    makes).  cupti: a runtime call's and its device work's shared CUDA
    correlation id, which links device work whose op id was lost, or
    never was, to the runtime call's."""
    name: str
    kind: str
    start_us: float
    end_us: float
    corr: int = 0
    dtypes: tuple = ()
    thread: int = 0
    cupti: int = 0


def events_from_kineto(raw):
    """Event for each raw kineto event (torch.profiler's
    `profiler.kineto_results.events()`), as they stream."""
    from torch.autograd import DeviceType
    for e in raw:
        name = e.name()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        annotation = name.startswith("rtvb.") or (
            hasattr(e, "is_user_annotation") and e.is_user_annotation())
        if e.device_type() == DeviceType.CPU:
            if name in TRACER_OVERHEAD:
                continue
            if annotation:
                kind, corr = "range", e.correlation_id()
            elif e.linked_correlation_id() > 0 or RUNTIME_CALL.match(name):
                kind, corr = "runtime", e.linked_correlation_id()
            else:
                kind, corr = "op", e.correlation_id()
            yield Event(name, kind, start, end, corr,
                        tuple(e.dtypes()) if kind == "op" else (),
                        e.start_thread_id(),
                        e.correlation_id() if kind == "runtime" else 0)
        else:
            if annotation:
                kind = "mirror"
            elif name in TRACER_OVERHEAD:
                kind = "overhead"
            elif name.startswith("Memcpy"):
                kind = "memcpy"
            elif name.startswith("Memset"):
                kind = "memset"
            else:
                kind = "kernel"
            yield Event(name, kind, start, end, e.linked_correlation_id(),
                        cupti=e.correlation_id())


def port_caller(frame):
    """The innermost frame of rtvb_tpu_torch from `frame` outwards, as
    'assets/textures.py:sample_scale'; None when no such frame is on the
    stack (the launcher and the tools name no caller)."""
    while frame is not None:
        code = frame.f_code
        name = _CALLERS.get(code, 0)
        if name == 0:
            path = os.path.abspath(code.co_filename)
            name = None
            if path.startswith(PKG_DIR + os.sep) and \
                    not path.startswith(SKIPPED):
                rel = os.path.relpath(path, PKG_DIR).replace(os.sep, "/")
                name = f"{rel}:{code.co_name}"
            _CALLERS[code] = name
        if name is not None:
            return name
        frame = frame.f_back
    return None


class _CallerRanges(TorchFunctionMode):
    """Each torch call in a range named by its innermost port caller."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        caller = port_caller(sys._getframe(1))
        if caller is None:
            return func(*args, **(kwargs or {}))
        with record_function(FN_RANGE + caller):
            return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def port_ranges():
    """Within: every torch call runs in a range `rtvb.fn <caller>` and
    every hand kernel's launch in `rtvb.kernel.<name> <caller>`, the
    caller being the innermost rtvb_tpu_torch function on the stack.
    `CudaKernel.launch` is restored on exit."""
    launch = K.CudaKernel.launch

    def named_launch(self, device, *args):
        caller = port_caller(sys._getframe(1))
        with record_function(f"{KERNEL_RANGE}{self.name} {caller}"):
            return launch(self, device, *args)
    K.CudaKernel.launch = named_launch
    try:
        with _CallerRanges():
            yield
    finally:
        K.CudaKernel.launch = launch


def op_key(name: str, dtypes: tuple) -> str:
    dtypes = [d for d in dtypes if d]
    return f"{name}({', '.join(dtypes)})" if dtypes else name


def _add(table: dict, key, us: float, n: int = 1):
    row = table.get(key)
    if row is None:
        table[key] = [n, us]
    else:
        row[0] += n
        row[1] += us


def _rows(table: dict, frames: int, top=None) -> list:
    rows = sorted(table.items(), key=lambda kv: -kv[1][1])
    if top is not None:
        rows = rows[:top]
    return [dict(name=k, count=c, per_frame=c / frames,
                 ms_per_frame=us / 1e3 / frames) for k, (c, us) in rows]


def summarize(events, frames: int, device_times: bool = True,
              top: int = 40, n_holes: int = 12, windows=None) -> dict:
    """Group the profile's events (an iterable of Event) by kernel name,
    by launching op and dtypes, by port function and by stage.  With
    device_times False (a CPU profile) each op's own host time, less its
    child ops', stands in for a device event at the op's interval.
    Times are ms a frame over `frames` frames.  windows: the sorted
    (start, end) µs of the windows the events were taken from (each
    ending in a synchronize), or None for one window: the span is the
    windows' sum and no hole or device span crosses from one to the
    next."""
    host = []
    device = []               # (device event, its ms in µs)
    runtime: dict = {}
    launched: dict = {}       # CUDA correlation id → the launching op's
    for ev in events:
        if ev.kind in ("op", "range"):
            host.append(ev)
        elif ev.kind == "runtime":
            _add(runtime, ev.name, ev.end_us - ev.start_us)
            if ev.corr and ev.cupti:
                launched[ev.cupti] = ev.corr
            elif ev.cupti:
                # no op made the call (a hand kernel's launch): its
                # context is the host ranges around it, as an op's is
                host.append(ev)
        elif ev.kind not in ("mirror", "overhead") and device_times:
            device.append((ev, ev.end_us - ev.start_us))
    # the host's nesting, per thread: each op's and range's context is
    # the innermost caller range and stage range around it
    host.sort(key=lambda e: (e.thread, e.start_us, -e.end_us))
    ctx: dict = {}            # corr → (op key, function, stage, int64)
    call_ctx: dict = {}       # CUDA correlation id of a call no op made
    #                           → the same
    stage_host: dict = {}     # stage → [ranges, host us]
    stack: list = []          # [event, function, stage, child op us, key]
    span = [None, None]

    def pop():
        ev, _, _, child_us, _ = stack.pop()
        if ev.kind == "op" and not device_times:
            dur = ev.end_us - ev.start_us
            device.append((ev._replace(kind="kernel"),
                           max(dur - child_us, 0.0)))
            for entry in reversed(stack):
                if entry[0].kind == "op":
                    entry[3] += dur
                    break

    for ev in host:
        while stack and (stack[-1][0].thread != ev.thread
                         or stack[-1][0].end_us <= ev.start_us):
            pop()
        func, stage = (stack[-1][1], stack[-1][2]) if stack \
            else (None, None)
        if ev.kind == "runtime":
            call_ctx[ev.cupti] = (stack[-1][4] if stack else NO_OP,
                                  func or OUTSIDE, stage or NO_STAGE, False)
            continue
        key = op_key(ev.name, ev.dtypes)
        if ev.kind == "range":
            if ev.name in STAGE_NAMES:
                stage = ev.name
                _add(stage_host, ev.name, ev.end_us - ev.start_us)
            elif ev.name.startswith(FN_RANGE):
                func = ev.name[len(FN_RANGE):]
            elif ev.name.startswith(KERNEL_RANGE):
                key, _, caller = ev.name.partition(" ")
                func = None if caller == "None" else caller
        if ev.corr:
            ctx[ev.corr] = (key, func or OUTSIDE, stage or NO_STAGE,
                            "long int" in ev.dtypes)
        span[0] = ev.start_us if span[0] is None \
            else min(span[0], ev.start_us)
        span[1] = ev.end_us if span[1] is None \
            else max(span[1], ev.end_us)
        stack.append([ev, func, stage, 0.0, key])
    while stack:
        pop()

    by_kernel: dict = {}
    by_copy: dict = {}
    by_op: dict = {}
    by_func: dict = {}
    by_stage: dict = {}
    stage_iv: dict = {}
    intervals = []
    int64_us = total_us = attributed_us = 0.0
    n_kernels = 0
    for ev, dur in device:
        corr = ev.corr or launched.get(ev.cupti, 0)
        key, func, stage, int64 = ctx.get(corr) or call_ctx.get(
            ev.cupti, (NO_OP, OUTSIDE, NO_STAGE, False))
        if ev.kind == "kernel":
            n_kernels += 1
            _add(by_kernel, ev.name if device_times else key, dur)
        else:
            _add(by_copy, f"{ev.name} ← {key}", dur)
        _add(by_op, key, dur)
        _add(by_func, func, dur)
        _add(by_stage, stage, dur)
        stage_iv.setdefault(stage, []).append((ev.start_us, ev.end_us))
        intervals.append((ev.start_us, ev.end_us, ev.name, func))
        total_us += dur
        if int64:
            int64_us += dur
        if func != OUTSIDE:
            attributed_us += dur

    busy_us = timing.interval_union((s, e) for s, e, _, _ in intervals)
    span_us = (span[1] - span[0]) if span[0] is not None else 0.0
    starts = [w[0] for w in windows or ()]

    def window(t):
        return bisect.bisect_right(starts, t)
    if windows:
        span_us = sum(e - s for s, e in windows)
    # the device timeline's idle holes, with what ran on either side
    intervals.sort()
    holes = []
    dev_span_us = 0.0
    if intervals:
        cur_end, cur = intervals[0][1], intervals[0]
        first = intervals[0][0]
        for iv in intervals[1:]:
            if window(iv[0]) != window(cur[0]):
                dev_span_us += cur_end - first
                first = iv[0]
            elif iv[0] > cur_end:
                holes.append((iv[0] - cur_end, cur, iv, cur_end))
            if iv[1] > cur_end or window(iv[0]) != window(cur[0]):
                cur_end, cur = iv[1], iv
        dev_span_us += cur_end - first
    spans = [(ev.start_us, ev.end_us, ev.name) for ev in host
             if ev.kind == "range" and ev.name.startswith("rtvb.")
             and not ev.name.startswith(TOOL_RANGES)]
    holes = [dict(ms=gap / 1e3, before=f"{a[2][:60]} [{a[3]}]",
                  after=f"{b[2][:60]} [{b[3]}]",
                  span=innermost_span(spans, at))
             for gap, a, b, at in heapq.nlargest(n_holes, holes,
                                                 key=lambda h: h[0])]
    stages = {}
    for name, (n_ranges, host_us) in stage_host.items():
        stages[name] = dict(
            ranges=n_ranges, host_ms=host_us / 1e3 / frames,
            device_ms=by_stage.get(name, [0, 0.0])[1] / 1e3 / frames,
            device_busy_ms=timing.interval_union(
                stage_iv.get(name, ())) / 1e3 / frames,
            device_events_per_frame=by_stage.get(name, [0, 0])[0] / frames)
    hand = {}
    for name, pat in HAND_KERNELS.items():
        rx = re.compile(pat)
        c = us = 0
        for k, (n, t) in by_kernel.items():
            if rx.search(k):
                c += n
                us += t
        hand[name] = dict(count=c, ms_per_frame=us / 1e3 / frames)
    return dict(
        frames=frames, times="device" if device_times else "host (CPU)",
        span_ms=span_us / 1e3, device_span_ms=dev_span_us / 1e3,
        device_busy_ms=busy_us / 1e3,
        device_busy_ms_per_frame=busy_us / 1e3 / frames,
        device_busy_share=busy_us / span_us if span_us else None,
        device_ms_per_frame=total_us / 1e3 / frames,
        device_kernels_per_frame=len(intervals) / frames,
        kernels_per_frame=n_kernels / frames,
        function_share=attributed_us / total_us if total_us else None,
        int64_share=int64_us / total_us if total_us else None,
        stages=stages, hand_kernels=hand,
        by_kernel=_rows(by_kernel, frames, top),
        by_op=_rows(by_op, frames, top),
        by_function=_rows(by_func, frames),
        by_stage=_rows(by_stage, frames),
        copies=_rows(by_copy, frames, 12),
        holes=holes,
        runtime_calls={r["name"]: dict(per_frame=r["per_frame"],
                                       ms_per_frame=r["ms_per_frame"])
                       for r in _rows(runtime, frames)})


def innermost_span(spans, at_us: float) -> str:
    """The name of the shortest of `spans` ((start, end, name) µs) open at
    `at_us`, or NO_SPAN."""
    best = None
    for s, e, name in spans:
        if s <= at_us <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return NO_SPAN if best is None else best[1]


def profile_frames(frame_fn, n: int, device, callers: bool = True,
                   top: int = 40) -> dict:
    """torch.profiler over n calls of frame_fn, summarised (`summarize`)
    with the window's wall ms a frame; callers: each call in its caller's
    range (`port_ranges`) and the ops' shapes recorded.  On the card the
    device events' own times; on the CPU the ops' host times.  Raises
    when a profile on the card saw no CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile
    card = timing.on_card(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    timing.sync(device)
    with profile(activities=acts, record_shapes=callers) as prof:
        t0 = time.perf_counter()
        with port_ranges() if callers else contextlib.nullcontext():
            for _ in range(n):
                frame_fn()
        timing.sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = summarize(events_from_kineto(prof.profiler.kineto_results.events()),
                    n, device_times=card, top=top)
    out["wall_ms_per_frame"] = wall_ms / n
    if card and out["kernels_per_frame"] == 0:
        raise RuntimeError("the profiler saw no CUDA kernel")
    return out


def profile_interleaved(eager_fn, replay_fn, n: int, device,
                        top: int = 40) -> tuple:
    """One torch.profiler session over n turns of an eager frame (each
    call in its caller's range, `port_ranges`, the ops' shapes recorded)
    and a replay, each turn's two in windows of their own that end in a
    synchronize → (eager summary, replay summary,
    kernels.launch_counts() of the eager frames alone).  The two share
    the session and its seconds, so what the tracer or the card does to
    kernels' durations over a session holds for both alike.  Each event
    goes to the window its start lies in: its host call's, or for device
    work the one it ran in, as the windows end in a synchronize.  On the
    CPU the ops' own host times stand in for device times (as
    `profile_frames`')."""
    from torch.profiler import ProfilerActivity, profile
    card = timing.on_card(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    counts: dict = {}
    timing.sync(device)
    with profile(activities=acts, record_shapes=True) as prof:
        for _ in range(n):
            before = K.launch_counts()
            with record_function(EAGER_WINDOW):
                with port_ranges():
                    eager_fn()
                timing.sync(device)
            for k, v in K.launch_counts().items():
                counts[k] = counts.get(k, 0) + v - before.get(k, 0)
            with record_function(REPLAY_WINDOW):
                replay_fn()
                timing.sync(device)
    windows: dict = {EAGER_WINDOW: [], REPLAY_WINDOW: []}
    for ev in events_from_kineto(prof.profiler.kineto_results.events()):
        if ev.kind == "range" and ev.name in windows:
            windows[ev.name].append((ev.start_us, ev.end_us))
    out = []
    for name in (EAGER_WINDOW, REPLAY_WINDOW):
        wins = sorted(windows[name])
        if len(wins) != n:
            raise RuntimeError(f"the profiler saw {len(wins)} {name} "
                               f"windows for {n} turns")
        starts = [w[0] for w in wins]

        def inside(ev):
            i = bisect.bisect_right(starts, ev.start_us) - 1
            return i >= 0 and ev.start_us <= wins[i][1]
        res = summarize(filter(inside, events_from_kineto(
            prof.profiler.kineto_results.events())), n, device_times=card,
            top=top, windows=wins)
        res["wall_ms_per_frame"] = res["span_ms"] / n
        if card and res["kernels_per_frame"] == 0:
            raise RuntimeError("the profiler saw no CUDA kernel")
        out.append(res)
    return out[0], out[1], counts


def shipped_engine(device, width: int = 1920, height: int = 1080,
                   scale: float = 1.0):
    """Engine with the shipped Settings() at width×height on `device`,
    at render scale `scale`."""
    from ..core.config import Settings
    from ..render.renderer import Engine
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": width, "render_height": height}), device=device)
    eng.set_render_scale(scale)
    return eng


def device_trace(device="cuda", scale: float = 1.0, frames: int = 3,
                 width: int = 1920, height: int = 1080, engine=None) -> dict:
    """Profile `frames` eager frames of the shipped frame at `scale` of a
    width×height output (or of `engine` as it stands, at `scale`) and,
    on the card, as many replays of its captured graph, in turns in one
    profile (`profile_interleaved`).  Returns {"device", "card", "scale",
    "internal", "output", "build", "eager": summary, "launches":
    kernels.launch_counts() over the eager frames, "replay": summary or
    None (CPU), "note"}; a summary as `summarize` gives it."""
    dev = timing.resolve(device)
    build = timing.ensure_kernels(dev)
    eng = engine if engine is not None else shipped_engine(
        dev, width, height, scale)
    eng.set_render_scale(scale)
    eng._eager_frame()            # modules loaded, states allocated
    timing.sync(dev)
    if timing.on_card(dev):
        for _ in range(2):        # the capture, then a replay
            eng.render_realtime_device()
        eager, replay, launches = profile_interleaved(
            eng._eager_frame, eng.render_realtime_device, frames, dev)
    else:
        K.reset_launch_counts()
        eager = profile_frames(eng._eager_frame, frames, dev)
        launches = K.launch_counts()
        replay = None
    return dict(device=str(dev),
                card=timing.card_name(dev),
                scale=scale, internal=[eng.width, eng.height],
                output=[eng.out_width, eng.out_height], build=build,
                frames=frames, eager=eager, launches=launches,
                replay=replay, note=HOST_BOUND_NOTE)


def log_summary(label: str, prof: dict, out=print) -> None:
    """A profile's summary in a few lines: the window, each stage's host
    and device ms, the top kernels and the host's CUDA runtime calls."""
    share = prof["device_busy_share"]
    out(f"profile of {prof['frames']} frames ({label}): "
        f"{prof['wall_ms_per_frame']:.3f} ms/frame under the profiler, "
        f"device busy {share if share is None else round(share, 4)} of the "
        f"window ({prof['device_busy_ms_per_frame']:.3f} ms a frame), "
        f"{prof['device_kernels_per_frame']:.0f} device ops/frame")
    for name, st in prof["stages"].items():
        out(f"  {name:15s} host {st['host_ms']:.3f} ms  device busy "
            f"{st['device_busy_ms']:.3f} ms  "
            f"{st['device_events_per_frame']:.0f} device ops")
    for k in prof["by_kernel"][:8]:
        out(f"  {k['ms_per_frame']:.4f} ms/frame  x{k['count']}  "
            f"{k['name'][:80]}")
    for name, c in list(prof["runtime_calls"].items())[:6]:
        out(f"  host {name}: {c['per_frame']:.1f} calls, "
            f"{c['ms_per_frame']:.3f} ms per frame")


def report(res: dict, top: int = 15, out=print) -> None:
    """Print a device_trace result: the groups' top rows a frame."""
    e = res["eager"]
    unit = "device" if e["times"] == "device" else "host (CPU)"
    out(f"device_trace {res['output'][0]}x{res['output'][1]} at scale "
        f"{res['scale']:.4g} ({res['internal'][0]}x{res['internal'][1]} "
        f"inside) on {res['card'] or res['device']}: {res['frames']} eager "
        f"frames, {e['wall_ms_per_frame']:.3f} ms a frame under the "
        f"profiler, {unit} busy {e['device_busy_ms_per_frame']:.3f} ms a "
        f"frame ({e['device_kernels_per_frame']:.0f} device ops), "
        f"functions account for {e['function_share']:.4f}, int64 ops "
        f"{e['int64_share']:.4f}")
    out(f"  note: {res['note']}")
    r = res["replay"]
    if r is not None:
        out(f"  replays: {r['wall_ms_per_frame']:.3f} ms a frame, device "
            f"busy {r['device_busy_ms_per_frame']:.3f} ms a frame "
            f"({r['device_busy_share']:.4f} of the window), "
            f"{r['kernels_per_frame']:.0f} kernels a frame")
    for title, rows in (("port functions", e["by_function"]),
                        ("ops and dtypes", e["by_op"]),
                        ("kernels", e["by_kernel"]),
                        ("stages", e["by_stage"]),
                        ("copies and memsets", e["copies"])):
        out(f"  -- top {title}, {unit} ms a frame --")
        for row in rows[:top]:
            out(f"  {row['ms_per_frame']:9.4f}  x{row['per_frame']:7.1f}  "
                f"{row['name'][:100]}")
    out("  -- largest idle holes (the program span open on the host) --")
    for h in e["holes"]:
        out(f"  {h['ms']:8.4f} ms  in {h['span']}  after {h['before']}  "
            f"before {h['after']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the whole result here")
    a = ap.parse_args(argv)
    res = device_trace(a.device, a.scale, a.frames, a.width, a.height)
    report(res)
    timing.write_json(res, a.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
