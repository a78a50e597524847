"""Device time from torch.profiler: the arithmetic of
rtvb_tpu_torch/tools/device_trace.py (events, attribution by correlation
id, the busy union, stage grouping, idle holes), copied so that the
yardstick does not move with the program.

A device event is attributed to the host op that launched it through the
profiler's correlation ids, never by time order; the op's stage is the
innermost stage range (`rtvb.pathtrace`, `rtvb.denoise`, `rtvb.post`,
which only an eager frame has) around it on its thread.  An idle hole of
the device is named by the innermost host span of the benchmark
(`bench.<name>`) open at the hole's start.
"""
from __future__ import annotations

import heapq
import re
from typing import NamedTuple

STAGE_NAMES = ("rtvb.pathtrace", "rtvb.denoise", "rtvb.post")
NO_STAGE = "(outside the stages)"
SPAN_PREFIX = "bench."
# device events of the tracer itself (CUPTI's overhead activities)
TRACER_OVERHEAD = ("Activity Buffer Request", "Activity Buffer Flush",
                   "Buffer Flush", "CUPTI Overhead")


class Event(NamedTuple):
    """kind: "op", "range" (record_function), "runtime" (a CUDA runtime
    call), "kernel", "memcpy", "memset" (device work), "mirror" or
    "overhead" (no work).  corr: an op's or range's own correlation id;
    for device work and runtime calls the launching op's.  cupti: a
    runtime call's and its device work's shared CUDA correlation id."""
    name: str
    kind: str
    start_us: float
    end_us: float
    corr: int = 0
    thread: int = 0
    cupti: int = 0


def events_from_kineto(raw):
    """An Event for each raw kineto event (`prof.profiler.kineto_results
    .events()`)."""
    from torch.autograd import DeviceType
    for e in raw:
        name = e.name()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        annotation = name.startswith(("rtvb.", SPAN_PREFIX)) or (
            hasattr(e, "is_user_annotation") and e.is_user_annotation())
        if e.device_type() == DeviceType.CPU:
            if name in TRACER_OVERHEAD:
                continue
            if annotation:
                kind, corr = "range", e.correlation_id()
            elif e.linked_correlation_id() > 0:
                kind, corr = "runtime", e.linked_correlation_id()
            else:
                kind, corr = "op", e.correlation_id()
            yield Event(name, kind, start, end, corr, e.start_thread_id(),
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


def interval_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_work(events) -> list:
    """The events that are device work (kernels, copies, memsets)."""
    return [e for e in events if e.kind in ("kernel", "memcpy", "memset")]


def stage_ms(events, frames: int) -> dict:
    """Device ms a frame by stage range: {stage: ms}, each device event
    under the stage of the op that launched it."""
    host = sorted((e for e in events if e.kind in ("op", "range")),
                  key=lambda e: (e.thread, e.start_us, -e.end_us))
    stage_of: dict = {}
    stack: list = []           # (event, stage)
    for ev in host:
        while stack and (stack[-1][0].thread != ev.thread
                         or stack[-1][0].end_us <= ev.start_us):
            stack.pop()
        stage = stack[-1][1] if stack else None
        if ev.kind == "range" and ev.name in STAGE_NAMES:
            stage = ev.name
        if ev.corr:
            stage_of[ev.corr] = stage or NO_STAGE
        stack.append((ev, stage))
    launched = {e.cupti: e.corr for e in events
                if e.kind == "runtime" and e.corr and e.cupti}
    out: dict = {}
    for ev in device_work(events):
        corr = ev.corr or launched.get(ev.cupti, 0)
        st = stage_of.get(corr, NO_STAGE)
        out[st] = out.get(st, 0.0) + (ev.end_us - ev.start_us) / 1e3
    return {k: v / frames for k, v in out.items()}


def kernel_ms(events, pattern: str, frames: int) -> tuple:
    """(device ms a frame, launches a frame) of the kernels whose name
    matches `pattern`."""
    rx = re.compile(pattern)
    us = n = 0
    for ev in events:
        if ev.kind == "kernel" and rx.search(ev.name):
            us += ev.end_us - ev.start_us
            n += 1
    return us / 1e3 / frames, n / frames


def top_ops(events, n: int = 10) -> list:
    """[[device op name, seconds]] of the n device ops that took most
    time in all."""
    by: dict = {}
    for ev in device_work(events):
        by[ev.name] = by.get(ev.name, 0.0) + (ev.end_us - ev.start_us)
    return [[name, us / 1e6] for name, us in
            heapq.nlargest(n, by.items(), key=lambda kv: kv[1])]


def idle_gaps(events, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the n longest holes
    between device work: the innermost `bench.` span open on the host at
    the hole's start, or "(no span)"."""
    iv = sorted((e.start_us, e.end_us) for e in device_work(events))
    holes = []
    if iv:
        cur_end = iv[0][1]
        for s, e in iv[1:]:
            if s > cur_end:
                holes.append((s - cur_end, cur_end))
            cur_end = max(cur_end, e)
    spans = sorted(((e.start_us, e.end_us, e.name[len(SPAN_PREFIX):])
                    for e in events if e.kind == "range"
                    and e.name.startswith(SPAN_PREFIX)
                    and e.name != SPAN_PREFIX + "slice"),
                   key=lambda s: s[0])
    out = []
    for gap, at in heapq.nlargest(n, holes, key=lambda h: h[0]):
        name = "(no span)"
        width = None
        for s, e, nm in spans:
            if s > at:
                break
            if e >= at and (width is None or e - s < width):
                name, width = nm, e - s
        out.append([name, gap / 1e6])
    return out


def slice_window(events, name: str = SPAN_PREFIX + "slice"):
    """(start, end) µs of the host range `name`, or None."""
    for e in events:
        if e.kind == "range" and e.name == name:
            return e.start_us, e.end_us
    return None


def summarize_replays(events, frames: int, roles: dict) -> dict:
    """The traced slice of the window: its length, the device's busy
    union in it, device ops a frame, and each hand kernel's device ms and
    launches a frame (roles: {name: module with PATTERN})."""
    win = slice_window(events)
    work = device_work(events)
    if win is not None:
        work = [e for e in work if e.start_us >= win[0]
                and e.start_us <= win[1]]
    busy_us = interval_union((e.start_us, e.end_us) for e in work)
    hand = {name: kernel_ms(work, mod.PATTERN, frames)
            for name, mod in roles.items()}
    return dict(
        frames=frames,
        window_s=(win[1] - win[0]) / 1e6 if win else None,
        busy_s=busy_us / 1e6,
        kernels_per_frame=sum(e.kind == "kernel" for e in work) / frames,
        hand=hand,
        top_ops=top_ops(work),
        idle_gaps=idle_gaps(work + [e for e in events
                                    if e.kind == "range"]))
