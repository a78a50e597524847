"""The program's own trace: the port's one tracer (`rtvb_tpu_torch/utils/
perf.py`'s TRACER, every Engine's), found among the loaded modules (the
output check has freed the session's engine before the metrics are
read), read for the window's frames and clicks before the profiled
slice.

A frame record (`FrameRecord`) holds its host spans (`name`, `t0` and
`t1` in ns of time.perf_counter_ns, the clock of the session's
time.perf_counter; `counts`), the device ms between its stamps
(`device_ms`, by interval: "pathtrace", "denoise", "post", "writeback",
"frame") and the device's gap since the frame before (`gap_ms`).  The
window's untraced part runs from the session's `t0` to the synchronize of
its last frame before the profiled slice, `t0` + the untraced frames'
intervals.  Every reader gives None where there is nothing to read: a
program without the tracer, a run without a window, a device without
stamps (the CPU).
"""
from __future__ import annotations

import sys

PORT_TRACER = ("rtvb_tpu_torch.utils.perf", "TRACER")


def records() -> list:
    """The loaded port's tracer's frame records, or [] (a port without a
    tracer, or none loaded)."""
    tracer = getattr(sys.modules.get(PORT_TRACER[0]), PORT_TRACER[1], None)
    return list(getattr(tracer, "records", ()))


def untraced_window(sess):
    """(start, end) ns on the host clock of the window's frames before the
    profiled slice, or None."""
    if getattr(sess, "t0", None) is None or not sess.untraced:
        return None
    return sess.t0 * 1e9, (sess.t0 + sum(sess.untraced)) * 1e9


def _inside(span, win) -> bool:
    return win[0] <= span.t0 and span.t1 <= win[1]


def spans(run, name: str) -> list:
    """The spans named `name` that lie in the untraced window."""
    win = untraced_window(run.sess)
    if win is None:
        return []
    return [s for r in records() for s in r.spans
            if s.name == name and _inside(s, win)]


def window_frames(run) -> list:
    """The frame records whose `engine.frame` span lies in the untraced
    window."""
    win = untraced_window(run.sess)
    if win is None:
        return []
    return [r for r in records() for s in r.spans
            if s.name == "engine.frame" and _inside(s, win)]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def span_ms(run, name: str):
    """The mean ms of the spans named `name` in the untraced window."""
    return mean(s.ms for s in spans(run, name))


def device_ms(run, interval: str):
    """The mean device ms of `interval` over the untraced window's frames
    whose stamps were read."""
    return mean(r.device_ms[interval] for r in window_frames(run)
                if r.device_ms is not None)


def gap_ms(run):
    """The mean device ms from a frame's last stamp to the next frame's
    first, over the untraced window's frames that have one."""
    return mean(r.gap_ms for r in window_frames(run)
                if r.gap_ms is not None)


def bytes_per(run, names, per: str):
    """The bytes counted on the spans named in `names`, over the number of
    spans named `per`, in the untraced window."""
    n = len(spans(run, per))
    if not n:
        return None
    return sum((s.counts or {}).get("bytes", 0)
               for name in names for s in spans(run, name)) / n
