"""Per-frame pipeline-stage timing and the run-summary report (port of
rtvb_tpu/utils/perf.py), and the engine's tracer.

Named host timers around pipeline stages, mean / standard deviation over
the frames, rows appended to a report file, and a frame timer with an
FPS limiter.  A stage's end waits for its outputs as the JAX package
blocks on them: where an output is a tensor on the card, an event is
recorded on the stream that produced it (the current stream) after the
call and synchronized, so a stage's ms include the card's time.  CPU
tensors and numpy arrays are complete on return: nothing is waited on.

`TRACER` (a `Tracer`, on by default) records what the Engine does in each
frame without waiting for the card: host spans (name, start and end on
`time.perf_counter_ns()`, the enclosing span on the thread, the frame),
counts attached to the open span, and device stamps: the device's
nanosecond timer written into pinned host memory by a one-thread kernel
at five points of the frame body, which a captured graph replays with
the frame (`Stamps`, `csrc/stamp_kernel.cu`).  A frame's stamps are read
at the next frame's entry, after the caller has synchronized, with no
CUDA call and no wait; a frame whose stamps are not complete then is
dropped.  The last `RING_FRAMES` frames are kept (`Tracer.records`).
While a torch.profiler is active, and only then, each span is also a
profiler range `rtvb.<name>`, on the profiler's clock beside the device's
work.
"""
from __future__ import annotations

import collections
import ctypes
import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager

import torch
from torch.profiler import record_function

from .. import kernels as K

STAGES = ("scenePrep", "rendererUpdate", "pathTracing", "denoiser", "postProcessing")


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in a nest of tuples, lists, dicts
    and NamedTuples."""
    if hasattr(tree, "is_cuda"):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def wait_for(tree) -> None:
    """Block until the card has produced the tensors in `tree`: an event
    recorded on each of their devices' current stream, then synchronized.
    Nothing happens for host values."""
    devices = _cuda_devices(tree, set())
    if not devices:
        return
    import torch
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class PerformanceTracker:
    def __init__(self):
        self._frames: list[OrderedDict] = []
        self._current: OrderedDict | None = None
        self._t0 = 0.0

    def begin_frame(self):
        self._current = OrderedDict()
        self._t0 = time.perf_counter()

    @contextmanager
    def segment(self, name: str, sync=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                wait_for(sync)
            self._current[name] = (time.perf_counter() - start) * 1e3

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for its outputs, record the ms."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        wait_for(out)
        self._current[name] = (time.perf_counter() - start) * 1e3
        return out

    def end_frame(self):
        self._current["wholeFrame"] = (time.perf_counter() - self._t0) * 1e3
        self._frames.append(self._current)
        self._current = None

    # ---- aggregation ----

    def stats(self, skip_first: int = 1):
        frames = self._frames[skip_first:] if len(self._frames) > skip_first else self._frames
        if not frames:
            return {}
        keys = OrderedDict()
        for f in frames:
            for k in f:
                keys[k] = None
        out = {}
        for k in keys:
            vals = [f[k] for f in frames if k in f]
            mean = sum(vals) / len(vals)
            var = sum((v - mean) ** 2 for v in vals) / len(vals)
            out[k] = (mean, var ** 0.5)
        return out

    def summary_row(self, label: str) -> str:
        st = self.stats()
        whole = st.get("wholeFrame", (0.0, 0.0))
        cols = [f"{label}", f"WholeFrame {whole[0]:8.2f} ms (±{whole[1]:.2f})"]
        for k, (mean, _) in st.items():
            if k != "wholeFrame":
                cols.append(f"{k} {mean:7.2f}")
        return " | ".join(cols)

    def save_report(self, path: str, label: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        stamp = time.strftime("%Y-%m-%d %H:%M")
        with open(path, "a") as f:
            f.write(f"{stamp} {self.summary_row(label)}\n")


class FrameTimer:
    """Frame pacing with an optional FPS limiter."""

    def __init__(self, target_fps: float | None = None):
        self.target_fps = target_fps
        self._last = time.perf_counter()
        self.dt = 1.0 / 60.0
        self.fps = 60.0

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        if self.target_fps:
            budget = 1.0 / self.target_fps
            if dt < budget:
                time.sleep(budget - dt)
                now = time.perf_counter()
                dt = now - self._last
        self._last = now
        self.dt = dt
        self.fps = 0.9 * self.fps + 0.1 * (1.0 / max(dt, 1e-6))
        return dt


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

RING_FRAMES = 4096
RANGE_PREFIX = "rtvb."
# a frame body's stamps, in the order the frame records them
STAMPS = ("begin", "pathtrace", "denoise", "post", "end")
# a frame's device intervals, each between two of its stamps
INTERVALS = {"pathtrace": ("begin", "pathtrace"),
             "denoise": ("pathtrace", "denoise"),
             "post": ("denoise", "post"),
             "writeback": ("post", "end"),
             "frame": ("begin", "end")}
_INDEX = {k: (STAMPS.index(a), STAMPS.index(b))
          for k, (a, b) in INTERVALS.items()}
STAMP = K.CudaKernel("stamp", "rtvb_stamp", [K.P, K.P, K.I, K.I])


class Span:
    """A host span: `name`, `t0` and `t1` (ns of time.perf_counter_ns),
    the enclosing open span of its thread (`parent`), the frame it belongs
    to (`frame`: the frame running, or between frames the next one) and
    its counts ({name: value} or None).  A context manager; it is timed
    with the tracer off too, but then not recorded."""
    __slots__ = ("name", "t0", "t1", "parent", "frame", "counts",
                 "_tracer", "_range")

    def __init__(self, tracer: "Tracer", name: str):
        self.name = name
        self._tracer = tracer
        self.counts = None
        self.t0 = self.t1 = None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._thread.stack
        self.parent = stack[-1] if stack else None
        self.frame = tr._record.n
        self._range = None
        if tr.enabled and torch._C._autograd._profiler_enabled():
            self._range = record_function(RANGE_PREFIX + self.name)
            self._range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        tr = self._tracer
        tr._thread.stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if tr.enabled:
            tr._record.spans.append(self)
        return False


class FrameRecord:
    """One frame: its number `n`, its spans (those between the previous
    frame and this one too: an edit belongs to the frame that shows it),
    and from its stamps `device_ms` ({INTERVALS key: device ms}) and
    `gap_ms` (device ms from the previous frame's last stamp to this
    frame's first), None where not read; `dropped` when its stamps were
    not complete at the next frame's entry."""
    __slots__ = ("n", "spans", "stamps", "device_ms", "gap_ms", "dropped")

    def __init__(self, n: int):
        self.n = n
        self.spans: list = []
        self.stamps = None
        self.device_ms = None
        self.gap_ms = None
        self.dropped = False

    def self_ms(self, span: Span) -> float:
        """The span's ms less those of its child spans in this record."""
        return span.ms - sum(s.ms for s in self.spans if s.parent is span)


class Stamps:
    """The device stamps of one frame body on a CUDA `device`: a pinned
    host slot a stamp, which the stamp kernel fills with the device's ns
    timer, and after them the count of frames the kernel saw (`seq` on
    the device).  Recorded while a graph is captured, the kernels are the
    graph's and fire at every replay: the graph owns its Stamps.  `runs`
    counts the frames that ran them, as the host saw it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = torch.zeros(len(STAMPS) + 1, dtype=torch.int64,
                                pin_memory=True)
        self.view = self.host.numpy()
        self.seq = torch.zeros(1, dtype=torch.int64, device=device)
        self.recorded: set = set()
        self.runs = 0
        self._slots = None

    def record(self, name: str) -> None:
        if self._slots is None:
            fn = K.LIBRARY.get().rtvb_mapped_pointer
            fn.argtypes = [K.P, ctypes.POINTER(ctypes.c_void_p)]
            ptr = ctypes.c_void_p()
            err = fn(self.host.data_ptr(), ctypes.byref(ptr))
            if err != 0:
                raise RuntimeError(f"the stamps' host buffer is not mapped "
                                   f"to the device: cudaError {err}")
            self._slots = ptr.value
        STAMP.launch(self.device, self._slots, self.seq, STAMPS.index(name),
                     len(STAMPS) - 1)
        self.recorded.add(name)


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: list = []        # the thread's open spans
        self.stamps = None           # the Stamps its frame body records


class _FrameSpan(Span):
    """`engine.frame`: on entry the last frame's stamps are read; on exit
    the record joins the ring."""
    __slots__ = ()

    def __enter__(self) -> Span:
        tr = self._tracer
        if tr.enabled:
            tr.read_stamps()
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        tr = self._tracer
        if tr.enabled:
            rec = tr._record
            tr.records.append(rec)
            if rec.stamps is not None:
                tr._unread = rec
            tr._record = FrameRecord(rec.n + 1)
        return False


class Tracer:
    """Host spans, counts and device stamps by frame (module docstring).
    `enabled` False records nothing (spans are still timed)."""

    def __init__(self, capacity: int = RING_FRAMES):
        self.enabled = True
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._record = FrameRecord(0)
        self._thread = _ThreadState()
        self._unread = None          # the last record whose stamps ran
        self._last_end = None        # (frame, ns) of the last end read

    def reset(self) -> None:
        """Forget every record and unread stamp."""
        self.records.clear()
        self.dropped = 0
        self._record = FrameRecord(0)
        self._unread = None
        self._last_end = None

    def span(self, name: str) -> Span:
        return Span(self, name)

    def frame(self) -> Span:
        """The span of one Engine frame, `engine.frame` (module
        docstring)."""
        return _FrameSpan(self, "engine.frame")

    def count(self, name: str, value) -> None:
        """Add `value` to count `name` of this thread's innermost open
        span (nothing outside a span)."""
        stack = self._thread.stack
        if self.enabled and stack:
            sp = stack[-1]
            if sp.counts is None:
                sp.counts = {}
            sp.counts[name] = sp.counts.get(name, 0) + value

    @contextmanager
    def stamping(self, stamps):
        """Within: this thread's `stamp` calls record into `stamps` (None:
        nothing).  Run outside a capture, they are this frame's stamps."""
        prev = self._thread.stamps
        self._thread.stamps = stamps if self.enabled else None
        try:
            yield
        finally:
            self._thread.stamps = prev
        if stamps is not None and self.enabled and \
                not torch.cuda.is_current_stream_capturing():
            self.ran(stamps)

    def stamp(self, name: str) -> None:
        """Record stamp `name` of the frame body this thread runs."""
        st = self._thread.stamps
        if st is not None:
            st.record(name)

    def ran(self, stamps) -> None:
        """`stamps` ran in this frame (an eager body's, a replay's)."""
        if stamps is not None and self.enabled and stamps.recorded:
            stamps.runs += 1
            self._record.stamps = stamps

    def read_stamps(self) -> None:
        """Read the last frame's stamps, if they ran: its device ms by
        interval and the gap since the frame before it.  Nothing waits: a
        frame whose stamps are not all written is dropped."""
        rec = self._unread
        if rec is None:
            return
        self._unread = None
        st, rec.stamps = rec.stamps, None
        t = st.view.tolist()
        if len(st.recorded) != len(STAMPS) or t[-1] != st.runs:
            rec.dropped = True
            self.dropped += 1
            self._last_end = None
            # a body that raised after its first stamp left the device's
            # count ahead of the host's
            st.runs = max(st.runs, t[-1])
            return
        rec.device_ms = {k: (t[j] - t[i]) / 1e6 for k, (i, j) in
                         _INDEX.items()}
        last = self._last_end
        if last is not None and last[0] == rec.n - 1:
            rec.gap_ms = (t[0] - last[1]) / 1e6
        self._last_end = (rec.n, t[len(STAMPS) - 1])


TRACER = Tracer()
