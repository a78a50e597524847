"""Per-frame pipeline-stage timing and the run-summary report (port of
rtvb_tpu/utils/perf.py).

Named host timers around pipeline stages, mean / standard deviation over
the frames, rows appended to a report file, and a frame timer with an
FPS limiter.  A stage's end waits for its outputs as the JAX package
blocks on them: where an output is a tensor on the card, an event is
recorded on the stream that produced it (the current stream) after the
call and synchronized, so a stage's ms include the card's time.  CPU
tensors and numpy arrays are complete on return: nothing is waited on.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from contextlib import contextmanager

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
