"""The interactive app's dynamic-resolution controller (port of
rtvb_tpu/apps/interactive.py `DynamicResolution`; the rest of the app is
still to port).

It walks a small ladder of fixed render-scale rungs, 1 → 3/4 → 2/3 → 1/2:
over the frame budget it steps down, with headroom it steps up, with
hysteresis so a borderline frame time does not flip it every frame.  The
caller applies each returned scale with `Engine.set_render_scale`.
"""
from __future__ import annotations


class DynamicResolution:
    RUNGS = (1.0, 0.75, 2.0 / 3.0, 0.5)

    def __init__(self, target_fps: float, min_scale: float = 0.5,
                 start_scale: float = 1.0, hysteresis: int = 8):
        self.target = target_fps
        self.rungs = [r for r in self.RUNGS if r >= min_scale - 1e-6]
        self.idx = min(range(len(self.rungs)),
                       key=lambda i: abs(self.rungs[i] - start_scale))
        self.hysteresis = hysteresis
        self._streak = 0
        self._ema = None

    @property
    def scale(self) -> float:
        return self.rungs[self.idx]

    def update(self, frame_ms: float) -> float:
        """Feed one frame time; returns the scale to use next frame."""
        self._ema = frame_ms if self._ema is None else \
            0.8 * self._ema + 0.2 * frame_ms
        budget = 1000.0 / self.target
        if self._ema > budget * 1.08:
            self._streak = min(self._streak + 1, self.hysteresis)
        elif self._ema < budget * 0.55:
            self._streak = max(self._streak - 1, -self.hysteresis)
        else:
            self._streak = 0
        if self._streak >= self.hysteresis and self.idx + 1 < len(self.rungs):
            self.idx += 1
            self._streak = 0
            self._ema = None
        elif self._streak <= -self.hysteresis and self.idx > 0:
            self.idx -= 1
            self._streak = 0
            self._ema = None
        return self.rungs[self.idx]
