"""Host-side RGBA rasterizer for the UI overlay buffer (port of
rtvb_tpu/ui/raster.py).

UI raster is tiny, branchy and changes only on UI events, so it runs in
numpy on the host; the per-frame work, alpha-compositing the overlay onto
every pixel, is one elementwise pass on the card
(render/postprocess.compose_overlay).
"""
from __future__ import annotations

import numpy as np

from .font import GLYPH_H, GLYPH_W, glyph_cached


class OverlayCanvas:
    """(H, W, 4) u8 RGBA scratch the UI screens draw into."""

    def __init__(self, height: int, width: int):
        self.buf = np.zeros((height, width, 4), np.uint8)

    def clear(self):
        self.buf[:] = 0

    # -- primitives -----------------------------------------------------
    def fill_rect(self, x, y, w, h, rgba):
        H, W = self.buf.shape[:2]
        x0, y0 = max(0, int(x)), max(0, int(y))
        x1, y1 = min(W, int(x + w)), min(H, int(y + h))
        if x1 > x0 and y1 > y0:
            self.buf[y0:y1, x0:x1] = rgba

    def frame_rect(self, x, y, w, h, rgba, border: int = 1):
        self.fill_rect(x, y, w, border, rgba)
        self.fill_rect(x, y + h - border, w, border, rgba)
        self.fill_rect(x, y, border, h, rgba)
        self.fill_rect(x + w - border, y, border, h, rgba)

    def text(self, x, y, s: str, rgba=(255, 255, 255, 255), scale: int = 1):
        """Draw 5x7 text; returns the x cursor after the string."""
        H, W = self.buf.shape[:2]
        cx = int(x)
        for ch in s:
            g = glyph_cached(ch)
            if scale > 1:
                g = np.kron(g, np.ones((scale, scale), bool))
            gh, gw = g.shape
            x0, y0 = cx, int(y)
            x1, y1 = min(W, x0 + gw), min(H, y0 + gh)
            if x1 > x0 and y1 > y0 and x0 >= 0 and y0 >= 0:
                patch = self.buf[y0:y1, x0:x1]
                mask = g[: y1 - y0, : x1 - x0]
                patch[mask] = rgba
            cx += (GLYPH_W + 1) * scale
        return cx

    def text_center(self, cx, y, s: str, rgba=(255, 255, 255, 255),
                    scale: int = 1):
        w = len(s) * (GLYPH_W + 1) * scale - scale
        return self.text(cx - w // 2, y, s, rgba, scale)

    def hbar(self, x, y, w, h, frac: float, fg, bg):
        """Horizontal value bar (ImGui slider readout role)."""
        self.fill_rect(x, y, w, h, bg)
        self.fill_rect(x, y, int(w * float(np.clip(frac, 0.0, 1.0))), h, fg)

    def panel(self, x, y, w, h, title: str | None = None):
        """Bordered translucent panel (ImGui window chrome role)."""
        self.fill_rect(x, y, w, h, (16, 20, 28, 200))
        self.frame_rect(x, y, w, h, (120, 140, 170, 255))
        if title:
            self.fill_rect(x, y, w, GLYPH_H + 4, (40, 52, 70, 230))
            self.text(x + 4, y + 2, title, (230, 235, 245, 255))
        return y + GLYPH_H + 8
