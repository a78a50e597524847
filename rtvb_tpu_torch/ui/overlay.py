"""Graphical UI screens: the menu state machine's screens, the developer
panel and the HUD (port of rtvb_tpu/ui/overlay.py, the same layout).

The menus (MainMenu / NewGame / LoadGame; Gameplay draws none) and the
"RENDER SETTINGS" panel (FPS, resolution and camera readouts, then a
reflection walk over every settings field) raster into an OverlayCanvas
on UI events (host, numpy); render/postprocess.compose_overlay blends the
result on the card every frame.
"""
from __future__ import annotations

import numpy as np

from .raster import OverlayCanvas

ACCENT = (255, 200, 90, 255)
TEXT = (230, 235, 245, 255)
DIM = (150, 160, 175, 255)


def render_menu(canvas: OverlayCanvas, state_name: str,
                worlds: list[str], selected: int = 0,
                items: list[str] | None = None) -> None:
    """Raster the menu screen for a GameUI state (main_menu.rml /
    new_game.rml / load_game.rml role).  Gameplay state draws nothing —
    callers overlay the dev panel / HUD instead.

    items: the live item labels (GameUI.menu_items) — rendering the same
    list the cursor navigates keeps the highlight truthful; falls back to
    a static per-state list for standalone callers."""
    canvas.clear()
    if state_name == "Gameplay":
        return
    H, W = canvas.buf.shape[:2]
    pw, ph = max(180, W // 3), max(120, H // 3)
    px, py = (W - pw) // 2, (H - ph) // 2
    canvas.panel(px, py, pw, ph)
    canvas.text_center(W // 2, py + 10, "RTVB", ACCENT, scale=2)
    canvas.text_center(W // 2, py + 28, "VOXEL PATH TRACER", DIM)

    if items is None:
        if state_name == "MainMenu":
            items = ["NEW GAME", "LOAD GAME", "QUIT"]
        elif state_name == "NewGame":
            items = ["WORLD: " + (worlds[selected] if worlds else "DEFAULT"),
                     "CREATE", "BACK"]
        elif state_name == "LoadGame":
            items = [w.upper() for w in worlds] or ["(NO SAVED WORLDS)"]
            items.append("BACK")
        else:
            items = []
    y = py + 46
    for i, item in enumerate(items):
        color = ACCENT if i == selected else TEXT
        marker = "> " if i == selected else "  "
        canvas.text_center(canvas.buf.shape[1] // 2, y, marker + item, color)
        y += 12


def render_dev_panel(canvas: OverlayCanvas, settings, stats: dict,
                     selected: int | None = None) -> None:
    """Raster the developer panel (DeveloperGUIOverlay.cpp:33-90 role):
    live FPS / resolution / camera readouts on top, then the reflection
    walk over every settings group with value bars for numeric params.

    stats: {"fps": float, "frame_ms": float, "internal": (w, h),
            "output": (w, h), "cam": (x, y, z), "yaw": f, "pitch": f}
    selected: reflection index of the field under the edit cursor (the
    live-editing path highlights it; None renders read-only).
    """
    canvas.clear()
    H, W = canvas.buf.shape[:2]
    pw = min(240, W - 8)
    rows = list(settings.value_list())
    ph = min(H - 8, 78 + 9 * len(rows))
    y = canvas.panel(4, 4, pw, ph, title="RENDER SETTINGS")

    fps = stats.get("fps", 0.0)
    canvas.text(10, y, f"FPS {fps:6.1f}  {stats.get('frame_ms', 0.0):6.2f} MS",
                ACCENT)
    y += 10
    iw, ih = stats.get("internal", (0, 0))
    ow, oh = stats.get("output", (0, 0))
    canvas.text(10, y, f"RES {iw}X{ih} -> {ow}X{oh}", TEXT)
    y += 10
    cx, cy, cz = stats.get("cam", (0.0, 0.0, 0.0))
    canvas.text(10, y, f"CAM {cx:7.2f} {cy:7.2f} {cz:7.2f}", TEXT)
    y += 10
    canvas.text(10, y, f"YAW {stats.get('yaw', 0.0):6.2f} "
                       f"PITCH {stats.get('pitch', 0.0):6.2f}", TEXT)
    y += 12

    # reflection walk (GetValueList role): numeric params get a value bar;
    # the edit cursor's row gets a '>' marker in the accent color, and the
    # window scrolls so the cursor stays visible
    fit = max(1, (4 + ph - 4 - y) // 9)
    start = 0
    if selected is not None and selected >= start + fit - 1:
        start = selected - fit + 2
    for i, (name, value) in list(enumerate(rows))[start:]:
        if y + 9 > 4 + ph - 4:
            canvas.text(10, y, "...", DIM)
            break
        label = name.upper()
        if selected is not None and i == selected:
            canvas.text(4, y, ">", ACCENT)
        if isinstance(value, bool):
            canvas.text(10, y, f"{label[:30]:30s} {'ON' if value else 'OFF'}",
                        ACCENT if value else DIM)
        elif isinstance(value, (int, float)):
            canvas.text(10, y, f"{label[:24]:24s} {value:g}", TEXT)
            ref = abs(float(value))
            frac = 0.5 if ref == 0 else min(1.0, ref / (ref + 1.0))
            canvas.hbar(10 + 25 * 6, y + 1, pw - 25 * 6 - 14, 5, frac,
                        (90, 140, 220, 255), (50, 58, 70, 255))
        else:
            canvas.text(10, y, f"{label[:30]:30s} {str(value)[:8]}", DIM)
        y += 9


def render_hud(canvas: OverlayCanvas, text_lines: list[str]) -> None:
    """Minimal gameplay HUD: crosshair-adjacent status lines (bottom-left)."""
    canvas.clear()
    H = canvas.buf.shape[0]
    y = H - 10 * len(text_lines) - 4
    for line in text_lines:
        canvas.text(6, y, line.upper(), TEXT)
        y += 10
