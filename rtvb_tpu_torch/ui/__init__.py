"""Graphical UI (port of rtvb_tpu/ui/): bitmap font, RGBA overlay raster,
menu, dev-panel and HUD screens.  Host numpy, rastered on UI events; the
canvas reaches the card only through `Engine.set_ui_overlay`, and
`postprocess.compose_overlay` blends it into every frame."""
from .raster import OverlayCanvas                            # noqa: F401
from .overlay import render_menu, render_dev_panel, render_hud  # noqa: F401
