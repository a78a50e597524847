"""PNG reading for the authored textures (the read half of
rtvb_tpu/utils/image.py, which the port keeps its own copy of)."""
from __future__ import annotations

import numpy as np

try:
    from PIL import Image as _PIL
except ImportError:  # pragma: no cover
    _PIL = None


def read_png(path: str) -> np.ndarray:
    """Returns (H, W, 3) uint8."""
    if _PIL is not None:
        return np.asarray(_PIL.open(path).convert("RGB"))
    raise RuntimeError("PNG reading requires PIL")
