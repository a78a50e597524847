"""Image IO: PNG read / write for frames and goldens (port of
rtvb_tpu/utils/image.py).

Frames may arrive as tensors on the card: they are copied to the host
here, where the pixels are consumed, and nowhere earlier.  Writing
prefers the native C encoder (`utils/native.py`), then PIL, then a
dependency-free zlib writer.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    from PIL import Image as _PIL
except ImportError:  # pragma: no cover
    _PIL = None


def host(img) -> np.ndarray:
    """A numpy array of `img` (a tensor on any device is copied to the
    host; a numpy array passes through)."""
    if hasattr(img, "detach"):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_u8(img) -> np.ndarray:
    """Linear float RGB (H, W, 3) in [0, ~] → clamped 8-bit (no tone map:
    tone mapping is a pipeline stage)."""
    img = np.asarray(host(img), np.float32)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """img: (H, W, 3) uint8 or float (floats are clamped to [0, 1]), numpy
    or a tensor on any device."""
    img = host(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    from . import native
    if native.write_png(path, img):
        return
    if _PIL is not None:
        _PIL.fromarray(img, "RGB").save(path)
        return
    _write_png_raw(path, img)


def write_pngs(paths: list[str], imgs) -> None:
    """Batch write: the native encoder on worker threads when available,
    else one by one."""
    imgs = [host(i) for i in imgs]
    imgs = [to_u8(i) if i.dtype != np.uint8 else i for i in imgs]
    from . import native
    if native.write_pngs(paths, imgs):
        return
    for p, i in zip(paths, imgs):
        write_png(p, i)


def read_png(path: str) -> np.ndarray:
    """Returns (H, W, 3) uint8."""
    if _PIL is not None:
        return np.asarray(_PIL.open(path).convert("RGB"))
    raise RuntimeError("PNG reading requires PIL")


def _write_png_raw(path: str, img: np.ndarray) -> None:  # pragma: no cover
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
