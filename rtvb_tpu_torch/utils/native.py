"""ctypes binding for the native runtime library (port of
rtvb_tpu/utils/native.py): the PNG encoder, the parallel batch writer and
FNV-1a of `native/rtvb_native.c`.

The library is built from that source with the C compiler into the
git-ignored `build/native/` on first use (rebuilt when a hash of the
source changes); nothing is ever written into `native/`.  Without a
compiler (or zlib) every handle returns None / False and the callers fall
back to pure Python.  This is host code: the PNG bytes and the hashes
equal the JAX package's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
SOURCE = os.path.join(_REPO, "native", "rtvb_native.c")
BUILD_DIR = os.path.join(_REPO, "build", "native")
LIB_NAME = "librtvb_native.so"
# the flags of native/Makefile
CFLAGS = ["-O2", "-fPIC", "-Wall", "-Wextra", "-shared"]
LDLIBS = ["-lz", "-lpthread"]

_lib = None
_tried = False


def _source_hash() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CFLAGS + LDLIBS).encode())
    return h.hexdigest()[:16]


def _build() -> str | None:
    """Path of the built library (building it if missing or stale), or
    None without a source or a compiler."""
    if not os.path.exists(SOURCE):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = out + ".hash"
    want = _source_hash()
    if os.path.exists(out) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == want:
                return out
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    # build under a private name, then rename: concurrent processes
    # (test workers) never load a half-written file
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE, *LDLIBS], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        with open(f"{stamp}.{os.getpid()}", "w") as f:
            f.write(want)
        os.replace(f"{stamp}.{os.getpid()}", stamp)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return out


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.rtvb_fnv1a64.restype = ctypes.c_uint64
        lib.rtvb_fnv1a64.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtvb_write_png.restype = ctypes.c_int
        lib.rtvb_write_png.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_char_p]
        lib.rtvb_write_pngs.restype = ctypes.c_int
        lib.rtvb_write_pngs.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def fnv1a64(data: bytes) -> int | None:
    lib = _load()
    if lib is None:
        return None
    return int(lib.rtvb_fnv1a64(data, len(data)))


def write_png(path: str, img) -> bool:
    """img: (H, W, 3) uint8 numpy array."""
    import numpy as np
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    rc = lib.rtvb_write_png(path.encode(), w, h,
                            img.ctypes.data_as(ctypes.c_char_p))
    return rc == 0


def write_pngs(paths: list[str], frames, threads: int = 8) -> bool:
    """Batch parallel encode.  frames: (H, W, 3) uint8 arrays, all the
    same size."""
    import numpy as np
    lib = _load()
    if lib is None or not paths:
        return False
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    n = len(paths)
    patharr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    framearr = (ctypes.c_void_p * n)(*[f.ctypes.data for f in frames])
    rc = lib.rtvb_write_pngs(patharr, framearr, w, h, n, threads)
    return rc == 0
