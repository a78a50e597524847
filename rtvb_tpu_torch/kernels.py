"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together, and the objects link into ONE shared library with a
plain C interface (``build/kernels/librtvb_kernels.so``), loaded with
ctypes.  The build runs on first use and again whenever a hash of the
sources changes; nothing is built at import time, so the CPU tests import
every module without ``nvcc``.

Each kernel has a :class:`CudaKernel` handle that checks its tensors,
launches on PyTorch's current stream, raises on a nonzero
``cudaGetLastError()`` and counts its launches (``launches``, a plain int
incremented once per kernel launch and nowhere else).  A launch made while
a CUDA graph is being captured runs nothing: it is recorded into the
graph's own counts instead (`recording_launches`), and each replay of the
graph adds them (`add_launches`), so `launch_counts()` reports what the
card ran.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIB_NAME = "librtvb_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # no FMA contraction: the kernels round every product like
              # their plain PyTorch versions do, so the two agree to the bit
              "--fmad=false",
              "-Xptxas", "-v",           # registers / spills into build_log
              "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def _sources(csrc_dir: str = CSRC_DIR) -> list[str]:
    return sorted(os.path.join(csrc_dir, f) for f in os.listdir(csrc_dir)
                  if f.endswith((".cu", ".cuh")))


def source_hash(csrc_dir: str = CSRC_DIR) -> str:
    h = hashlib.sha256()
    for path in _sources(csrc_dir):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class Library:
    """A shared library of the kernels in `csrc_dir`, built into
    `build_dir` on first use and loaded."""

    def __init__(self, csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR):
        self.csrc_dir = csrc_dir
        self.build_dir = build_dir
        self._lib = None
        self.build_seconds = None   # None: not built in this process
        self.build_log = None       # nvcc's output of this process's build

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(self._ensure_built())
        return self._lib

    def _ensure_built(self) -> str:
        os.makedirs(self.build_dir, exist_ok=True)
        out = os.path.join(self.build_dir, LIB_NAME)
        stamp = out + ".hash"
        want = source_hash(self.csrc_dir)
        if os.path.exists(out) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == want:
                    self.build_seconds = 0.0
                    return out
        t0 = time.perf_counter()
        nvcc = _nvcc()
        tag = f"{os.getpid()}.tmp"
        jobs = []
        for src in (f for f in _sources(self.csrc_dir)
                    if f.endswith(".cu")):
            obj = os.path.join(self.build_dir,
                               os.path.basename(src)[:-3] + f".{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                failed.append(proc.returncode)
        tmp = f"{out}.{tag}"
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", tmp, *[obj for _, obj, _ in jobs]]
        if not failed:
            res = subprocess.run(link, capture_output=True, text=True)
            logs.append(f"$ {' '.join(link)}\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                failed.append(res.returncode)
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        os.replace(tmp, out)
        with open(stamp, "w") as f:
            f.write(want)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = "\n".join(logs)
        return out


LIBRARY = Library()


def as_input(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
             device: torch.device) -> torch.Tensor:
    """Return t if it is a contiguous CUDA tensor on `device` of the given
    dtype and shape (None: any shape); raise otherwise."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    return t


class CudaKernel:
    """Handle on one C entry point of the library: argtypes, launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [P]     # + stream
        self.launches = 0
        self.library = LIBRARY
        self._fn = None

    def use(self, library: Library) -> Library:
        """Launch from `library` from now on, a build of other sources with
        the same C entry point (to time two versions of a kernel in
        turns); returns the library used until now."""
        prev, self.library, self._fn = self.library, library, None
        return prev

    def _get(self):
        if self._fn is None:
            fn = getattr(self.library.get(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = I
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args):
        """Call the entry point on the current stream of `device`; tensors
        are passed as data pointers.  Raises on a nonzero CUDA error."""
        fn = self._get()
        stream = torch.cuda.current_stream(device).cuda_stream
        conv = []
        for a in args:
            if isinstance(a, torch.Tensor):
                conv.append(a.data_ptr())
            else:
                conv.append(a)
        with torch.cuda.device(device):
            err = fn(*conv, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        record = getattr(_CAPTURE, "counts", None)
        if record is None:
            self.launches += 1
        else:
            record[self] = record.get(self, 0) + 1


ALL: dict[str, CudaKernel] = {}

# this thread's graph capture under way: {CudaKernel: launches captured}
_CAPTURE = threading.local()


@contextlib.contextmanager
def recording_launches():
    """Within: this thread's launches are being captured into a CUDA graph
    (they run nothing now), so they go to the yielded {CudaKernel: count}
    and not to the kernels' counts."""
    prev = getattr(_CAPTURE, "counts", None)
    counts: dict = {}
    _CAPTURE.counts = counts
    try:
        yield counts
    finally:
        _CAPTURE.counts = prev


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a captured graph (the counts
    `recording_launches` yielded at its capture)."""
    for kernel, n in counts.items():
        kernel.launches += n


def register(kernel: CudaKernel) -> CudaKernel:
    ALL[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    for k in ALL.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in ALL.items()}


def on_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper: CUDA tensors launch the
    kernel; CPU tensors run the plain PyTorch version; anything else
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
