"""The real-time frame as a CUDA graph: its fixed per-frame inputs, its
capture and its replay (the port's counterpart of the JAX package's one
jitted dispatch a frame, `_frame_fn`, and of nb frames a dispatch,
`_frame_batch_fn`).

A captured graph runs no Python and reads and writes fixed device
addresses.  So everything a frame takes that changes from frame to frame
lives in one fixed device buffer (`FrameInputs`): the frame index, `dt`,
the camera and the history camera, the light remap.  Before every frame
the engine writes it on the stream from its host copies, through a small
ring of pinned host buffers (`HostStaged`).  The feedback states are
fixed buffers of the engine, written in place at the end of each frame
(the counterpart of `donate_argnums`); an edit writes the world, light
and soup tables in place while their shapes stand (`write_fields`).  A
graph is keyed by the identity of every other tensor it read
(`identity`): when one of them is replaced (a table that grew, a new sky,
new settings), the engine captures anew and releases the stale graph
(`FrameGraph.release`).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as K
from ..core.camera import Camera, camera_view
from ..utils.perf import TRACER

# 32-bit words ahead of the remap: the frame index (int64, 2 words), dt,
# the camera's 7 leaves, the history camera's 7 leaves
HEADER_WORDS = 17
_PINNED_RING = 4


class HostStaged:
    """A fixed device buffer of n `dtype` values written from the host.
    `host()` gives the host array to fill, `commit()` copies it into
    `buf` on the device's current stream: on a CUDA device from a ring of
    pinned host buffers, each reused only after its copy has run; on the
    CPU `host()` is the buffer itself."""

    def __init__(self, device: torch.device, n: int, dtype=torch.int32):
        self.buf = torch.zeros(n, dtype=dtype, device=device)
        self._ring = []
        if device.type == "cuda":
            self._ring = [(torch.empty(n, dtype=dtype, pin_memory=True),
                           torch.cuda.Event()) for _ in range(_PINNED_RING)]
        self._next = 0

    def host(self) -> np.ndarray:
        if not self._ring:
            return self.buf.numpy()
        host, done = self._ring[self._next]
        done.synchronize()          # this buffer's last copy has run
        return host.numpy()

    def commit(self) -> None:
        if self._ring:
            host, done = self._ring[self._next]
            self.buf.copy_(host, non_blocking=True)
            done.record()
            self._next = (self._next + 1) % len(self._ring)


class FrameInputs:
    """The per-frame inputs in one fixed device buffer of int32 words,
    with fixed views: `frame` (0-d int64), `dt` (0-d f32), `camera` and
    `history_camera` (Camera views), `remap` (int32, n_remap slots:
    the light remap, the identity past its length).  `write` fills it from
    host values (a HostStaged buffer)."""

    def __init__(self, device: torch.device, n_remap: int):
        self.device = device
        self.n_remap = n_remap
        self._staged = HostStaged(device, HEADER_WORDS + n_remap)
        self.words = self._staged.buf
        self.frame = self.words[0:2].view(torch.int64)[0]
        f = self.words[2:HEADER_WORDS].view(torch.float32)
        self.dt = f[0]
        self.camera: Camera = camera_view(f[1:8])
        self.history_camera: Camera = camera_view(f[8:15])
        self.remap = self.words[HEADER_WORDS:]
        self._identity = np.arange(n_remap, dtype=np.int32)

    def write(self, frame_index: int, dt: float, camera: np.ndarray,
              history_camera: np.ndarray, remap: np.ndarray | None):
        """Write the inputs on the device's current stream; remap None is
        the identity."""
        a = self._staged.host()
        a[0:2].view(np.int64)[0] = frame_index
        f = a[2:HEADER_WORDS].view(np.float32)
        f[0] = dt
        f[1:8] = camera
        f[8:15] = history_camera
        r = a[HEADER_WORDS:]
        r[:] = self._identity
        if remap is not None:
            r[:len(remap)] = remap
        self._staged.commit()


def _pinned(arr) -> torch.Tensor:
    """A pinned host tensor holding a copy of host array `arr` (a copy
    from it to the card waits for nothing; the caching host allocator
    keeps it until that copy has run)."""
    return torch.from_numpy(np.array(arr, order="C")).pin_memory()


def upload(arr, device: torch.device) -> torch.Tensor:
    """A new tensor on `device` holding host array `arr`, copied on the
    current stream (on a CUDA device from pinned memory, without a wait
    for the stream's queued work); its bytes count on the open span."""
    TRACER.count("bytes", np.asarray(arr).nbytes)
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr, order="C"))
    return _pinned(arr).to(device, non_blocking=True)


def write_fields(fields, arrays: dict) -> bool:
    """Write the host `arrays` into the tensors of the NamedTuple `fields`
    in place, each by name (on the current stream, after whatever read
    them before it and before whatever is queued after), when every
    tensor's shape and dtype agree with its array's; else write nothing
    and return False."""
    pairs = [(t, np.asarray(arrays[f])) for f, t in zip(fields._fields,
                                                       fields)
             if isinstance(t, torch.Tensor)]
    for t, a in pairs:
        if tuple(t.shape) != a.shape or \
                t.dtype != torch.from_numpy(np.empty(0, a.dtype)).dtype:
            return False
    for t, a in pairs:
        copy_in(t, a)
    return True


def copy_in(t: torch.Tensor, arr) -> None:
    """Write host array `arr` into `t` in place, on the current stream (on
    a CUDA device from pinned memory, without a wait); its bytes count on
    the open span."""
    TRACER.count("bytes", t.nbytes)
    if t.device.type == "cuda":
        t.copy_(_pinned(arr), non_blocking=True)
    else:
        t.copy_(torch.from_numpy(np.array(arr, order="C")))


def identity(obj) -> tuple:
    """What a graph that read `obj` depends on: each tensor leaf's address,
    shape, dtype and device, each other leaf's value (NamedTuples, tuples
    and lists walked; a launch takes such a value at capture)."""
    if isinstance(obj, torch.Tensor):
        return ("t", obj.data_ptr(), tuple(obj.shape), obj.dtype, obj.device)
    if isinstance(obj, (tuple, list)):
        return tuple(identity(x) for x in obj)
    return ("v", obj)


def tensors(obj) -> list:
    """The tensor leaves of `obj` (NamedTuples, tuples and lists walked)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in tensors(x)]
    return []


class FrameGraph(NamedTuple):
    """One captured graph of nb frames: its output (the u8 frame or the
    (nb, h, w, 3) stack, in the graph's pool), the kernel launches one
    replay makes, the tensors it reads by address (held so they stay
    alive), the host ms of its capture (instantiation included), the
    device stamps its frame records (a `perf.Stamps`, or None)."""
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor
    launches: dict
    keep: tuple
    capture_ms: float
    stamps: object = None

    def replay(self) -> torch.Tensor:
        """Replay on the current stream; returns the graph's own output
        (overwritten by the next replay)."""
        self.graph.replay()
        K.add_launches(self.launches)
        TRACER.ran(self.stamps)
        return self.out

    def release(self) -> None:
        self.graph.reset()


def capture(body, keep, stamps=None) -> FrameGraph:
    """Capture body() → output tensor into a new graph with its own
    memory pool; `stamps`: those body records (the graph's own).  The
    caller has run the same body eagerly first (kernel modules loaded,
    caches filled).  A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with K.recording_launches() as launches:
        # thread-local: another thread's CUDA calls (the light variant's
        # warm-up) do not invalidate this capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = body()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return FrameGraph(graph=graph, out=out, launches=dict(launches),
                      keep=tuple(keep), capture_ms=ms, stamps=stamps)
