"""The reference's stand-in for the port's kernel launcher.

It builds and loads no library: `on_cuda` is False for tensors on every
device, so each kernel wrapper of this copy runs its plain PyTorch version,
on the card too.  The other names are the ones the copied modules use.
"""
from __future__ import annotations

import contextlib
import ctypes

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

ALL: dict = {}


class CudaKernel:
    """A named entry point that is never launched."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.launches = 0

    def launch(self, device, *args):
        raise RuntimeError(f"the reference launches no kernel ({self.name})")


def register(kernel: CudaKernel) -> CudaKernel:
    ALL[kernel.name] = kernel
    return kernel


def as_input(name, t, dtype, shape, device):
    raise RuntimeError(f"the reference launches no kernel ({name})")


def on_cuda(t) -> bool:
    """Every tensor takes the plain version; a device other than the CPU
    or the card raises, as the port's rule does."""
    if t.device.type in ("cuda", "cpu"):
        return False
    raise ValueError(f"unsupported device {t.device}")


@contextlib.contextmanager
def recording_launches():
    yield {}


def add_launches(counts: dict) -> None:
    pass
