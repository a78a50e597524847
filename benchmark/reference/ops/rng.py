"""Per-pixel low-discrepancy random numbers (port of rtvb_tpu/ops/rng.py).

Bit-exact with the JAX package.  torch has no complete uint32 arithmetic,
so unsigned 32-bit values live in int64 tensors holding [0, 2³²) and every
multiply wraps with an explicit ``& 0xFFFFFFFF`` (products of two u32 fit
in 63 bits).  Blue-noise byte planes are int32 bit patterns.  The frame
index is a 0-d int64 tensor on the frame's device (`frame_tensor`), so no
host value depends on it and a captured CUDA graph draws each replay's
own noise.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .pack import bits_f32, u32_to_i32

M32 = 0xFFFFFFFF

# R2 strides as fixed-point uint32 (round(stride · 2³²))
PHI2_X_BITS = 3242174889
PHI2_Y_BITS = 2447445413


def u32(x) -> torch.Tensor:
    """Any int tensor → int64 holding its uint32 value."""
    return x.to(torch.int64) & M32


def pcg_hash(x):
    """PCG output permutation on uint32 (int64-held; returns int64)."""
    x = u32(x)
    x = (x * 747796405 + 2891336453) & M32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (word >> 22) ^ word


def hash_combine(*xs):
    h = None
    for x in xs:
        base = 0x9E3779B9 if h is None else h
        h = pcg_hash(base ^ u32(x))
    return h


def to_unit_float(bits):
    """uint32 → [0, 1) float32 via mantissa injection (JAX-identical)."""
    b = (u32(bits) >> 9) | 0x3F800000
    return bits_f32(u32_to_i32(b)) - 1.0


def frame_tensor(frame, device) -> torch.Tensor:
    """The frame index as a 0-d int64 tensor holding its uint32 value: a
    tensor stays on its device (never read on the host); a host int is
    filled into one on `device`."""
    if isinstance(frame, torch.Tensor):
        return frame.to(torch.int64) & M32
    return torch.full((), int(frame) & M32, dtype=torch.int64, device=device)


def rand(px, py, frame, dim: int):
    """PCG + R2 sample keyed by (pixel, frame, dimension); frame a 0-d
    int64 tensor (or a host int)."""
    base_bits = hash_combine(px, (u32(py) * 9277) & M32,
                             torch.full_like(u32(px), (dim * 26699) & M32))
    stride = PHI2_X_BITS if (dim & 1) == 0 else PHI2_Y_BITS
    f = frame_tensor(frame, px.device)
    bits = (base_bits + ((f * stride) & M32)) & M32
    return to_unit_float(bits)


# ---------------------------------------------------------------------------
# blue-noise sampler (dithered Sobol over void-and-cluster masks)
# ---------------------------------------------------------------------------

_BN_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "data", "assets", "bluenoise.npz")


class BlueNoiseTables:
    """Host-side tables: sobol_basis32 (256, 8) u32 and the 16 masks packed
    4-slices-per-u32 as (4, 128, 128)."""

    def __init__(self, path: str = _BN_PATH):
        with np.load(path) as d:
            t = d["masks"].astype(np.uint32)
            packs = [t[4 * i] | (t[4 * i + 1] << 8) | (t[4 * i + 2] << 16)
                     | (t[4 * i + 3] << 24) for i in range(4)]
            self.basis = np.asarray(d["sobol_basis32"], np.uint32)
            self.masks = np.stack(packs).astype(np.uint32)


_TABLES: BlueNoiseTables | None = None


def bn_tables() -> BlueNoiseTables:
    global _TABLES
    if _TABLES is None:
        _TABLES = BlueNoiseTables()
    return _TABLES


@functools.lru_cache(maxsize=None)
def bn_packed(H: int, W: int, y0: int = 0, step: int = 1, device="cpu"):
    """Tuple of FOUR (H, W) int32 byte-plane packs aligned with the pixel
    grid (the u32 bit patterns of the JAX package's `bn_packed`).  Cached
    and never evicted: the frame asks for the same planes every time, and
    a captured CUDA graph reads them by address; callers never write into
    them."""
    t = bn_tables().masks.view(np.int32)
    if y0:
        t = np.roll(t, -(int(y0) % 128), axis=1)
    if step != 1:
        t = t[:, ::step, ::step]
    per = 128 // step
    ry, rx = -(-H // per) + 1, -(-W // per)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        np.tile(t[c], (ry, rx))[:H, :W])).to(device) for c in range(4))


@functools.lru_cache(maxsize=None)
def bn_basis(device="cpu") -> torch.Tensor:
    """The (256, 8) Sobol XOR basis as int32 bit patterns on `device`
    (cached, never evicted: the fused shade kernel computes sobol(frame,
    dim) from it, and a captured graph reads it by address)."""
    return torch.from_numpy(np.ascontiguousarray(
        bn_tables().basis.view(np.int32))).to(device)


def _sobol_bits(frame) -> torch.Tensor:
    """sobol_dim(frame & 255) for all 256 dimensions: (256,) int64 holding
    their uint32, the XOR basis over the 8 frame bits, with tensors."""
    basis = u32(bn_basis(frame.device))                    # (256, 8)
    ks = torch.arange(8, dtype=torch.int64, device=frame.device)
    t = ((frame >> ks) & 1) * basis
    t = t[:, :4] ^ t[:, 4:]
    t = t[:, :2] ^ t[:, 2:]
    return t[:, 0] ^ t[:, 1]


def bn_sobol_terms(frame) -> torch.Tensor:
    """to_unit_float(sobol_dim(frame & 255)) for all 256 dimensions, a
    (256,) f32 tensor on the frame's device (frame a 0-d int64 tensor);
    (v>>9)·2⁻²³ is exact in float32, the JAX package's scalar form."""
    return (_sobol_bits(frame) >> 9).to(torch.float32) * (2.0 ** -23)


def bn_sobol_scalar(frame, dim: int) -> torch.Tensor:
    """sobol_dim(frame & 255) as a 0-d int64 tensor holding its uint32."""
    return _sobol_bits(frame_tensor(frame, "cpu"))[dim & 255]


def _bn_mask(bn, dim: int):
    d16 = dim & 15
    sh = 8 * (d16 & 3)
    byte = (bn[d16 >> 2] >> sh) & 0xFF
    return bits_f32((byte << 15) | 0x3F800000) - (1.0 - 0.5 / 256.0)


def bn_draw(bn, frame, dim: int, sob=None):
    """Blue-noise dithered sample in [0,1):
    frac((mask_byte + 0.5)/256 + sobol_dim(frame)/2^32).  sob: the
    frame's `bn_sobol_terms`, when the caller has them."""
    if sob is None:
        sob = bn_sobol_terms(frame_tensor(frame, bn[0].device))
    u = _bn_mask(bn, dim) + sob[dim & 255]
    return u - torch.floor(u)


class RandState:
    """Mutable dimension counter mirroring the reference's randIdx++ usage.
    `frame` is the frame index as a 0-d int64 tensor (or a host int)."""

    def __init__(self, px, py, frame, base_dim: int = 0, bn=None):
        self.px = px
        self.py = py
        dev = (bn[0] if bn is not None else px).device
        self.frame = frame_tensor(frame, dev)
        self.dim = base_dim
        self.bn = bn
        if bn is None:
            h = pcg_hash(0x9E3779B9 ^ u32(px))
            self._base = pcg_hash(h ^ ((u32(py) * 9277) & M32))
            # the R2 frame advance of even and odd dimensions
            self._adv = tuple((self.frame * s) & M32
                              for s in (PHI2_X_BITS, PHI2_Y_BITS))
        else:
            self._sob = bn_sobol_terms(self.frame)

    def next(self):
        if self.bn is not None:
            v = bn_draw(self.bn, self.frame, self.dim, self._sob)
            self.dim += 1
            return v
        dim = self.dim & M32
        bits = pcg_hash(self._base ^ ((dim * 26699) & M32))
        v = to_unit_float((bits + self._adv[dim & 1]) & M32)
        self.dim += 1
        return v

    def next2(self):
        return self.next(), self.next()

    def next3(self):
        return self.next(), self.next(), self.next()
