"""Per-pixel low-discrepancy random numbers (port of rtvb_tpu/ops/rng.py).

Bit-exact with the JAX package.  torch has no complete uint32 arithmetic,
so unsigned 32-bit values live in int64 tensors holding [0, 2³²) and every
multiply wraps with an explicit ``& 0xFFFFFFFF`` (products of two u32 fit
in 63 bits).  Blue-noise byte planes are int32 bit patterns.
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


def to_unit_float_scalar(bits: int) -> float:
    """Host-int version: (bits>>9)·2⁻²³ is exact in float32."""
    return float(np.float32((int(bits) & M32) >> 9) * np.float32(2.0 ** -23))


def rand(px, py, frame: int, dim: int):
    """PCG + R2 sample keyed by (pixel, frame, dimension)."""
    base_bits = hash_combine(px, (u32(py) * 9277) & M32,
                             torch.full_like(u32(px), (dim * 26699) & M32))
    stride = PHI2_X_BITS if (dim & 1) == 0 else PHI2_Y_BITS
    bits = (base_bits + (((int(frame) & M32) * stride) & M32)) & M32
    return to_unit_float(bits)


# ---------------------------------------------------------------------------
# blue-noise sampler (dithered Sobol over void-and-cluster masks)
# ---------------------------------------------------------------------------

_BN_PATH = os.path.join(os.path.dirname(__file__), "..", "..",
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


@functools.lru_cache(maxsize=8)
def bn_packed(H: int, W: int, y0: int = 0, step: int = 1, device="cpu"):
    """Tuple of FOUR (H, W) int32 byte-plane packs aligned with the pixel
    grid (the u32 bit patterns of the JAX package's `bn_packed`).  Cached:
    the frame asks for the same planes every time; callers never write
    into them."""
    t = bn_tables().masks.view(np.int32)
    if y0:
        t = np.roll(t, -(int(y0) % 128), axis=1)
    if step != 1:
        t = t[:, ::step, ::step]
    per = 128 // step
    ry, rx = -(-H // per) + 1, -(-W // per)
    return tuple(torch.from_numpy(np.ascontiguousarray(
        np.tile(t[c], (ry, rx))[:H, :W])).to(device) for c in range(4))


@functools.lru_cache(maxsize=4)
def bn_basis(device="cpu") -> torch.Tensor:
    """The (256, 8) Sobol XOR basis as int32 bit patterns on `device`
    (cached: the fused shade kernel computes sobol(frame, dim) from it)."""
    return torch.from_numpy(np.ascontiguousarray(
        bn_tables().basis.view(np.int32))).to(device)


def bn_sobol_scalar(frame: int, dim: int) -> int:
    """sobol_dim(frame & 255) as a host uint32 (XOR basis over 8 bits)."""
    basis = bn_tables().basis[dim & 255]
    f = int(frame) & M32
    v = 0
    for k in range(8):
        if int(basis[k]):
            bit = (f >> k) & 1
            v ^= (bit * int(basis[k])) & M32
    return v


def bn_draw(bn, frame: int, dim: int):
    """Blue-noise dithered sample in [0,1):
    frac((mask_byte + 0.5)/256 + sobol_dim(frame)/2^32)."""
    d16 = dim & 15
    sh = 8 * (d16 & 3)
    byte = (bn[d16 >> 2] >> sh) & 0xFF
    mask_f = bits_f32((byte << 15) | 0x3F800000) - (1.0 - 0.5 / 256.0)
    u = mask_f + to_unit_float_scalar(bn_sobol_scalar(frame, dim))
    return u - torch.floor(u)


class RandState:
    """Mutable dimension counter mirroring the reference's randIdx++ usage.
    `frame` is a host int (the engine's frame index)."""

    def __init__(self, px, py, frame: int, base_dim: int = 0, bn=None):
        self.px = px
        self.py = py
        self.frame = int(frame)
        self.dim = base_dim
        self.bn = bn
        if bn is None:
            h = pcg_hash(0x9E3779B9 ^ u32(px))
            self._base = pcg_hash(h ^ ((u32(py) * 9277) & M32))

    def next(self):
        if self.bn is not None:
            v = bn_draw(self.bn, self.frame, self.dim)
            self.dim += 1
            return v
        dim = self.dim & M32
        bits = pcg_hash(self._base ^ ((dim * 26699) & M32))
        stride = PHI2_X_BITS if (dim & 1) == 0 else PHI2_Y_BITS
        v = to_unit_float((bits + (((self.frame & M32) * stride) & M32)) & M32)
        self.dim += 1
        return v

    def next2(self):
        return self.next(), self.next()

    def next3(self):
        return self.next(), self.next(), self.next()
