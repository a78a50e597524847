"""Bit-packing helpers: 2×bf16-in-f32 pairs + octahedral unit vectors (port
of rtvb_tpu/ops/pack.py).

Bit patterns are handled as int32 views; intermediate unsigned arithmetic
runs in int64 so no int32 operation ever overflows.  Encoding rounds to
nearest-even on the dropped mantissa bits, bit-identical to the JAX
package.
"""
from __future__ import annotations

import torch

_U32 = 1 << 32


def u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value → int32 with the same bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - _U32, v).to(torch.int32)


def i32_to_u32(v: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern → int64 holding the unsigned value."""
    return v.to(torch.int64) & 0xFFFFFFFF


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def bits_f32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).contiguous().view(torch.float32)


def _to_bf16_bits(x):
    """f32 → bf16 bit pattern (int64 in [0, 0xFFFF]), RNE rounding."""
    b = i32_to_u32(f32_bits(x))
    lsb = (b >> 16) & 1
    b = b + 0x7FFF + lsb
    return (b >> 16) & 0xFFFF


def _from_bf16_bits(lo16):
    return bits_f32(u32_to_i32((lo16 & 0xFFFF) << 16))


def pack2(a, b):
    """Two f32 tensors → one f32 tensor holding (bf16(a) | bf16(b) << 16)."""
    bits = _to_bf16_bits(a) | (_to_bf16_bits(b) << 16)
    return bits_f32(u32_to_i32(bits))


def unpack2(p):
    """Inverse of pack2: f32 pair-carrier → (a, b) as f32."""
    bits = i32_to_u32(f32_bits(p))
    return _from_bf16_bits(bits), _from_bf16_bits(bits >> 16)


def pack_int(a, b, bits_a: int):
    """Two non-negative ints → one f32 bit-carrier (a | b << bits_a)."""
    v = a.to(torch.int32) | (b.to(torch.int32) << bits_a)
    return bits_f32(v)


def unpack_int(p, bits_a: int):
    v = f32_bits(p)
    return v & ((1 << bits_a) - 1), v >> bits_a


def _sign_nz(x):
    return torch.sign(torch.where(x == 0.0, 1.0, x))


def octa_encode(n):
    """Unit vector (SoA 3-tuple) → octahedral (u, v) in [-1, 1]²."""
    x, y, z = n
    norm = torch.abs(x) + torch.abs(y) + torch.abs(z)
    norm = torch.clamp(norm, min=1e-12)
    u = x / norm
    v = y / norm
    uf = (1.0 - torch.abs(v)) * _sign_nz(u)
    vf = (1.0 - torch.abs(u)) * _sign_nz(v)
    neg = z < 0.0
    return torch.where(neg, uf, u), torch.where(neg, vf, v)


def octa_decode(u, v):
    z = 1.0 - torch.abs(u) - torch.abs(v)
    uf = (1.0 - torch.abs(v)) * _sign_nz(u)
    vf = (1.0 - torch.abs(u)) * _sign_nz(v)
    neg = z < 0.0
    x = torch.where(neg, uf, u)
    y = torch.where(neg, vf, v)
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-12))
    return x * inv, y * inv, z * inv
