"""Vector/graphics math helpers over torch tensors (port of
rtvb_tpu/ops/mathutil.py).

A "Vec3" is a tuple (x, y, z) of equally-shaped tensors (SoA), exactly as
in the JAX package.  Expressions keep the JAX package's operation order so
both round alike.
"""
from __future__ import annotations

import math

import torch

Vec3 = tuple


def maximum(a, b):
    """jnp.maximum for tensor/scalar mixes (NaN-propagating like jnp)."""
    if isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, min=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, min=a)
    return max(a, b)


def minimum(a, b):
    if isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, max=a)
    return min(a, b)


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def splat(c, like) -> Vec3:
    z = torch.full_like(like, c)
    return (z, z, z)


def add(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a: Vec3, s) -> Vec3:
    return (a[0] * s, a[1] * s, a[2] * s)


def neg(a: Vec3) -> Vec3:
    return (-a[0], -a[1], -a[2])


def dot(a: Vec3, b: Vec3):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: Vec3, b: Vec3) -> Vec3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def sqrt(x):
    """Correctly rounded f32 square root on every device.  torch's CPU
    sqrt is not (about 20% of f32 results differ from IEEE in the last
    bit), while CUDA's sqrtf and XLA's are; a sqrt taken in f64 and rounded
    once to f32 is exact (53 ≥ 2·24 + 2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def length(a: Vec3):
    return sqrt(dot(a, a))


def length_sq(a: Vec3):
    return dot(a, a)


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = torch.rsqrt(maximum(dot(a, a), eps))
    return scale(a, inv)


def where3(c, a: Vec3, b: Vec3) -> Vec3:
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]),
            torch.where(c, a[2], b[2]))


def luminance(r, g=None, b=None):
    if g is None:
        r, g, b = r
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def pow_weight(x, e: float):
    """x**e by repeated squaring when e is a power-of-two integer (the
    denoiser's phi_normal=64 case) — the same multiplies as the JAX package
    and the à-trous CUDA kernel."""
    n = int(e)
    if float(n) == float(e) and n > 0 and (n & (n - 1)) == 0:
        while n > 1:
            x = x * x
            n >>= 1
        return x
    return x ** e


def sign_pm(c):
    """where(c, 1.0, -1.0) as float32."""
    return torch.where(c, 1.0, -1.0).to(torch.float32)


def orthonormal_basis(n: Vec3):
    """Branchless ONB from a unit normal (Duff et al. 2017)."""
    s = sign_pm(n[2] >= 0.0)
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    t = (1.0 + s * n[0] * n[0] * a, s * b, -s * n[0])
    bt = (b, s + n[1] * n[1] * a, -n[1])
    return t, bt


def from_local(v: Vec3, t: Vec3, bt: Vec3, n: Vec3) -> Vec3:
    return add(add(scale(t, v[0]), scale(bt, v[1])), scale(n, v[2]))


def cosine_sample_hemisphere(u1, u2) -> Vec3:
    r = sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = sqrt(maximum(1.0 - u1, 0.0))
    return (x, y, z)


def uniform_sample_cone(u1, u2, cos_theta_max) -> Vec3:
    cos_t = 1.0 - u1 * (1.0 - cos_theta_max)
    sin_t = sqrt(maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u2
    return (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def reflect(i: Vec3, n: Vec3) -> Vec3:
    d = 2.0 * dot(i, n)
    return sub(i, scale(n, d))


def nan_scrub(x, repl=0.0):
    return torch.where(torch.isfinite(x), x, repl)
