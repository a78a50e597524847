"""Ray–triangle intersection for entity/decoration meshes (port of
rtvb_tpu/ops/triangles.py).

Brute force: every ray tests every triangle of the small packed soup
(T, 9) = [v0 | e1 | e2] (Möller–Trumbore).  `intersect_packed` launches the
hand-written kernel ``csrc/tri_kernel.cu`` (K2) for CUDA tensors and runs
`intersect_packed_plain` for CPU tensors.  Zero rows pad the soup and never
hit.  Ties keep the lowest triangle index, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels as K

BIG = 1e30
EPS = 1e-7
MAX_TRIS = 2048


class TriHit(NamedTuple):
    hit: torch.Tensor    # bool
    t: torch.Tensor
    tri: torch.Tensor    # i32 triangle index (-1 = miss)
    u: torch.Tensor      # barycentrics
    v: torch.Tensor


def intersect_packed_plain(o, d, tri_packed, t_cap=None) -> TriHit:
    """Plain PyTorch version: one masked Möller–Trumbore update per
    triangle over the whole ray array (any device)."""
    ox, oy, oz = o
    dx, dy, dz = d
    best_t = torch.full_like(ox, BIG)
    best_i = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    best_u = torch.zeros_like(ox)
    best_v = torch.zeros_like(ox)
    cap = best_t if t_cap is None else t_cap
    for i, row in enumerate(tri_packed.tolist()):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row
        if e1x == 0 and e1y == 0 and e1z == 0:
            continue                       # degenerate padding row
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok_det = torch.abs(det) > EPS
        inv_det = torch.where(ok_det, 1.0 / det, 0.0)
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > 1e-4) & (t < cap) & (t < best_t))
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, i, best_i)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)
    found = best_t < BIG
    return TriHit(hit=found, t=torch.where(found, best_t, BIG),
                  tri=torch.where(found, best_i, -1), u=best_u, v=best_v)


TRI = K.register(K.CudaKernel("tri", "rtvb_tri_box",
                              [K.P] * 8 + [K.I, K.I] + [K.P] * 5))


def intersect_packed_cuda(o, d, tri_packed, t_cap=None) -> TriHit:
    """Launch K2 (csrc/tri_kernel.cu) on CUDA tensors.  The kernel writes
    the hit into the returned torch.bool tensor and reads no cap plane
    when t_cap is None."""
    shape = o[0].shape
    dev = o[0].device
    rays = [K.as_input(f"ray{i}", a, torch.float32, shape, dev)
            for i, a in enumerate((*o, *d))]
    if t_cap is not None:
        t_cap = K.as_input("t_cap", t_cap, torch.float32, shape, dev)
    n_tri = tri_packed.shape[0]
    if n_tri > MAX_TRIS:
        raise ValueError(f"triangle soup {n_tri} > {MAX_TRIS}")
    tri = K.as_input("tri_packed", tri_packed, torch.float32, (n_tri, 9), dev)
    hit = torch.empty(shape, dtype=torch.bool, device=dev)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    u = torch.empty(shape, dtype=torch.float32, device=dev)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    TRI.launch(dev, *rays, t_cap, tri, rays[0].numel(), n_tri,
               hit, t, idx, u, v)
    return TriHit(hit=hit, t=t, tri=idx, u=u, v=v)


def intersect_packed(o, d, tri_packed, t_cap=None) -> TriHit:
    """o, d: SoA rays (contiguous, one shape); tri_packed: (T, 9)."""
    if K.on_cuda(o[0]):
        return intersect_packed_cuda(o, d, tri_packed, t_cap)
    return intersect_packed_plain(o, d, tri_packed, t_cap)
