"""Ray ↔ voxel-grid traversal: 2-D column DDA with y-bitmask resolution
(port of rtvb_tpu/ops/dda.py).

`trace` is the entry point: for CUDA tensors it launches the hand-written
kernel ``csrc/trace_kernel.cu`` (K1); for CPU tensors it runs
`trace_plain`, the plain PyTorch version of the same march.  Both return
the block's material index at the hit (the epilogue of the TPU trace
kernel: schema block id, lower-bound search of the exception list,
block → material), so the path tracer never re-derives it.

Unsigned 32-bit column masks are held as int32 bit patterns; the plain
version widens them to int64 so every shift is a logical shift.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels as K

BIG = 1e30
EPS = 1e-6
M32 = 0xFFFFFFFF


class TraceParams(NamedTuple):
    """Static world-shape constants baked into the trace."""
    x: int
    y: int
    z: int
    super_size: int
    super_z: int
    max_steps: int


class TraceTables(NamedTuple):
    """World + material tables the march and its epilogue read (flat, on
    the rays' device)."""
    colmask: torch.Tensor     # (X·Z,) int32 (u32 bits)
    df: torch.Tensor          # (128,) int32 supercolumn Chebyshev DF
    maxh: torch.Tensor        # (128,) int32 supercolumn height envelope
    schema: torch.Tensor      # (X·Z,) int32
    exc_mask: torch.Tensor    # (X·Z,) int32 (u32 bits)
    exc_key: torch.Tensor     # (K,) int32 ascending
    exc_id: torch.Tensor      # (K,) int32
    block_to_mat: torch.Tensor  # (B,) int32


class HitRecord(NamedTuple):
    hit: torch.Tensor     # bool
    t: torch.Tensor       # f32 ray parameter at hit (BIG on miss)
    ix: torch.Tensor      # i32 hit voxel (None for any-hit records)
    iy: torch.Tensor
    iz: torch.Tensor
    nx: torch.Tensor      # f32 face normal (axis aligned, unit)
    ny: torch.Tensor
    nz: torch.Tensor
    mi: torch.Tensor      # i32 material index of the voxel at (ix, iy, iz)


def trace_tables(world, mats) -> TraceTables:
    return TraceTables(colmask=world.colmask, df=world.df_super,
                       maxh=world.maxh_super, schema=world.schema,
                       exc_mask=world.exc_mask, exc_key=world.exc_key,
                       exc_id=world.exc_id, block_to_mat=mats.block_to_mat)


def trace_params(cfg, max_steps: int) -> TraceParams:
    return TraceParams(x=cfg.x, y=cfg.y, z=cfg.z, super_size=cfg.super_size,
                       super_z=cfg.super_z, max_steps=max_steps)


def _log2(n: int) -> int:
    assert n & (n - 1) == 0
    return n.bit_length() - 1


def floor_i32(x: torch.Tensor) -> torch.Tensor:
    """floor → int32 with the out-of-range values saturated at ±2³⁰ (the
    kernels clamp identically; every caller clips far inside that)."""
    return torch.clamp(torch.floor(x), -1073741824.0, 1073741824.0).to(
        torch.int32)


def _bit_index_lsb(bits):
    """Index of the least-significant set bit of a u32 held in int64."""
    b = bits & ((~bits + 1) & M32)
    idx = torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    for shift in (16, 8, 4, 2, 1):
        big = (b >> shift) != 0
        idx = idx + torch.where(big, shift, 0).to(torch.int32)
        b = torch.where(big, b >> shift, b)
    return idx


def _bit_index_msb(bits):
    b = bits
    idx = torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    for shift in (16, 8, 4, 2, 1):
        big = (b >> shift) != 0
        idx = idx + torch.where(big, shift, 0).to(torch.int32)
        b = torch.where(big, b >> shift, b)
    return idx


def _range_mask(ylo, yhi):
    """u32 (int64-held) with bits [ylo, yhi] set (0 if yhi < ylo)."""
    ylo_c = torch.clamp(ylo, 0, 31).to(torch.int64)
    yhi_c = torch.clamp(yhi, 0, 31).to(torch.int64)
    hi_mask = torch.where(yhi_c >= 31, M32, (1 << (yhi_c + 1)) - 1)
    lo_mask = (1 << ylo_c) - 1
    mask = hi_mask & (~lo_mask & M32)
    return torch.where(yhi >= ylo, mask, 0)


def material_index(tables: TraceTables, p: TraceParams, ix, iy, iz):
    """The trace epilogue: block id from the column schema, overridden by
    the exception list (lower-bound search), then block → material."""
    n_cols = p.x * p.z
    c = torch.clamp(ix * p.z + iz, 0, n_cols - 1).long()
    sch = tables.schema[c]
    emask = tables.exc_mask[c].to(torch.int64) & M32
    h1 = sch & 31
    h2 = (sch >> 5) & 31
    bid = torch.where(iy < h1, (sch >> 10) & 63,
                      torch.where(iy < h2, (sch >> 16) & 63, (sch >> 22) & 63))
    has_exc = ((emask >> torch.clamp(iy, 0, 31).to(torch.int64)) & 1) == 1
    key = (c.to(torch.int32) * p.y + iy).contiguous()
    keys = tables.exc_key
    lo = torch.clamp(torch.searchsorted(keys, key), 0, keys.shape[0] - 1)
    found = keys[lo] == key
    bid = torch.where(has_exc & found, tables.exc_id[lo], bid)
    b2m = tables.block_to_mat
    return b2m[torch.clamp(bid, 0, b2m.shape[0] - 1).long()]


def trace_plain(o, d, tables: TraceTables, p: TraceParams, t_cap=None,
                any_hit: bool = False, tally: list | None = None
                ) -> HitRecord:
    """Plain PyTorch version of the trace (the JAX package's dda.trace with
    the whole-array masked while loop, on any device).  `tally`, if given,
    gets the count of live rays at the start of each sub-step (0-d
    tensors)."""
    ox, oy, oz = o
    dx, dy, dz = d
    f32 = torch.float32
    X, Y, Z = p.x, p.y, p.z
    colmask = tables.colmask.to(torch.int64) & M32
    df_row = tables.df
    maxh_row = tables.maxh

    def safe(v):
        return torch.where(torch.abs(v) < EPS,
                           torch.where(v >= 0, EPS, -EPS).to(f32), v)

    inv_dx, inv_dy, inv_dz = 1.0 / safe(dx), 1.0 / safe(dy), 1.0 / safe(dz)
    tx0 = (0.0 - ox) * inv_dx
    tx1 = (X - ox) * inv_dx
    tz0 = (0.0 - oz) * inv_dz
    tz1 = (Z - oz) * inv_dz
    ty0 = (0.0 - oy) * inv_dy
    ty1 = (Y - oy) * inv_dy

    def slab(lo_t, hi_t, d_axis, o_axis, size):
        tin = torch.minimum(lo_t, hi_t)
        tout = torch.maximum(lo_t, hi_t)
        degen = torch.abs(d_axis) < EPS
        inside = (o_axis >= 0.0) & (o_axis < size)
        tin = torch.where(degen, torch.where(inside, -BIG, BIG).to(f32), tin)
        tout = torch.where(degen, torch.where(inside, BIG, -BIG).to(f32), tout)
        return tin, tout

    txi, txo = slab(tx0, tx1, dx, ox, X)
    tzi, tzo = slab(tz0, tz1, dz, oz, Z)
    tyi, tyo = slab(ty0, ty1, dy, oy, Y)
    t_enter = torch.maximum(torch.maximum(txi, tzi), torch.clamp(tyi, min=0.0))
    t_exit = torch.minimum(torch.minimum(txo, tzo), tyo)
    if t_cap is not None:
        t_exit = torch.minimum(t_exit, t_cap)
    # global ascending-ray exit cap at the world's height envelope (its
    # maximum read from the table, as the kernel does)
    maxh_g = maxh_row.max().to(f32)
    t_gm = (maxh_g - oy) * inv_dy
    t_exit = torch.where(dy > EPS, torch.minimum(t_exit, t_gm), t_exit)
    miss_from_start = t_enter >= t_exit

    t = t_enter + EPS
    px = ox + dx * t
    pz = oz + dz * t
    ix = torch.clamp(floor_i32(px), 0, X - 1)
    iz = torch.clamp(floor_i32(pz), 0, Z - 1)

    step_x = torch.where(dx >= 0, 1, -1).to(torch.int32)
    step_z = torch.where(dz >= 0, 1, -1).to(torch.int32)
    pos_x = (step_x > 0).to(torch.int32)
    pos_z = (step_z > 0).to(torch.int32)
    tdelta_x = torch.abs(inv_dx)
    tdelta_z = torch.abs(inv_dz)
    tmax_x = ((ix + pos_x).to(f32) - ox) * inv_dx
    tmax_z = ((iz + pos_z).to(f32) - oz) * inv_dz

    ss = p.super_size
    sl = _log2(ss)
    max_d = torch.maximum(torch.abs(dx), torch.abs(dz))

    enter_axis = torch.where((tyi >= txi) & (tyi >= tzi), 1,
                             torch.where(txi >= tzi, 0, 2)).to(torch.int32)
    alive = ~miss_from_start
    hit = torch.zeros_like(alive)
    zi = torch.zeros_like(ix)
    last_axis = enter_axis
    hit_t = torch.full_like(t, BIG)
    hit_ix, hit_iy, hit_iz, hit_axis = zi, zi, zi, zi

    def body():
        nonlocal t, ix, iz, tmax_x, tmax_z, alive, hit, last_axis
        nonlocal hit_t, hit_ix, hit_iy, hit_iz, hit_axis
        if tally is not None:
            tally.append(alive.sum())
        t0 = t
        t1 = torch.minimum(torch.minimum(tmax_x, tmax_z), t_exit)
        inb = (ix >= 0) & (ix < X) & (iz >= 0) & (iz < Z)
        c = torch.clamp(ix * Z + iz, 0, X * Z - 1).long()
        word = torch.where(inb, colmask[c], 0)
        ya = oy + dy * t0
        yb = oy + dy * t1
        ylo = floor_i32(torch.minimum(ya, yb))
        yhi = floor_i32(torch.maximum(ya, yb) - EPS)
        yhi = torch.maximum(yhi, ylo)
        rmask = _range_mask(torch.clamp(ylo, min=0),
                            torch.clamp(yhi, max=Y - 1))
        hitbits = word & rmask
        got = alive & (hitbits != 0)
        if not any_hit:
            yv = torch.where(dy >= 0, _bit_index_lsb(hitbits),
                             _bit_index_msb(hitbits))
            ty_enter = (torch.where(dy >= 0, yv, yv + 1).to(f32) - oy) * inv_dy
            t_hit = torch.maximum(t0, ty_enter)
            y_face = ty_enter > t0
            axis = torch.where(y_face, 1, last_axis).to(torch.int32)
            new_hit = got & ~hit
            hit_t = torch.where(new_hit, t_hit, hit_t)
            hit_ix = torch.where(new_hit, ix, hit_ix)
            hit_iy = torch.where(new_hit, yv, hit_iy)
            hit_iz = torch.where(new_hit, iz, hit_iz)
            hit_axis = torch.where(new_hit, axis, hit_axis)
        s_hit = hit | got

        take_x = tmax_x < tmax_z
        t_next = torch.where(take_x, tmax_x, tmax_z)
        nix = torch.where(take_x, ix + step_x, ix)
        niz = torch.where(take_x, iz, iz + step_z)
        ntmx = torch.where(take_x, tmax_x + tdelta_x, tmax_x)
        ntmz = torch.where(take_x, tmax_z, tmax_z + tdelta_z)

        scx = nix >> sl
        scz = niz >> sl
        sidx = torch.clamp(scx * p.super_z + scz, 0, 127).long()
        jt = t_next
        maxh = maxh_row[sidx].to(f32)
        y_next = oy + dy * t_next
        above = y_next >= maxh + EPS
        t_cx = (((scx + pos_x) << sl).to(f32) - ox) * inv_dx
        t_cz = (((scz + pos_z) << sl).to(f32) - oz) * inv_dz
        t_cell = torch.minimum(t_cx, t_cz)
        t_env = torch.where(dy < -EPS, (maxh - oy) * inv_dy,
                            torch.full_like(maxh, BIG))
        t_skip = torch.minimum(t_cell, t_env)
        jt = torch.where(above, torch.maximum(jt, t_skip), jt)

        df = df_row[sidx]
        t_df = t_next + ((df - 1) * ss).to(f32) / torch.clamp(max_d, min=EPS)
        jt = torch.where((word == 0) & (df >= 2) & (max_d > EPS),
                         torch.maximum(jt, t_df), jt)

        can_jump = jt > t_next + EPS
        jt = torch.minimum(jt + EPS, t_exit)
        jix = torch.clamp(floor_i32(ox + dx * jt), 0, X - 1)
        jiz = torch.clamp(floor_i32(oz + dz * jt), 0, Z - 1)
        jtmx = ((jix + pos_x).to(f32) - ox) * inv_dx
        jtmz = ((jiz + pos_z).to(f32) - oz) * inv_dz
        nix = torch.where(can_jump, jix, nix)
        niz = torch.where(can_jump, jiz, niz)
        ntmx = torch.where(can_jump, jtmx, ntmx)
        ntmz = torch.where(can_jump, jtmz, ntmz)
        t_next = torch.where(can_jump, jt, t_next)

        oob = (nix < 0) | (nix >= X) | (niz < 0) | (niz >= Z)
        done = got | (t_next >= t_exit) | oob
        upd = alive & ~done
        t = torch.where(upd, t_next, t)
        ix = torch.where(upd, nix, ix)
        iz = torch.where(upd, niz, iz)
        tmax_x = torch.where(upd, ntmx, tmax_x)
        tmax_z = torch.where(upd, ntmz, tmax_z)
        if not any_hit:
            last_axis = torch.where(upd, torch.where(take_x, 0, 2).to(
                torch.int32), last_axis)
        alive = alive & ~done
        hit = s_hit

    # two sub-steps per iteration of the JAX while loop: an odd cap runs
    # max_steps + 1 sub-steps there, and here
    for _ in range(0, p.max_steps, 2):
        if not bool(alive.any()):
            break
        body()
        body()

    if any_hit:
        return HitRecord(hit=hit, t=torch.where(hit, t, BIG).to(f32),
                         ix=None, iy=None, iz=None, nx=None, ny=None,
                         nz=None, mi=None)
    zf = torch.zeros_like(dx)
    nx = torch.where(hit_axis == 0, -torch.sign(dx), zf)
    ny = torch.where(hit_axis == 1, -torch.sign(dy), zf)
    nz = torch.where(hit_axis == 2, -torch.sign(dz), zf)
    mi = material_index(tables, p, hit_ix, hit_iy, hit_iz)
    return HitRecord(hit=hit, t=torch.where(hit, hit_t, BIG).to(f32),
                     ix=hit_ix, iy=hit_iy, iz=hit_iz, nx=nx, ny=ny, nz=nz,
                     mi=mi)


def substeps(o, d, tables: TraceTables, p: TraceParams, t_cap=None,
             any_hit: bool = False) -> int:
    """Sub-steps the march runs for these rays: the sum over the rays of
    the column steps each is alive for (K1's loop trips), counted by the
    plain version.  The work of a trace depends on this, not on the ray
    count alone."""
    tally: list = []
    trace_plain(o, d, tables, p, t_cap, any_hit, tally)
    return int(torch.stack(tally).sum()) if tally else 0


TRACE = K.register(K.CudaKernel(
    "trace", "rtvb_trace",
    [K.P] * 7 + [K.I] + [K.P] * 8 + [K.I] * 9 + [K.P] * 9))


def trace_cuda(o, d, tables: TraceTables, p: TraceParams, t_cap=None,
               any_hit: bool = False) -> HitRecord:
    """Launch K1 (csrc/trace_kernel.cu) on CUDA tensors."""
    shape = o[0].shape
    dev = o[0].device
    rays = [K.as_input(f"ray{i}", a, torch.float32, shape, dev)
            for i, a in enumerate((*o, *d))]
    n = rays[0].numel()
    if t_cap is None:
        t_cap = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    t_cap = K.as_input("t_cap", t_cap, torch.float32, shape, dev)
    n_cols = p.x * p.z
    tabs = [K.as_input("colmask", tables.colmask, torch.int32, (n_cols,), dev),
            K.as_input("df", tables.df, torch.int32, (128,), dev),
            K.as_input("maxh", tables.maxh, torch.int32, (128,), dev),
            K.as_input("schema", tables.schema, torch.int32, (n_cols,), dev),
            K.as_input("exc_mask", tables.exc_mask, torch.int32, (n_cols,),
                       dev),
            K.as_input("exc_key", tables.exc_key, torch.int32, None, dev),
            K.as_input("exc_id", tables.exc_id, torch.int32,
                       tables.exc_key.shape, dev),
            K.as_input("block_to_mat", tables.block_to_mat, torch.int32,
                       None, dev)]
    n_exc = tabs[5].shape[0]
    if n_exc & (n_exc - 1):
        raise ValueError(f"exception list length {n_exc} is not a power of 2")
    _log2(p.super_size)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hit = torch.empty(shape, **i32)
    t = torch.empty(shape, **f32)
    if any_hit:
        outs = [hit, t] + [None] * 7
    else:
        outs = [hit, t, torch.empty(shape, **i32), torch.empty(shape, **i32),
                torch.empty(shape, **i32), torch.empty(shape, **f32),
                torch.empty(shape, **f32), torch.empty(shape, **f32),
                torch.empty(shape, **i32)]
    TRACE.launch(dev, *rays, t_cap, n, *tabs, n_exc,
                 tabs[7].shape[0], p.x, p.y, p.z, p.super_size, p.super_z,
                 p.max_steps, int(any_hit), *outs)
    if any_hit:
        return HitRecord(hit=hit != 0, t=t, ix=None, iy=None, iz=None,
                         nx=None, ny=None, nz=None, mi=None)
    return HitRecord(hit != 0, *outs[1:])


def trace(o, d, tables: TraceTables, p: TraceParams, t_cap=None,
          any_hit: bool = False) -> HitRecord:
    """Trace rays against the voxel world: K1 on CUDA tensors, the plain
    version on CPU tensors."""
    if K.on_cuda(o[0]):
        return trace_cuda(o, d, tables, p, t_cap, any_hit)
    return trace_plain(o, d, tables, p, t_cap, any_hit)
