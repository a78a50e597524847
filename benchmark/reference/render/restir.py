"""Temporal ReSTIR DI: packed reservoir storage, reprojection and reuse
(port of rtvb_tpu/render/restir.py).

A stored reservoir is eight f32 planes (see `ReSTIRState`); planes 0, 1,
2, 4, 6 and 7 carry int / bf16-pair bit patterns, so they are only ever
moved as 32-bit words (the nearest warp, K5) and unpacked through int32
views.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import mathutil as m
from ..ops import bsdf as B
from ..ops.alias_table import take
from ..ops.dda import BIG
from ..ops.pack import octa_decode, octa_encode, pack2, pack_int, unpack2, \
    unpack_int
from ..ops.rng import frame_tensor
from ..ops.warp_kernel import warp_nearest
from ..world.lighting import light_radiance, reconstruct_light_point

KIND_NONE, KIND_LOCAL, KIND_SUN, KIND_SKY = 0, 1, 2, 3
M_CAP = 20


class ReSTIRState(NamedTuple):
    """Per-pixel stored reservoirs packed into 8 f32 planes:

        0  kind|slot   (int pack, 2 bits kind)    4  M|le_b  (bf16 pair)
        1  fa|fb       (bf16 pair)                5  depth   (f32)
        2  du|dv       (bf16 pair, octa dir)      6  nu|nv   (bf16 pair)
        3  W           (f32)                      7  le_r|le_g (bf16 pair)
    """
    data: torch.Tensor     # (8, H, W) f32


def pack_state(kind, slot, fa, fb, dir3, W, M, depth, n3, le) -> ReSTIRState:
    du, dv = octa_encode(dir3)
    nu, nv = octa_encode(n3)
    return ReSTIRState(data=torch.stack([
        pack_int(kind, slot, 2), pack2(fa, fb), pack2(du, dv), W,
        pack2(M, le[2]), depth, pack2(nu, nv), pack2(le[0], le[1])]))


def initial_state(h: int, w: int, device="cpu") -> ReSTIRState:
    data = torch.zeros((8, h, w), dtype=torch.float32, device=device)
    data[5].fill_(BIG)
    return ReSTIRState(data=data)


def shift_clamped(arr, dy, dx, axes):
    """out[y, x] = arr[clamp(y - dy), clamp(x - dx)] along `axes`: the
    edge-clamped roll of the JAX package's _shift_dyn.  The offsets are
    0-d int64 tensors on arr's device (or host ints)."""
    ay, ax = axes
    H, W = arr.shape[ay], arr.shape[ax]
    dev = arr.device
    rows = torch.clamp(torch.arange(H, device=dev) - dy, 0, H - 1)
    cols = torch.clamp(torch.arange(W, device=dev) - dx, 0, W - 1)
    return arr.index_select(ay, rows).index_select(ax, cols)


def reconstruct_sample(state_kind, state_slot, fa, fb, sdir, p, lights,
                       stored_le):
    """(dir, dist, le) of a stored light sample at surface point p."""
    cslot = torch.clamp(state_slot, 0, lights.v0x.shape[0] - 1)
    lp = reconstruct_light_point(lights, cslot, fa, fb)
    to_l = m.sub(lp, p)
    dist_l = m.sqrt(torch.clamp(m.length_sq(to_l), min=1e-6))
    dir_local = m.scale(to_l, 1.0 / dist_l)
    le_local = light_radiance(lights, cslot)
    is_local = state_kind == KIND_LOCAL
    is_sun = state_kind == KIND_SUN
    is_sky = state_kind == KIND_SKY
    zero = torch.zeros_like(lp[0])
    le = m.where3(is_sun | is_sky, stored_le, (zero, zero, zero))
    wi = m.where3(is_local, dir_local, sdir)
    dist = torch.where(is_local, dist_l, BIG)
    le = m.where3(is_local, le_local, le)
    return wi, dist, le


def target_pdf(mat, n, wo, wi, le):
    f_lum, _ = B.eval_lum(mat, n, wo, wi)
    cos_i = torch.clamp(m.dot(n, wi), min=0.0)
    return f_lum * cos_i * m.luminance(le)


def tap_offsets(frame_idx, n_taps: int) -> list:
    """The frame-varying integer offsets of taps 1+ (dy, dx of tap t at
    2(t-1), 2(t-1)+1), each in [-2, 2]: 0-d int64 tensors computed from
    the device frame index (0-d int64 tensor), as the JAX package traces
    them."""
    primes = (2, 3, 5, 7, 11, 13, 17, 19)
    fi = frame_idx.to(torch.int64)
    return [((fi * primes[i % len(primes)] + (i + 1)) % 5 - 2)
            * (-1 if i % 3 == 2 else 1)
            for i in range(2 * max(n_taps - 1, 0) + 2)]


def warp_taps(prev: ReSTIRState, motion_u, motion_v, frame_idx,
              n_taps: int):
    """Warped previous-reservoir fetches: tap 0 is the nearest
    reprojection (K5), taps 1+ edge-clamped frame-varying offsets of it
    (`tap_offsets`; frame_idx a 0-d int64 tensor or a host int).
    Returns [(planes (8, H, W), valid (H, W) bool)]."""
    H, W_img = motion_u.shape
    dev = motion_u.device
    u_cur = ((torch.arange(W_img, device=dev) + 0.5)[None, :] / W_img).to(
        torch.float32)
    v_cur = (1.0 - (torch.arange(H, device=dev) + 0.5)[:, None] / H).to(
        torch.float32)
    inb0 = (torch.abs(motion_u) < 1.5) & (torch.abs(motion_v) < 1.5)
    mu = torch.where(inb0, motion_u, 0.0)
    mv = torch.where(inb0, motion_v, 0.0)
    sx = ((u_cur + mu) * W_img - 0.5).contiguous()
    sy = ((1.0 - (v_cur + mv)) * H - 0.5).contiguous()
    got0, wvalid = warp_nearest(prev.data, sy, sx)
    valid0 = inb0 & wvalid

    if n_taps > 1:
        offs = tap_offsets(frame_tensor(frame_idx, dev), n_taps)
    taps = [(got0, valid0)]
    for t in range(1, n_taps):
        dy, dx = offs[2 * (t - 1)], offs[2 * (t - 1) + 1]
        # the planes move as int32 words: no float op touches the bits
        words = shift_clamped(got0.view(torch.int32), dy, dx, (1, 2))
        taps.append((words.view(torch.float32),
                     shift_clamped(valid0, dy, dx, (0, 1))))
    return taps


def temporal_combine(cur_kind, cur_slot, cur_face, cur_fa, cur_fb, cur_dir,
                     cur_dist, cur_le, cur_wsum, cur_phat,
                     prev: ReSTIRState, motion_u, motion_v, depth, n, p, wo,
                     mat, lights, remap, u_takes, frame_idx=0,
                     n_taps: int = 3, disocclusion_threshold: float = 0.2):
    """Merge the current RIS reservoir with n_taps reprojected previous
    reservoirs (GRIS with confidence weights, M-cap 20).  Returns
    (kind, slot, face, fa, fb, dir, dist, le, phat, wsum, M, W)."""
    n_taps = min(n_taps, len(u_takes))
    raw_taps = warp_taps(prev, motion_u, motion_v, frame_idx, n_taps)

    W_cur = torch.where(cur_phat > 1e-9,
                        cur_wsum / torch.clamp(cur_phat, min=1e-9), 0.0)
    r_kind, r_slot, r_face = cur_kind, cur_slot, cur_face
    r_fa, r_fb, r_dir, r_dist = cur_fa, cur_fb, cur_dir, cur_dist
    r_le, r_phat = cur_le, cur_phat

    taps = []
    for t in range(n_taps):
        tap, tvalid = raw_taps[t]
        pk, pslot = unpack_int(tap[0], 2)
        pfa, pfb = unpack2(tap[1])
        pdir = octa_decode(*unpack2(tap[2]))
        pW = tap[3]
        pM, ple_b = unpack2(tap[4])
        pdepth = tap[5]
        pn = octa_decode(*unpack2(tap[6]))
        ple_r, ple_g = unpack2(tap[7])
        pface = torch.zeros_like(pk)

        depth_ok = torch.abs(pdepth - depth) <= \
            disocclusion_threshold * torch.clamp(depth, min=1.0)
        normal_ok = m.dot(pn, n) > 0.8
        valid = tvalid & depth_ok & normal_ok & (pk != KIND_NONE) & \
            (depth < BIG)

        remapped = take(remap, pslot)
        local_gone = (pk == KIND_LOCAL) & (remapped < 0)
        pslot = torch.where(pk == KIND_LOCAL, torch.clamp(remapped, min=0),
                            pslot)
        valid = valid & ~local_gone

        pwi, pdist, ple = reconstruct_sample(pk, pslot, pfa, pfb, pdir, p,
                                             lights, (ple_r, ple_g, ple_b))
        phat_prev = torch.where(valid, target_pdf(mat, n, wo, pwi, ple), 0.0)
        pM = torch.where(valid, torch.clamp(pM, max=float(M_CAP)), 0.0)
        taps.append((pk, pslot, pface, pfa, pfb, pwi, pdist, ple,
                     phat_prev, pW, pM, valid))

    c_total = 1.0 + sum(tp[10] for tp in taps)
    wsum = (1.0 / c_total) * cur_phat * W_cur
    for t, (pk, pslot, pface, pfa, pfb, pwi, pdist, ple,
            phat_prev, pW, pM, valid) in enumerate(taps):
        w_t = (pM / c_total) * phat_prev * pW
        new_wsum = wsum + w_t
        take_it = valid & ((u_takes[t] * torch.clamp(new_wsum, min=1e-20))
                           < w_t)
        r_kind = torch.where(take_it, pk, r_kind)
        r_slot = torch.where(take_it, pslot, r_slot)
        r_face = torch.where(take_it, pface, r_face)
        r_fa = torch.where(take_it, pfa, r_fa)
        r_fb = torch.where(take_it, pfb, r_fb)
        r_dir = m.where3(take_it, pwi, r_dir)
        r_dist = torch.where(take_it, pdist, r_dist)
        r_le = m.where3(take_it, ple, r_le)
        r_phat = torch.where(take_it, phat_prev, r_phat)
        wsum = new_wsum

    M_new = c_total
    W_new = torch.where(r_phat > 1e-9,
                        wsum / torch.clamp(r_phat, min=1e-9), 0.0)
    return (r_kind, r_slot, r_face, r_fa, r_fb, r_dir, r_dist, r_le,
            r_phat, wsum, M_new, W_new)
