"""Fused per-bounce shading: NEE streaming RIS + temporal-ReSTIR combine +
winner shading + BSDF continuation sample (port of
rtvb_tpu/render/ris_kernel.py).

`fused_shade` is the entry point: for CUDA tensors it launches the
hand-written kernel ``csrc/shade_kernel.cu`` (K4); for CPU tensors it runs
`fused_shade_plain`, the plain PyTorch version of the JAX package's
`_fused_body`.  Both draw the same RNG stream (ops/rng.py: blue-noise byte
planes when `cfg.blue_noise`, else PCG + R2 keyed by the wave's own pixel
coordinates plus `y0`) and produce the 26 planes of `ShadeOut`.

The light tables are flat (N_LF, K) f32 and (N_LI, K) i32 rows indexed by
slot with a clamp — no (R, 128) lane layout — and the env sampler is two
(·, 32) rows.  Reciprocals are always exact (the JAX package's approximate
ones were a TPU-only option).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import kernels as K
from ..ops import bsdf as B
from ..ops import mathutil as m
from ..ops import rng
from ..ops.alias_table import take
from ..ops.dda import BIG
from ..ops.pack import octa_decode, unpack2, unpack_int
from . import sky as sky_mod

KIND_NONE, KIND_LOCAL, KIND_SUN, KIND_SKY = 0, 1, 2, 3

# f32 light-field rows of the (N_LF, K) table
LF_V0X, LF_V0Y, LF_V0Z = 0, 1, 2
LF_E1X, LF_E1Y, LF_E1Z = 3, 4, 5
LF_E2X, LF_E2Y, LF_E2Z = 6, 7, 8
LF_NX, LF_NY, LF_NZ = 9, 10, 11
LF_AREA = 12
LF_RADR, LF_RADG, LF_RADB = 13, 14, 15
LF_PROB, LF_PMF = 16, 17
N_LF = 18
# i32 light-field rows of the (N_LI, K) table
LI_ALIAS, LI_ENT, LI_REMAP = 0, 1, 2
N_LI = 3

ENV_N = sky_mod.ENV_W * sky_mod.ENV_H
_ENV_OMEGA = 2.0 * math.pi / ENV_N

# K4's staged tile: 128 pixels of every input plane (csrc/shade_kernel.cu
# TILE), and for its generic instance the launch's Sobol terms after it
SHADE_TILE = 128


class ShadeConfig(NamedTuple):
    """Static shape of one bounce's estimator."""
    n_local: int          # local-light RIS candidates
    n_taps: int           # temporal reservoir taps (0 = no ReSTIR reuse)
    k_slots: int          # light-table slot count
    base_dim: int         # RNG dimension offset of this bounce
    ent_unreachable: bool  # entity lights carry full NEE MIS weight
    m_cap: float
    dis_thr: float        # temporal-tap relative depth tolerance
    blue_noise: bool = False   # draws from ops/rng.bn_draw byte planes


class ShadeOut(NamedTuple):
    """SoA outputs of one fused-shade pass (all pixel-shaped)."""
    kind: torch.Tensor     # i32 winner kind
    slot: torch.Tensor     # i32 winner light slot
    fa: torch.Tensor       # winner barycentrics
    fb: torch.Tensor
    dir: tuple             # winner direction
    dist: torch.Tensor
    le: tuple              # winner radiance
    phat: torch.Tensor
    M: torch.Tensor        # merged confidence (candidates + capped tap M)
    W: torch.Tensor        # unbiased contribution weight
    nee: tuple             # pre-visibility contribution f·cosθ·Le·W
    wi: tuple              # BSDF continuation direction
    weight: tuple          # BSDF throughput multiplier
    is_delta: torch.Tensor         # i32 0/1
    is_transmission: torch.Tensor  # i32 0/1
    prev_cos_pdf: torch.Tensor     # eval_lum pdf proxy at wi (MIS)


def flatten_out(o: ShadeOut) -> list:
    """The 26 planes in the JAX package's `_flatten_out` order."""
    return [o.kind, o.slot, o.fa, o.fb, *o.dir, o.dist, *o.le, o.phat,
            o.M, o.W, *o.nee, *o.wi, *o.weight, o.is_delta,
            o.is_transmission, o.prev_cos_pdf]


def unflatten_out(vs) -> ShadeOut:
    return ShadeOut(kind=vs[0], slot=vs[1], fa=vs[2], fb=vs[3],
                    dir=tuple(vs[4:7]), dist=vs[7], le=tuple(vs[8:11]),
                    phat=vs[11], M=vs[12], W=vs[13], nee=tuple(vs[14:17]),
                    wi=tuple(vs[17:20]), weight=tuple(vs[20:23]),
                    is_delta=vs[23], is_transmission=vs[24],
                    prev_cos_pdf=vs[25])


N_OUT = 26
OUT_I32 = (0, 1, 23, 24)   # kind, slot, is_delta, is_transmission


# ---------------------------------------------------------------------------
# per-frame tables
# ---------------------------------------------------------------------------

def pack_light_tables(lights, light_remap=None):
    """(N_LF, K) f32 light fields and (N_LI, K) i32 alias / entity / remap
    rows.  The remap is sized to the PREVIOUS frame's table (its domain is
    stored prev-frame slot ids): identity-extended when the table grew,
    truncated when it shrank."""
    K_ = lights.prob.shape[0]
    dev = lights.prob.device
    lf = torch.stack([
        lights.v0x, lights.v0y, lights.v0z, lights.e1x, lights.e1y,
        lights.e1z, lights.e2x, lights.e2y, lights.e2z, lights.nx, lights.ny,
        lights.nz, lights.area, lights.rad_r, lights.rad_g, lights.rad_b,
        lights.prob, lights.pmf]).to(torch.float32).contiguous()
    if light_remap is None:
        remap = torch.arange(K_, dtype=torch.int32, device=dev)
    else:
        remap = light_remap.to(device=dev, dtype=torch.int32)
        rlen = remap.shape[0]
        if rlen < K_:
            remap = torch.cat([remap, torch.arange(
                rlen, K_, dtype=torch.int32, device=dev)])
        elif rlen > K_:
            remap = remap[:K_]
    li = torch.stack([lights.alias.to(torch.int32),
                      lights.ent.to(torch.int32), remap]).contiguous()
    return lf, li


def pack_env_tables(sky_state):
    """(2, ENV_N) f32 prob / pmf rows and (1, ENV_N) i32 alias row of the
    env sampler."""
    envf = torch.stack([sky_state.env_prob, sky_state.env_pmf]).to(
        torch.float32).contiguous()
    envi = sky_state.env_alias.to(torch.int32).reshape(1, -1).contiguous()
    return envf, envi


# ---------------------------------------------------------------------------
# the plain PyTorch version (the JAX package's `_fused_body`)
# ---------------------------------------------------------------------------

def _tap_planes(planes):
    return [planes[c] for c in range(8)]


def fused_shade_plain(cfg: ShadeConfig, frame_idx, y0, sf, lf, li, envf,
                      envi, p, n, wo, alb, rough, metal, trans, depth=None,
                      taps=(), bn=None) -> ShadeOut:
    """One bounce's estimator over (H, W) SoA tensors (any device).

    p is the SHADING point (hit + normal·eps); taps are n_taps
    (planes (8, H, W) or 8 planes, valid (H, W)) warped reservoir fetches;
    bn the four blue-noise byte planes when cfg.blue_noise."""
    shape = p[0].shape
    H, W = shape
    dev = p[0].device
    K_ = cfg.k_slots
    mat = B.Material(albedo_r=alb[0], albedo_g=alb[1], albedo_b=alb[2],
                     roughness=rough, metallic=metal, translucency=trans)
    rcp = lambda x: 1.0 / x
    frame_u = rng.frame_tensor(frame_idx, dev)

    lgf = lambda row, slot: take(lf[row], slot)
    lgi = lambda row, slot: take(li[row], slot)

    if cfg.blue_noise:
        rs = rng.RandState(None, None, frame_u, cfg.base_dim, bn=tuple(bn))
    else:
        # the wave's own coordinates (not the frame's pixel ids: the
        # half-res bounces count 0..W/2-1), rows offset by y0
        px = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
        py = torch.arange(H, dtype=torch.int64, device=dev)[:, None] + int(y0)
        rs = rng.RandState(px.expand(H, W), py.expand(H, W), frame_u,
                           cfg.base_dim)
    draw = rs.next

    zf = torch.zeros(shape, dtype=torch.float32, device=dev)
    zi = torch.zeros(shape, dtype=torch.int32, device=dev)

    def stream(state, wi, dist, le, src_pdf, u, kind, slot=None, fa=None,
               fb=None, mis_w=1.0, force_full=None):
        (r_kind, r_slot, r_fa, r_fb, r_dir, r_dist, r_le, r_phat,
         wsum) = state
        f_lum, pdf_b = B.eval_lum(mat, n, wo, wi)
        cos_i = torch.clamp(m.dot(n, wi), min=0.0)
        p_hat = f_lum * cos_i * m.luminance(le)
        balance = src_pdf * rcp(torch.clamp(src_pdf + pdf_b, min=1e-9))
        if force_full is not None:
            balance = torch.where(force_full, 1.0, balance)
        w = torch.where(src_pdf > 1e-9, mis_w * balance * p_hat
                        * rcp(torch.clamp(src_pdf, min=1e-9)), 0.0)
        wsum = wsum + w
        take_it = (u * torch.clamp(wsum, min=1e-20)) < w
        sel = lambda a, b: torch.where(take_it, a, b)
        return (sel(torch.full_like(zi, kind), r_kind),
                sel(slot if slot is not None else zi, r_slot),
                sel(fa if fa is not None else zf, r_fa),
                sel(fb if fb is not None else zf, r_fb),
                m.where3(take_it, wi, r_dir), sel(dist, r_dist),
                m.where3(take_it, le, r_le), sel(p_hat, r_phat), wsum)

    state = (zi, zi, zf, zf, (zf, zf, zf), torch.full_like(zf, BIG),
             (zf, zf, zf), zf, zf)
    any_lights = sf[sky_mod.SF_ANY_LIGHTS] > 0.5

    # local light candidates
    for _ in range(cfg.n_local):
        u_slot, u_take = draw(), draw()
        u1, u2, u3 = draw(), draw(), draw()
        del u1  # third draw kept for stream parity (cube-light legacy slot)
        un = u_slot * K_
        col = torch.clamp(un.to(torch.int32), 0, K_ - 1)
        frac = un - col.to(torch.float32)
        slot = torch.where(frac < lgf(LF_PROB, col), col, lgi(LI_ALIAS, col))
        pmf = lgf(LF_PMF, slot)
        flip = (u2 + u3) > 1.0
        fa = torch.where(flip, 1.0 - u2, u2)
        fb = torch.where(flip, 1.0 - u3, u3)
        lp = tuple(lgf(LF_V0X + c, slot) + fa * lgf(LF_E1X + c, slot)
                   + fb * lgf(LF_E2X + c, slot) for c in range(3))
        ln = (lgf(LF_NX, slot), lgf(LF_NY, slot), lgf(LF_NZ, slot))
        area = lgf(LF_AREA, slot)
        to_l = m.sub(lp, p)
        dist2 = torch.clamp(m.length_sq(to_l), min=1e-6)
        inv_dist = torch.rsqrt(dist2)
        dist = dist2 * inv_dist
        wi = m.scale(to_l, inv_dist)
        cos_l = torch.clamp(m.dot(ln, m.neg(wi)), min=0.0)
        pdf_sa = pmf * rcp(torch.clamp(area, min=1e-8)) * dist2 \
            * rcp(torch.clamp(cos_l, min=1e-6))
        le = (lgf(LF_RADR, slot), lgf(LF_RADG, slot), lgf(LF_RADB, slot))
        le = m.where3((cos_l > 0.0) & any_lights, le, (zf, zf, zf))
        force_full = (lgi(LI_ENT, slot) > 0) if cfg.ent_unreachable else None
        state = stream(state, wi, dist, le, pdf_sa, u_take, KIND_LOCAL,
                       slot=slot, fa=fa, fb=fb, mis_w=1.0 / cfg.n_local,
                       force_full=force_full)

    # sun candidate: uniform cone around the sun direction
    u1, u2 = draw(), draw()
    u_take = draw()
    cos_max = sf[sky_mod.SF_COS_SUN]
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = m.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u2
    local = (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    sun = (sf[sky_mod.SF_SUN_X], sf[sky_mod.SF_SUN_Y], sf[sky_mod.SF_SUN_Z])
    t_, bt_ = m.orthonormal_basis(sun)
    wi_sun = m.from_local(local, t_, bt_, sun)
    le_sun = sky_mod.sun_radiance_scalars_cone(sin_t, sf)
    state = stream(state, wi_sun, torch.full_like(zf, BIG), le_sun,
                   sf[sky_mod.SF_PDF_SUN].expand(shape), u_take, KIND_SUN)

    # sky candidate: env alias sample + analytic radiance
    u1, u2, u3 = draw(), draw(), draw()
    u_take = draw()
    un = u1 * ENV_N
    col = torch.clamp(un.to(torch.int32), 0, ENV_N - 1)
    frac = un - col.to(torch.float32)
    texel = torch.where(frac < take(envf[0], col), col, take(envi[0], col))
    pmf = take(envf[1], texel)
    iu = (texel % sky_mod.ENV_W).to(torch.float32)
    iv = (texel // sky_mod.ENV_W).to(torch.float32)
    phi = (2.0 * math.pi) * (iu + u2) * (1.0 / sky_mod.ENV_W)
    cos_t = 1.0 - (iv + u3) * (1.0 / sky_mod.ENV_H)
    sin_t = m.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    wi_sky = (sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
    pdf_sky = pmf * (1.0 / _ENV_OMEGA)
    le_sky = sky_mod.sky_radiance_scalars(wi_sky, sf, rcp=rcp,
                                          rsqrt=torch.rsqrt)
    state = stream(state, wi_sky, torch.full_like(zf, BIG), le_sky, pdf_sky,
                   u_take, KIND_SKY)

    (r_kind, r_slot, r_fa, r_fb, r_dir, r_dist, r_le, r_phat, wsum) = state

    # temporal reservoir combine (restir.temporal_combine role)
    if cfg.n_taps > 0:
        u_takes = [draw() for _ in range(cfg.n_taps)]
        cur_phat = r_phat
        W_cur = torch.where(cur_phat > 1e-9, wsum * rcp(
            torch.clamp(cur_phat, min=1e-9)), 0.0)
        tap_vals = []
        for planes, tvalid in taps:
            planes = _tap_planes(planes)
            pk, pslot = unpack_int(planes[0], 2)
            pfa, pfb = unpack2(planes[1])
            pdir = octa_decode(*unpack2(planes[2]))
            pW = planes[3]
            pM, ple_b = unpack2(planes[4])
            pdepth = planes[5]
            pn = octa_decode(*unpack2(planes[6]))
            ple_r, ple_g = unpack2(planes[7])

            depth_ok = torch.abs(pdepth - depth) <= \
                cfg.dis_thr * torch.clamp(depth, min=1.0)
            normal_ok = m.dot(pn, n) > 0.8
            valid = (tvalid != 0) & depth_ok & normal_ok \
                & (pk != KIND_NONE) & (depth < BIG)

            remapped = lgi(LI_REMAP, torch.clamp(pslot, 0, K_ - 1))
            is_local = pk == KIND_LOCAL
            valid = valid & ~(is_local & (remapped < 0))
            pslot = torch.where(is_local, torch.clamp(remapped, min=0), pslot)

            # reconstruct the stored sample at the current surface
            cslot = torch.clamp(pslot, 0, K_ - 1)
            lp = tuple(lgf(LF_V0X + c, cslot) + pfa * lgf(LF_E1X + c, cslot)
                       + pfb * lgf(LF_E2X + c, cslot) for c in range(3))
            to_l = m.sub(lp, p)
            d2 = torch.clamp(m.length_sq(to_l), min=1e-6)
            inv_d = torch.rsqrt(d2)
            dir_local = m.scale(to_l, inv_d)
            le_local = (lgf(LF_RADR, cslot), lgf(LF_RADG, cslot),
                        lgf(LF_RADB, cslot))
            is_dist = (pk == KIND_SUN) | (pk == KIND_SKY)
            ple = m.where3(is_dist, (ple_r, ple_g, ple_b), (zf, zf, zf))
            pwi = m.where3(is_local, dir_local, pdir)
            pdist = torch.where(is_local, d2 * inv_d, BIG)
            ple = m.where3(is_local, le_local, ple)

            f_lum, _ = B.eval_lum(mat, n, wo, pwi)
            cos_i = torch.clamp(m.dot(n, pwi), min=0.0)
            phat_prev = torch.where(valid, f_lum * cos_i * m.luminance(ple),
                                    0.0)
            pM = torch.where(valid, torch.clamp(pM, max=cfg.m_cap), 0.0)
            tap_vals.append((pk, pslot, pfa, pfb, pwi, pdist, ple,
                             phat_prev, pW, pM, valid))

        c_total = 1.0 + sum(tv[9] for tv in tap_vals)
        inv_ct = rcp(c_total)
        wsum = inv_ct * cur_phat * W_cur
        for t, (pk, pslot, pfa, pfb, pwi, pdist, ple, phat_prev, pW, pM,
                valid) in enumerate(tap_vals):
            w_t = (pM * inv_ct) * phat_prev * pW
            wsum = wsum + w_t
            take_it = valid & ((u_takes[t] * torch.clamp(wsum, min=1e-20))
                               < w_t)
            sel = lambda a, b: torch.where(take_it, a, b)
            r_kind = sel(pk, r_kind)
            r_slot = sel(pslot, r_slot)
            r_fa = sel(pfa, r_fa)
            r_fb = sel(pfb, r_fb)
            r_dir = m.where3(take_it, pwi, r_dir)
            r_dist = sel(pdist, r_dist)
            r_le = m.where3(take_it, ple, r_le)
            r_phat = sel(phat_prev, r_phat)
        M_new = c_total
    else:
        M_new = torch.full_like(zf, float(cfg.n_local + 2))

    W_new = torch.where(r_phat > 1e-9, wsum * rcp(
        torch.clamp(r_phat, min=1e-9)), 0.0)

    # winner shading (pre-visibility): full per-channel BSDF
    fv, _ = B.evaluate(mat, n, wo, r_dir)
    cos2 = torch.clamp(m.dot(n, r_dir), min=0.0)
    nee = tuple(fc * cos2 * lc * W_new for fc, lc in zip(fv, r_le))

    # BSDF continuation sample + MIS pdf proxy
    u1, u2, u3 = draw(), draw(), draw()
    samp = B.sample(mat, n, wo, u1, u2, u3)
    _, pcp = B.eval_lum(mat, n, wo, samp.wi)
    pcp = torch.where(samp.is_delta, 0.0, pcp)

    return ShadeOut(kind=r_kind, slot=r_slot, fa=r_fa, fb=r_fb, dir=r_dir,
                    dist=r_dist, le=r_le, phat=r_phat, M=M_new, W=W_new,
                    nee=nee, wi=samp.wi, weight=samp.weight,
                    is_delta=samp.is_delta.to(torch.int32),
                    is_transmission=samp.is_transmission.to(torch.int32),
                    prev_cos_pdf=pcp)


# ---------------------------------------------------------------------------
# the CUDA kernel (K4)
# ---------------------------------------------------------------------------

_PTRS = ctypes.POINTER(ctypes.c_void_p)
SHADE = K.register(K.CudaKernel(
    "shade", "rtvb_shade_dev",
    [_PTRS, K.I, _PTRS, _PTRS, K.P, K.P, K.P, K.P, K.P, K.P]
    + [K.I] * 3 + [K.P] + [K.I] * 6 + [K.F, K.F, K.P]))


# the form K4 takes the sine and cosine of one angle in (one sincosf);
# not a kernel of the frame, so not registered with the launch counts
SIN_COS = K.CudaKernel("sin_cos", "rtvb_sin_cos",
                       [K.P, K.P, K.P, ctypes.c_longlong])


def sin_cos_cuda(x: torch.Tensor):
    """(sin x, cos x) of a CUDA float32 tensor as K4 computes them, to hold
    them against torch.sin and torch.cos, which the plain version calls."""
    x = K.as_input("x", x, torch.float32, None, x.device)
    s, c = torch.empty_like(x), torch.empty_like(x)
    SIN_COS.launch(x.device, x, s, c, x.numel())
    return s, c


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def shade_smem_bytes(cfg: ShadeConfig) -> int:
    """Dynamic shared memory a K4 launch at cfg's counts asks for at most
    (its generic instance's: the staged tile of every input plane and the
    launch's Sobol terms)."""
    n_in = 15 + (1 + 9 * cfg.n_taps if cfg.n_taps else 0) \
        + (4 if cfg.blue_noise else 0)
    n_draws = 5 * cfg.n_local + 10 + cfg.n_taps
    return 4 * (n_in * SHADE_TILE + (n_draws if cfg.blue_noise else 0))


def fused_shade_cuda(cfg: ShadeConfig, frame_idx, y0, sf, lf, li, envf,
                     envi, p, n, wo, alb, rough, metal, trans, depth=None,
                     taps=(), bn=None) -> ShadeOut:
    """Launch K4 on the current stream: every input checked, outputs
    allocated here (one (4, H, W) i32 and one (22, H, W) f32 tensor).
    The frame index reaches the kernel from device memory (a 0-d int64
    tensor; a host int is placed there first), so a captured graph
    replays with each frame's own index."""
    H, W = p[0].shape
    dev = p[0].device
    K_ = cfg.k_slots
    if cfg.n_taps < 0 or cfg.n_local < 0:
        raise ValueError(f"negative counts in {cfg}")
    # the card's shared memory bounds the counts: the staged tile of every
    # input plane must fit a block (with ~1 KB of the kernel's own tables)
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", None)
    if limit is not None and shade_smem_bytes(cfg) + 1024 > limit:
        raise ValueError(
            f"K4 at n_taps {cfg.n_taps}, n_local {cfg.n_local} stages "
            f"{shade_smem_bytes(cfg)} bytes a block; the card holds {limit}")
    if len(taps) != cfg.n_taps:
        raise ValueError(f"{len(taps)} taps given, cfg.n_taps {cfg.n_taps}")
    f32, i32 = torch.float32, torch.int32
    sf = K.as_input("sf", sf, f32, (sky_mod.SF_LEN,), dev)
    lf = K.as_input("lf", lf, f32, (N_LF, K_), dev)
    li = K.as_input("li", li, i32, (N_LI, K_), dev)
    envf = K.as_input("envf", envf, f32, (2, ENV_N), dev)
    envi = K.as_input("envi", envi, i32, (1, ENV_N), dev)
    planes = [*p, *n, *wo, *alb, rough, metal, trans]
    names = ["px", "py", "pz", "nx", "ny", "nz", "wox", "woy", "woz",
             "albr", "albg", "albb", "rough", "metal", "trans"]
    ins = [K.as_input(nm, t, f32, (H, W), dev) for nm, t in zip(names,
                                                                planes)]
    if cfg.n_taps:
        ins.append(K.as_input("depth", depth, f32, (H, W), dev))
        for t, (tp, tv) in enumerate(taps):
            tp = _tap_planes(tp)
            ins += [K.as_input(f"tap{t}[{c}]", tp[c], f32, (H, W), dev)
                    for c in range(8)]
            ins.append(K.as_input(f"tap{t}.valid", tv, i32, (H, W), dev))
    basis = rng.bn_basis(dev)
    # the kernel reads the low 32 bits of an int64 frame index
    if not (isinstance(frame_idx, torch.Tensor)
            and frame_idx.dtype == torch.int64):
        frame_idx = rng.frame_tensor(frame_idx, dev)
    frame = K.as_input("frame", frame_idx, torch.int64, (), dev)
    if cfg.blue_noise:
        if bn is None or len(bn) != 4:
            raise ValueError("blue_noise needs the four bn byte planes")
        ins += [K.as_input(f"bn[{c}]", bn[c], i32, (H, W), dev)
                for c in range(4)]
    out_i = torch.empty((len(OUT_I32), H, W), dtype=i32, device=dev)
    out_f = torch.empty((N_OUT - len(OUT_I32), H, W), dtype=f32, device=dev)
    # room for the input planes' pointers, which the generic instance reads
    # from device memory (a kernel on the stream writes them there)
    in_tab = torch.empty(len(ins), dtype=torch.int64, device=dev)
    SHADE.launch(dev, _ptr_array(ins), len(ins),
                 _ptr_array(list(out_f)), _ptr_array(list(out_i)),
                 sf, lf, li, envf, envi, basis, H, W, int(y0),
                 frame, K_, cfg.n_local, cfg.n_taps,
                 cfg.base_dim, int(cfg.ent_unreachable), int(cfg.blue_noise),
                 float(cfg.m_cap), float(cfg.dis_thr), in_tab)
    it_i, it_f = iter(out_i), iter(out_f)
    return unflatten_out([next(it_i) if k in OUT_I32 else next(it_f)
                          for k in range(N_OUT)])


def fused_shade(cfg: ShadeConfig, frame_idx, y0, sf, lf, li, envf, envi,
                p, n, wo, alb, rough, metal, trans, depth=None, taps=(),
                bn=None) -> ShadeOut:
    """Run the fused estimator for one bounce: K4 for CUDA tensors, the
    plain version for CPU tensors (kernels.on_cuda)."""
    if K.on_cuda(p[0]):
        return fused_shade_cuda(cfg, frame_idx, y0, sf, lf, li, envf, envi,
                                p, n, wo, alb, rough, metal, trans, depth,
                                taps, bn)
    return fused_shade_plain(cfg, frame_idx, y0, sf, lf, li, envf, envi, p,
                             n, wo, alb, rough, metal, trans, depth, taps, bn)
