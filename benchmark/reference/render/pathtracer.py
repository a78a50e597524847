"""Wavefront path tracer (port of rtvb_tpu/render/pathtracer.py).

Every bounce is one trace wave over all pixels (K1, plus K2 for the
entity/decoration triangles), then the bounce's direct lighting and BSDF
continuation: with `fused_shading` (the shipped default) one call of the
fused shade kernel (K4, render/ris_kernel.py); without it the in-line
composition in plain PyTorch (streaming RIS `_nee_ris` → temporal ReSTIR
combine → BSDF continuation sample).
The NEE visibility rays of all bounces are deferred into one batched
any-hit wave per resolution; with half-res GI, bounces ≥ 1 trace one
representative path per 2×2 quad.  The RNG stream (dimension order) is
the JAX package's, draw for draw.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.config import RenderingSettings

from ..assets import textures
from ..core.camera import Camera, camera_rays, pixel_uv
from ..ops import bsdf as B
from ..ops import mathutil as m
from ..ops import rng
from ..ops import triangles as tri_ops
from ..ops.alias_table import take
from ..ops.dda import BIG, HitRecord, TraceParams, TraceTables, trace
from ..world.lighting import LightTable, light_radiance, sample_light_point
from . import restir as restir_mod
from . import ris_kernel
from . import sky as sky_mod

SPAWN_EPS = 1e-3
REGULARIZE_ROUGHNESS = 0.35


def spawn_eps(p):
    mx = torch.maximum(torch.abs(p[0]),
                       torch.maximum(torch.abs(p[1]), torch.abs(p[2])))
    return torch.clamp(1e-5 * mx, min=SPAWN_EPS)


class EntityBuffers(NamedTuple):
    """Triangle soup of the decorations and live entities (padded with
    zero rows to a pow2; render/soup.py)."""
    tri_packed: torch.Tensor   # (T, 9) [v0 | e1 | e2]
    normals: torch.Tensor      # (T, 3)
    prev_v0: torch.Tensor      # (T, 3) previous-frame vertices
    prev_v1: torch.Tensor
    prev_v2: torch.Tensor
    mat_index: torch.Tensor    # (T,) i32
    light_slot: torch.Tensor   # (T,) i32, -1 = not a light
    uvs: torch.Tensor          # (T, 6)
    image_id: torch.Tensor     # (T,) i32, -1 = untextured


class GBuffers(NamedTuple):
    illum: tuple
    albedo: tuple
    normal: tuple
    depth: torch.Tensor
    roughness: torch.Tensor
    motion_u: torch.Tensor
    motion_v: torch.Tensor
    emissive_first: torch.Tensor
    # picked-block edge mask (H, W) f32 in {0, 1}; None unless
    # block_highlight was requested
    highlight: torch.Tensor = None


class Reservoir(NamedTuple):
    dir: tuple
    dist: torch.Tensor
    le: tuple
    target_pdf: torch.Tensor
    wsum: torch.Tensor
    m_count: torch.Tensor
    kind: torch.Tensor
    slot: torch.Tensor
    face: torch.Tensor
    fa: torch.Tensor
    fb: torch.Tensor


def material_from_index(mats, mi, min_roughness):
    g = lambda t: take(t, mi)
    mat = B.Material(
        albedo_r=g(mats.albedo[:, 0]), albedo_g=g(mats.albedo[:, 1]),
        albedo_b=g(mats.albedo[:, 2]),
        roughness=torch.maximum(g(mats.roughness), min_roughness),
        metallic=g(mats.metallic), translucency=g(mats.translucency))
    emis = (g(mats.emissive[:, 0]), g(mats.emissive[:, 1]),
            g(mats.emissive[:, 2]))
    return mat, emis, g(mats.texture_id), g(mats.uv_scale)


def _nee_ris(rs: rng.RandState, lights: LightTable, sky, p, n, wo, mat,
             n_local: int, sun_cos_max, ent_unreachable: bool = False):
    """Streaming RIS over n_local local-light + 1 sun + 1 sky candidates."""
    shape = p[0].shape
    dev = p[0].device
    zi = torch.zeros(shape, dtype=torch.int32, device=dev)
    zf = torch.zeros(shape, dtype=torch.float32, device=dev)
    res = Reservoir(dir=(zf, zf, zf), dist=torch.full_like(zf, BIG),
                    le=(zf,) * 3, target_pdf=zf, wsum=zf, m_count=zi,
                    kind=zi, slot=zi, face=zi, fa=zf, fb=zf)

    def stream(res, wi, dist, le, src_pdf, u, kind, slot=None, fa=None,
               fb=None, mis_w=1.0, force_full=None):
        f_lum, pdf_b = B.eval_lum(mat, n, wo, wi)
        cos_i = torch.clamp(m.dot(n, wi), min=0.0)
        p_hat = f_lum * cos_i * m.luminance(le)
        balance = src_pdf / torch.clamp(src_pdf + pdf_b, min=1e-9)
        if force_full is not None:
            balance = torch.where(force_full, 1.0, balance)
        w = torch.where(src_pdf > 1e-9, mis_w * balance * p_hat
                        / torch.clamp(src_pdf, min=1e-9), 0.0)
        wsum = res.wsum + w
        take_it = (u * torch.clamp(wsum, min=1e-20)) < w
        sel = lambda a, b: torch.where(take_it, a, b)
        return Reservoir(
            dir=m.where3(take_it, wi, res.dir), dist=sel(dist, res.dist),
            le=m.where3(take_it, le, res.le), target_pdf=sel(p_hat,
                                                              res.target_pdf),
            wsum=wsum, m_count=res.m_count + 1,
            kind=sel(torch.full_like(zi, kind), res.kind),
            slot=sel(slot if slot is not None else zi, res.slot),
            face=res.face,
            fa=sel(fa if fa is not None else zf, res.fa),
            fb=sel(fb if fb is not None else zf, res.fb))

    n_slots = lights.prob.shape[0]
    any_lights = lights.count > 0
    for _ in range(n_local):
        u_slot, u_take = rs.next2()
        u1, u2, u3 = rs.next3()
        un = u_slot * n_slots
        col = torch.clamp(un.to(torch.int32), 0, n_slots - 1)
        frac = un - col.to(torch.float32)
        slot = torch.where(frac < take(lights.prob, col), col,
                           take(lights.alias, col))
        pmf = take(lights.pmf, slot)
        lp, ln, pdf_area, (fa, fb) = sample_light_point(lights, slot, u1, u2,
                                                        u3)
        to_l = m.sub(lp, p)
        dist2 = torch.clamp(m.length_sq(to_l), min=1e-6)
        dist = m.sqrt(dist2)
        wi = m.scale(to_l, 1.0 / dist)
        cos_l = torch.clamp(m.dot(ln, m.neg(wi)), min=0.0)
        pdf_sa = pmf * pdf_area * dist2 / torch.clamp(cos_l, min=1e-6)
        le = light_radiance(lights, slot)
        keep = (cos_l > 0.0) & any_lights
        le = m.where3(keep, le, (zf, zf, zf))
        force_full = (take(lights.ent.to(torch.float32), slot) > 0.5) \
            if ent_unreachable else None
        res = stream(res, wi, dist, le, pdf_sa, u_take,
                     restir_mod.KIND_LOCAL, slot=slot, fa=fa, fb=fb,
                     mis_w=1.0 / n_local, force_full=force_full)

    u1, u2 = rs.next2()
    u_take = rs.next()
    local = m.uniform_sample_cone(u1, u2, sun_cos_max)
    t, bt = m.orthonormal_basis(sky.sun_dir)
    wi_sun = m.from_local(local, t, bt, sky.sun_dir)
    pdf_sun = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - sun_cos_max), min=1e-9)
    le_sun = sky_mod.sun_radiance_cone(u1, sky)
    res = stream(res, wi_sun, torch.full_like(zf, BIG), le_sun,
                 pdf_sun.expand(shape), u_take, restir_mod.KIND_SUN)

    u1, u2, u3 = rs.next3()
    u_take = rs.next()
    wi_sky, pdf_sky = sky_mod.sky_env_sample(sky, u1, u2, u3)
    le_sky = sky_mod.sky_radiance(wi_sky, sky)
    res = stream(res, wi_sky, torch.full_like(zf, BIG), le_sky, pdf_sky,
                 u_take, restir_mod.KIND_SKY)
    return res


def shade_reservoir_deferred(res: Reservoir, p, n, wo, mat, live):
    """Pre-visibility contribution + the visibility ray of the RIS winner."""
    W = torch.where(res.target_pdf > 1e-9,
                    res.wsum / torch.clamp(res.target_pdf, min=1e-9), 0.0)
    eps = spawn_eps(p)
    origin = m.add(p, m.scale(n, eps))
    cap = torch.clamp(res.dist - 2.0 * eps, min=0.0)
    live2 = live & (res.target_pdf > 1e-9)
    zero = torch.zeros_like(origin[0])
    sdir = m.where3(live2, res.dir, (zero, zero + 1.0, zero))
    cap = torch.where(live2, cap, 0.0)
    f, _ = B.evaluate(mat, n, wo, res.dir)
    cos_i = torch.clamp(m.dot(n, res.dir), min=0.0)
    rgb = tuple(fc * cos_i * lc * W for fc, lc in zip(f, res.le))
    return rgb, origin, sdir, cap


def _ds(a):
    """2×2-quad representative (top-left pixel)."""
    return a[0::2, 0::2].contiguous()


def _ds3(v):
    return (_ds(v[0]), _ds(v[1]), _ds(v[2]))


def _up(a):
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def _c3(v):
    return tuple(c.contiguous() for c in v)


def _picked_face_edges(vrec: HitRecord, p, t_hit, hit_now, cone_spread,
                       H: int, W: int, max_dist: float = 8.0):
    """Picked-block edge mask (H, W) f32 in {0, 1}.  The centre pixel's
    voxel-only primary hit is the pick; the 4 edges of its hit face are
    tested against every primary hit point by point-to-segment distance,
    the tolerance widened to ~1.5 px of world footprint.  Voxel (ix, iy,
    iz) spans the unit cube with corner (ix, iy, iz).  All on the rays'
    device: no host sync."""
    cy, cx = H // 2, W // 2
    pick = vrec.hit[cy, cx] & (vrec.t[cy, cx] < max_dist)
    bcx = vrec.ix[cy, cx].to(torch.float32) + 0.5
    bcy = vrec.iy[cy, cx].to(torch.float32) + 0.5
    bcz = vrec.iz[cy, cx].to(torch.float32) + 0.5
    nx0, ny0, nz0 = vrec.nx[cy, cx], vrec.ny[cy, cx], vrec.nz[cy, cx]
    x_face = torch.abs(nx0) > 0.5
    y_face = torch.abs(ny0) > 0.5
    zero = torch.zeros_like(nx0)
    # face-plane tangents: ±x faces → (y, z); ±y → (x, z); ±z → (x, y)
    t1 = (torch.where(x_face, 0.0, 1.0), torch.where(x_face, 1.0, 0.0), zero)
    t2 = (zero, torch.where(x_face | y_face, 0.0, 1.0),
          torch.where(x_face | y_face, 1.0, 0.0))
    fc = (bcx + 0.5 * nx0, bcy + 0.5 * ny0, bcz + 0.5 * nz0)
    corners = [tuple(fc[i] + s1 * t1[i] + s2 * t2[i] for i in range(3))
               for s1, s2 in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5),
                              (-0.5, 0.5))]
    tol = torch.clamp(t_hit * cone_spread * 1.5, min=0.006)
    d2_min = torch.full((H, W), BIG, dtype=torch.float32, device=p[0].device)
    for k in range(4):
        a, b = corners[k], corners[(k + 1) % 4]
        ab = (b[0] - a[0], b[1] - a[1], b[2] - a[2])      # unit-length edge
        pa = (p[0] - a[0], p[1] - a[1], p[2] - a[2])
        s = torch.clamp(pa[0] * ab[0] + pa[1] * ab[1] + pa[2] * ab[2],
                        0.0, 1.0)
        dx = pa[0] - s * ab[0]
        dy = pa[1] - s * ab[1]
        dz = pa[2] - s * ab[2]
        d2_min = torch.minimum(d2_min, dx * dx + dy * dy + dz * dz)
    mask = hit_now & pick & (d2_min < tol * tol)
    return mask.to(torch.float32)


def render_frame(cfg, tables: TraceTables, tp: TraceParams, mats,
                 lights: LightTable, sky, cam: Camera, hist_cam: Camera,
                 frame_idx, width: int, height: int,
                 rs_cfg: RenderingSettings, prev_restir=None,
                 light_remap=None, entities: EntityBuffers | None = None,
                 atlas=None, half_res_gi: bool = False,
                 block_highlight: bool = False, y0: int = 0,
                 rows: int | None = None):
    """One 1-spp path-traced frame → (GBuffers, new ReSTIRState | None).
    frame_idx is a 0-d int64 tensor on the frame's device (a host int is
    placed there): the RNG, K4 and the ReSTIR taps read it as a tensor,
    and no host value depends on a device value, so the frame can be
    captured in a CUDA graph.  block_highlight adds the picked block's
    edge mask (GBuffers.highlight) from the centre pixel's voxel-only
    primary hit.  y0 (a host int) and rows render the horizontal band of
    rows y0 .. y0 + rows - 1 of the `height`-tall image: the RNG, the blue
    noise, the camera rays, the motion vectors and K4 see the band's
    absolute rows, and every output is (rows, width)."""
    use_restir = prev_restir is not None
    y0 = int(y0)
    H, W = (height if rows is None else rows), width
    dev = cam.pos_x.device
    half_gi = (half_res_gi and H % 2 == 0 and W % 2 == 0
               and rs_cfg.total_bounce_limit > 1)
    px = torch.arange(W, dtype=torch.int64, device=dev)[None, :].expand(H, W)
    py = torch.arange(y0, y0 + H, dtype=torch.int64,
                      device=dev)[:, None].expand(H, W)
    frame_u = rng.frame_tensor(frame_idx, dev)

    bn_full = rng.bn_packed(H, W, y0, device=dev) if rs_cfg.blue_noise \
        else None
    bn_cur = bn_full     # the live wave's planes (half-res after GI)
    rs = rng.RandState(px, py, frame_u, 0, bn=bn_full)
    ju, jv = rs.next2()
    o, d = camera_rays(cam, W, height, ju, jv, y0=y0, rows=H)
    o, d = _c3(o), _c3(d)

    def trace_radiance(oo, dd):
        return trace(oo, dd, tables, tp)

    def trace_any(oo, dd, t_cap):
        srec = trace(oo, dd, tables, tp, t_cap=t_cap, any_hit=True)
        hit = srec.hit
        if entities is not None and rs_cfg.entity_shadows:
            sth = tri_ops.intersect_packed(
                oo, dd, entities.tri_packed,
                t_cap=torch.minimum(t_cap, srec.t))
            hit = hit | sth.hit
        return hit

    def neutralize(oo, dd, live):
        zero = torch.zeros_like(oo[0])
        miss_o = (zero, zero + 1e4, zero)
        miss_d = (zero, zero + 1.0, zero)
        return _c3(m.where3(live, oo, miss_o)), _c3(m.where3(live, dd, miss_d))

    f32 = dict(dtype=torch.float32, device=dev)
    L = [torch.zeros((H, W), **f32) for _ in range(3)]
    throughput = [torch.ones((H, W), **f32) for _ in range(3)]
    alive = torch.ones((H, W), dtype=torch.bool, device=dev)
    diffuse_count = torch.zeros((H, W), dtype=torch.int32, device=dev)
    min_roughness = torch.zeros((H, W), **f32)
    prev_delta = torch.ones((H, W), dtype=torch.bool, device=dev)
    prev_cos_pdf = torch.zeros((H, W), **f32)

    g_albedo = [torch.ones((H, W), **f32) for _ in range(3)]
    g_normal = [torch.zeros((H, W), **f32), torch.ones((H, W), **f32),
                torch.zeros((H, W), **f32)]
    g_depth = torch.full((H, W), BIG, **f32)
    g_rough = torch.ones((H, W), **f32)
    g_emissive = torch.zeros((H, W), dtype=torch.bool, device=dev)
    g_highlight = None

    sun_cos_max = sky.cos_sun_radius
    pdf_sun_cone = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - sun_cos_max),
                                     min=1e-9)
    spread = cam.pixel_cone_spread(height)

    fused = rs_cfg.fused_shading
    if fused:
        # per-frame tables of the fused shade kernel: light fields, light
        # ints with the id remap, env alias rows, sky/sun scalars
        lf_pack, li_pack = ris_kernel.pack_light_tables(lights, light_remap)
        envf_pack, envi_pack = ris_kernel.pack_env_tables(sky)
        sf_pack = sky_mod.sky_scalar_pack(sky, lights.count > 0)

    shadow_rays: list = []
    shadow_rgb: list = []
    restir_pending = None
    Lcur = L
    L_gi = None
    th0_full = None

    for bounce in range(rs_cfg.total_bounce_limit):
        rs.dim = 8 + bounce * 64
        if bounce > 0:
            o, d = neutralize(o, d, alive)
        rec: HitRecord = trace_radiance(o, d)
        rec_hit, rec_t = rec.hit, rec.t
        # rec stays the voxel-only record: the pick ignores entities

        test_ent = entities is not None and (bounce == 0
                                             or rs_cfg.entity_in_bounces)
        if test_ent:
            th = tri_ops.intersect_packed(o, d, entities.tri_packed,
                                          t_cap=rec.t)
            is_ent = th.hit
            tidx = torch.clamp(th.tri, 0, entities.normals.shape[0] - 1).long()
            en = entities.normals[tidx]
            eflip = torch.where(en[..., 0] * d[0] + en[..., 1] * d[1]
                                + en[..., 2] * d[2] > 0, -1.0, 1.0)
            ent_n = (en[..., 0] * eflip, en[..., 1] * eflip,
                     en[..., 2] * eflip)
            rec_hit = rec_hit | is_ent
            rec_t = torch.where(is_ent, th.t, rec_t)
        else:
            is_ent = torch.zeros_like(alive)

        sky_rgb = sky_mod.sky_radiance(d, sky)
        sun_rgb = sky_mod.sun_radiance(d, sky)
        if bounce == 0:
            mis_sky = mis_sun = 1.0
        else:
            pdf_b = prev_cos_pdf
            pdf_nee_sky = sky_mod.sky_env_pdf(sky, d)
            mis_sky = torch.where(prev_delta, 1.0, pdf_b / torch.clamp(
                pdf_b + pdf_nee_sky, min=1e-9))
            mis_sun = torch.where(prev_delta, 1.0, pdf_b / torch.clamp(
                pdf_b + pdf_sun_cone, min=1e-9))
        miss_now = alive & ~rec_hit
        for i in range(3):
            Lcur[i] = Lcur[i] + torch.where(
                miss_now,
                throughput[i] * (sky_rgb[i] * mis_sky + sun_rgb[i] * mis_sun),
                0.0)
        alive = alive & rec_hit

        n = (rec.nx, rec.ny, rec.nz)
        if test_ent:
            n = m.where3(is_ent, ent_n, n)
        p = m.add(o, m.scale(d, rec_t))
        wo = m.neg(d)
        if bounce == 0 and block_highlight:
            g_highlight = _picked_face_edges(rec, p, rec_t, rec_hit, spread,
                                             H, W)

        mi = rec.mi
        if test_ent:
            mi = torch.where(is_ent, take(entities.mat_index, tidx), mi)
        mat, emis, tex_id, uv_scale = material_from_index(mats, mi,
                                                          min_roughness)

        u, v = textures.triplanar_uv(p[0], p[1], p[2], n[0], n[1], n[2])
        inc = torch.clamp(torch.abs(m.dot(n, d)), min=0.25)
        lod = rec_t * spread * 8.0 / inc
        if bounce == 0:
            tex = textures.sample_scale(tex_id, u * uv_scale, v * uv_scale,
                                        lod)
            mat = mat._replace(albedo_r=mat.albedo_r * tex,
                               albedo_g=mat.albedo_g * tex,
                               albedo_b=mat.albedo_b * tex)

        authored = None
        use_img = None
        if atlas is not None and bounce == 0:
            from ..assets import image_textures
            img_id = take(mats.image_id, mi)
            u_s = u * uv_scale
            v_s = v * uv_scale
            if test_ent:
                euv = entities.uvs[tidx]
                w0e = 1.0 - th.u - th.v
                ue = w0e * euv[..., 0] + th.u * euv[..., 2] + th.v * euv[..., 4]
                ve = w0e * euv[..., 1] + th.u * euv[..., 3] + th.v * euv[..., 5]
                img_id = torch.where(is_ent, take(entities.image_id, tidx),
                                     img_id)
                u_s = torch.where(is_ent, ue, u_s)
                v_s = torch.where(is_ent, ve, v_s)
            authored = image_textures.sample_atlas(atlas, img_id, u_s, v_s,
                                                   lod)
            use_img = img_id >= 0
            mat = mat._replace(
                albedo_r=torch.where(use_img, authored.rgb[0], mat.albedo_r),
                albedo_g=torch.where(use_img, authored.rgb[1], mat.albedo_g),
                albedo_b=torch.where(use_img, authored.rgb[2], mat.albedo_b),
                roughness=torch.maximum(mat.roughness * authored.rough_mul,
                                        min_roughness))

        n_geom = n
        if bounce == 0 and rs_cfg.normal_mapping:
            du_t, dv_t = textures.sample_normal_delta(
                tex_id, u * uv_scale, v * uv_scale, lod)
            if authored is not None:
                du_t = torch.where(use_img, authored.du, du_t)
                dv_t = torch.where(use_img, authored.dv, dv_t)
            n_bent = textures.perturb_normal(n, du_t, dv_t)
            n = m.where3(is_ent | ~rec_hit, n, n_bent)

        is_emissive = (emis[0] + emis[1] + emis[2]) > 0.0

        if bounce == 0:
            mis_e = 1.0
        else:
            c_hit = torch.clamp(rec.ix * cfg.z + rec.iz, 0, cfg.n_cols - 1)
            key_e = ((c_hit * cfg.y + rec.iy) * 16).contiguous()
            keys = lights.key
            slot_v = torch.clamp(torch.searchsorted(keys, key_e), 0,
                                 keys.shape[0] - 1).to(torch.int32)
            found_v = keys[slot_v.long()] == key_e
            if test_ent:
                slot_t = take(entities.light_slot, tidx)
                slot_e = torch.where(is_ent, slot_t, slot_v)
                found_e = torch.where(is_ent, slot_t >= 0, found_v)
            else:
                slot_e, found_e = slot_v, found_v
            slot_e = torch.clamp(slot_e, 0, keys.shape[0] - 1)
            pmf_e = take(lights.pmf, slot_e)
            area_e = take(lights.area, slot_e)
            cos_le = torch.abs(n[0] * d[0] + n[1] * d[1] + n[2] * d[2])
            pdf_nee_e = torch.where(
                found_e, pmf_e * rec_t * rec_t
                / (torch.clamp(area_e, min=1e-8)
                   * torch.clamp(cos_le, min=1e-4)), 0.0)
            mis_e = torch.where(prev_delta, 1.0, prev_cos_pdf / torch.clamp(
                prev_cos_pdf + pdf_nee_e, min=1e-9))
        hit_emis = alive & is_emissive
        for i in range(3):
            Lcur[i] = Lcur[i] + torch.where(
                hit_emis, throughput[i] * emis[i] * mis_e, 0.0)

        if bounce == 0:
            first_hit = rec_hit
            alb = (mat.albedo_r, mat.albedo_g, mat.albedo_b)
            for i in range(3):
                g_albedo[i] = torch.where(first_hit, alb[i], 1.0)
                g_normal[i] = torch.where(first_hit, n_geom[i], g_normal[i])
            g_depth = torch.where(first_hit, rec_t, BIG)
            g_rough = torch.where(first_hit, mat.roughness, 1.0)
            g_emissive = hit_emis

            u_cur, v_cur = pixel_uv(W, height, ju, jv, y0=y0, rows=H,
                                    device=dev)
            p_ref = p
            if test_ent:
                w0 = 1.0 - th.u - th.v
                pv0 = entities.prev_v0[tidx]
                pv1 = entities.prev_v1[tidx]
                pv2 = entities.prev_v2[tidx]
                p_prev_ent = tuple(w0 * pv0[..., i] + th.u * pv1[..., i]
                                   + th.v * pv2[..., i] for i in range(3))
                p_ref = m.where3(is_ent, p_prev_ent, p)
            up_h, vp_h, okp = hist_cam.point_to_uv(p_ref)
            ud_h, vd_h, okd = hist_cam.dir_to_uv(d)
            ok = torch.where(first_hit, okp, okd)
            g_motion_u = torch.where(
                ok, torch.where(first_hit, up_h, ud_h) - u_cur, 2.0)
            g_motion_v = torch.where(
                ok, torch.where(first_hit, vp_h, vd_h) - v_cur, 2.0)

        alive = alive & ~is_emissive

        n_cand = rs_cfg.local_light_candidates if bounce == 0 else \
            min(rs_cfg.local_light_candidates,
                rs_cfg.secondary_light_candidates)
        eps_p = spawn_eps(p)
        ent_unreach = entities is not None and not rs_cfg.entity_in_bounces
        if fused:
            p_off = m.add(p, m.scale(n, eps_p))
            n_taps_b, taps = 0, ()
            if bounce == 0 and use_restir:
                n_taps_b = max(1, rs_cfg.restir_temporal_samples)
                taps = [(planes, tv.to(torch.int32)) for planes, tv in
                        restir_mod.warp_taps(prev_restir, g_motion_u,
                                             g_motion_v, frame_u, n_taps_b)]
            sh_cfg = ris_kernel.ShadeConfig(
                n_local=n_cand, n_taps=n_taps_b,
                k_slots=int(lights.prob.shape[0]), base_dim=8 + bounce * 64,
                ent_unreachable=ent_unreach,
                m_cap=float(restir_mod.M_CAP), dis_thr=0.2,
                blue_noise=bn_cur is not None)
            out = ris_kernel.fused_shade(
                sh_cfg, frame_u, y0, sf_pack, lf_pack, li_pack, envf_pack,
                envi_pack, _c3(p_off), _c3(n), _c3(wo),
                _c3((mat.albedo_r, mat.albedo_g, mat.albedo_b)),
                mat.roughness.contiguous(), mat.metallic.contiguous(),
                mat.translucency.contiguous(),
                depth=g_depth if n_taps_b else None, taps=taps, bn=bn_cur)
            nee = out.nee
            live2 = alive & (out.phat > 1e-9)
            zero = torch.zeros_like(p[0])
            vdir = m.where3(live2, out.dir, (zero, zero + 1.0, zero))
            vcap = torch.where(live2, torch.clamp(out.dist - 2.0 * eps_p,
                                                  min=0.0), 0.0)
            shadow_rays.append((p_off, vdir, vcap))
            if bounce == 0 and use_restir:
                restir_pending = (out.kind, out.slot, None, out.fa, out.fb,
                                  out.dir, out.le, out.M, out.W, alive, n)
        else:
            res = _nee_ris(rs, lights, sky, m.add(p, m.scale(n, eps_p)), n,
                           wo, mat, n_cand, sun_cos_max,
                           ent_unreachable=ent_unreach)
            if bounce == 0 and use_restir:
                n_taps = max(1, rs_cfg.restir_temporal_samples)
                u_takes = tuple(rs.next() for _ in range(n_taps))
                (k2, s2, f2, fa2, fb2, dir2, dist2, le2, phat2, wsum2, M2,
                 W2) = restir_mod.temporal_combine(
                    res.kind, res.slot, res.face, res.fa, res.fb, res.dir,
                    res.dist, res.le, res.wsum, res.target_pdf, prev_restir,
                    g_motion_u, g_motion_v, g_depth, n, p, wo, mat, lights,
                    light_remap, u_takes, frame_idx=frame_u, n_taps=n_taps)
                origin = m.add(p, m.scale(n, eps_p))
                live2 = alive & (phat2 > 1e-9)
                zero = torch.zeros_like(origin[0])
                vdir = m.where3(live2, dir2, (zero, zero + 1.0, zero))
                vcap = torch.where(live2, torch.clamp(dist2 - 2.0 * eps_p,
                                                      min=0.0), 0.0)
                fv, _ = B.evaluate(mat, n, wo, dir2)
                cos2 = torch.clamp(m.dot(n, dir2), min=0.0)
                nee = tuple(fc * cos2 * lc * W2 for fc, lc in zip(fv, le2))
                restir_pending = (k2, s2, f2, fa2, fb2, dir2, le2, M2, W2,
                                  alive, n)
                shadow_rays.append((origin, vdir, vcap))
            else:
                nee, origin, vdir, vcap = shade_reservoir_deferred(
                    res, p, n, wo, mat, live=alive)
                shadow_rays.append((origin, vdir, vcap))
        shadow_rgb.append(tuple(
            torch.where(alive, throughput[i] * nee[i], 0.0)
            for i in range(3)))

        if bounce == rs_cfg.total_bounce_limit - 1:
            alive = torch.zeros_like(alive)
            break
        if fused:
            # continuation sample computed by the fused kernel
            samp = B.BsdfSample(wi=out.wi, weight=out.weight, pdf=None,
                                is_delta=out.is_delta != 0,
                                is_transmission=out.is_transmission != 0)
        else:
            u1, u2, u3 = rs.next3()
            samp = B.sample(mat, n, wo, u1, u2, u3)
        is_diffuse_lobe = ~samp.is_delta & ((mat.roughness > 0.35)
                                            | samp.is_transmission)
        diffuse_count = diffuse_count + (alive & is_diffuse_lobe).to(
            torch.int32)
        over_diffuse = diffuse_count > rs_cfg.diffuse_bounce_limit
        min_roughness = torch.where(
            is_diffuse_lobe,
            torch.clamp(min_roughness, min=REGULARIZE_ROUGHNESS),
            min_roughness)
        throughput = [torch.where(alive, t * w, t)
                      for t, w in zip(throughput, samp.weight)]
        zero_tp = (throughput[0] + throughput[1] + throughput[2]) < 1e-6
        alive = alive & ~over_diffuse & ~zero_tp

        wi = samp.wi
        ixf = rec.ix.to(torch.float32)
        iyf = rec.iy.to(torch.float32)
        izf = rec.iz.to(torch.float32)
        ex = torch.where(wi[0] > 0, ixf + 1.0, ixf)
        ey = torch.where(wi[1] > 0, iyf + 1.0, iyf)
        ez = torch.where(wi[2] > 0, izf + 1.0, izf)

        def safe(vv):
            return torch.where(torch.abs(vv) < 1e-6,
                               torch.where(vv >= 0, 1e-6, -1e-6), vv)

        t_exit = torch.minimum(torch.minimum((ex - p[0]) / safe(wi[0]),
                                             (ey - p[1]) / safe(wi[1])),
                               (ez - p[2]) / safe(wi[2]))
        t_exit = torch.clamp(t_exit, 0.0, 1.75)
        o_exit = m.add(p, m.scale(wi, t_exit + eps_p))
        trans_voxel = samp.is_transmission & ~is_ent
        side = torch.where(samp.is_transmission, -1.0, 1.0)
        o_surf = m.add(p, m.scale(n, eps_p * side))
        o = _c3(m.where3(trans_voxel, o_exit, o_surf))
        d = _c3(wi)
        prev_delta = samp.is_delta
        if fused:
            prev_cos_pdf = out.prev_cos_pdf   # the kernel zeroed delta lobes
        else:
            _, prev_cos_pdf = B.eval_lum(mat, n, wo, wi)
            prev_cos_pdf = torch.where(samp.is_delta, 0.0, prev_cos_pdf)

        if half_gi and bounce == 0:
            th0_full = tuple(throughput)
            o = _ds3(o)
            d = _ds3(d)
            alive = _ds(alive) & (
                _ds(throughput[0] + throughput[1] + throughput[2]) > 1e-6)
            one_h = torch.ones(alive.shape, **f32)
            throughput = [one_h, one_h, one_h]
            diffuse_count = _ds(diffuse_count)
            min_roughness = _ds(min_roughness)
            prev_delta = _ds(prev_delta)
            prev_cos_pdf = _ds(prev_cos_pdf)
            bn_cur = None if bn_full is None \
                else rng.bn_packed(H // 2, W // 2, y0, step=2, device=dev)
            rs = rng.RandState(_ds(px), _ds(py), frame_u, 0, bn=bn_cur)
            L_gi = [torch.zeros_like(one_h) for _ in range(3)]
            Lcur = L_gi

    new_restir = None
    groups: dict = {}
    for k, (_, _, rc) in enumerate(shadow_rays):
        groups.setdefault(tuple(rc.shape), []).append(k)
    vis_parts: list = [None] * len(shadow_rays)
    for shape, idxs in groups.items():
        if len(idxs) == 1:
            oo, dd, cc = shadow_rays[idxs[0]]
            vis_parts[idxs[0]] = ~trace_any(_c3(oo), _c3(dd),
                                            cc.contiguous())
        else:
            o_all = tuple(torch.cat([shadow_rays[k][0][i] for k in idxs], 0)
                          for i in range(3))
            d_all = tuple(torch.cat([shadow_rays[k][1][i] for k in idxs], 0)
                          for i in range(3))
            cap_all = torch.cat([shadow_rays[k][2] for k in idxs], 0)
            vis_all = ~trace_any(o_all, d_all, cap_all)
            rows_g = shape[0]
            for j, k in enumerate(idxs):
                vis_parts[k] = vis_all[j * rows_g:(j + 1) * rows_g]
    for rgb_k, vis_k in zip(shadow_rgb, vis_parts):
        tgt = L if rgb_k[0].shape == L[0].shape else L_gi
        for i in range(3):
            tgt[i] = tgt[i] + torch.where(vis_k, rgb_k[i], 0.0)
    if restir_pending is not None:
        (k2, s2, f2, fa2, fb2, dir2, le2, M2, W2, keep, n0) = restir_pending
        new_restir = restir_mod.pack_state(
            kind=torch.where(keep, k2, restir_mod.KIND_NONE), slot=s2,
            fa=fa2, fb=fb2, dir3=dir2,
            W=torch.where(keep & vis_parts[0], W2, 0.0),
            M=torch.where(keep, M2, 0.0), depth=g_depth, n3=n0, le=le2)

    if L_gi is not None:
        for i in range(3):
            L[i] = L[i] + th0_full[i] * _up(L_gi[i])

    L3 = m.nan_scrub(torch.stack(L, dim=0))
    alb3 = torch.stack(g_albedo, dim=0)
    illum3 = L3 / torch.clamp(alb3, min=0.01)
    g = GBuffers(illum=tuple(illum3[i] for i in range(3)),
                 albedo=tuple(g_albedo), normal=tuple(g_normal),
                 depth=g_depth, roughness=g_rough, motion_u=g_motion_u,
                 motion_v=g_motion_v,
                 emissive_first=g_emissive | (g_depth >= BIG),
                 highlight=g_highlight)
    return g, (new_restir if use_restir else None)
