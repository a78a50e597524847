"""Authored PBR image textures: PNG files → packed mip pyramid → per-tile
adaptive trilinear sampling (port of rtvb_tpu/assets/image_textures.py).

The atlas keeps the JAX package's two arrays and layouts so both
implementations read identical bits (bf16 pairs packed in f32 words):

    lo: (3, T·128, 128) — levels 3..6 (64² … 8²) of every texture
    hi: (3, T·896, 512) — levels 0..2 (512², 256², 128²)

planes (r|g), (b|rough), (du|dv).  On the GPU both stay whole in device
memory (no demand paging), and beside them a kernel-side copy with the
three words of a texel interleaved into one 16-byte texel (`with_texels`:
(T·128, 128, 4) and (T·896, 512, 4) words, the fourth 0; 68.4 MB for the
nine 512² textures), so K3 reads a tap with one load.  The sampling rule
is the TPU kernel's: the level pair is chosen per (32, 128) tile of the
padded image — the finest level any pixel of the tile wants — and only
the tile's demand texture samples that pair; other textured pixels clamp
the pair to ≥ 3.  `sample_atlas` launches ``csrc/texture_kernel.cu`` (K3)
for CUDA tensors and runs `_sample_ref` for CPU tensors.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as K
from ..ops.dda import floor_i32
from ..ops.pack import pack2, unpack2

S0 = 512
LEVELS = 7
MIP_SIZES = tuple(S0 >> lv for lv in range(LEVELS))
HI_LEVELS = 3
HI_SIZES = (512, 256, 128)
HI_OFFS = (0, 512, 768)
HI_ROWS = 896
LO_SIZES = (64, 32, 16, 8)
LO_OFFS = (0, 64, 96, 112)
LO_ROWS = 128
LO_COLS = 128
MAX_TEXTURES = 32
TILE_R = 32
TILE_C = 128

_NORMAL_SCALE = 8.0


class TextureAtlas(NamedTuple):
    lo: torch.Tensor     # (3, T·LO_ROWS, LO_COLS) f32 bf16 pairs
    hi: torch.Tensor     # (3, T·HI_ROWS, S0) f32 bf16 pairs
    # K3's interleaved copy of the same words, (·, ·, 4): or None
    lo4: torch.Tensor | None = None
    hi4: torch.Tensor | None = None


def with_texels(atlas: TextureAtlas) -> TextureAtlas:
    """The atlas with K3's interleaved copy: each texel's three words and
    a zero word side by side, 16 bytes a texel."""
    def inter(planes):
        return torch.cat([planes.permute(1, 2, 0),
                          torch.zeros_like(planes[0])[..., None]],
                         dim=-1).contiguous()
    return atlas._replace(lo4=inter(atlas.lo), hi4=inter(atlas.hi))


def atlas_count(atlas: TextureAtlas) -> int:
    return atlas.lo.shape[1] // LO_ROWS


def _box_down(img: np.ndarray, size: int) -> np.ndarray:
    h = img.shape[0]
    if img.shape[0] != img.shape[1]:
        raise ValueError("authored textures must be square")
    if h & (h - 1) or size & (size - 1):
        raise ValueError("pow2 texture sizes only")
    while h > size:
        img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                      + img[0::2, 1::2] + img[1::2, 1::2])
        h //= 2
    if h < size:
        img = np.repeat(np.repeat(img, size // h, 0), size // h, 1)
    return img.astype(np.float32)


def _read_optional(path: str):
    from ..utils.image import read_png
    if not os.path.exists(path):
        return None
    img = read_png(path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return img[..., :3]


def _pack2_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return pack2(torch.from_numpy(np.ascontiguousarray(a, np.float32)),
                 torch.from_numpy(np.ascontiguousarray(b, np.float32))).numpy()


def load_atlas(tex_dir: str, names: list, device="cpu"):
    """Read `<tex_dir>/<name>.png` (+ optional `_n` / `_r` planes) into the
    packed pyramid.  Returns (TextureAtlas, kept_names) or (None, ())."""
    if not names or not os.path.isdir(tex_dir):
        return None, ()
    blocks = []
    kept = []
    for name in names[:MAX_TEXTURES]:
        alb = _read_optional(os.path.join(tex_dir, f"{name}.png"))
        if alb is None:
            continue
        alb = _box_down(alb ** 2.2, S0)
        nrm = _read_optional(os.path.join(tex_dir, f"{name}_n.png"))
        if nrm is None:
            duv = np.zeros((S0, S0, 2), np.float32)
        else:
            nrm = _box_down(nrm, S0)
            duv = (nrm[..., :2] * 2.0 - 1.0) * _NORMAL_SCALE
        rgh = _read_optional(os.path.join(tex_dir, f"{name}_r.png"))
        rgh = np.ones((S0, S0, 1), np.float32) if rgh is None \
            else _box_down(rgh, S0)[..., :1]
        blocks.append(np.concatenate([alb, duv, rgh], axis=-1))
        kept.append(name)
    if not blocks:
        return None, ()

    t = len(blocks)
    lvl = np.stack(blocks)
    hi = np.zeros((3, t * HI_ROWS, S0), np.float32)
    lo = np.zeros((3, t * LO_ROWS, LO_COLS), np.float32)
    for lv in range(LEVELS):
        s = MIP_SIZES[lv]
        if lvl.shape[1] != s:
            lvl = 0.25 * (lvl[:, 0::2, 0::2] + lvl[:, 1::2, 0::2]
                          + lvl[:, 0::2, 1::2] + lvl[:, 1::2, 1::2])
        for ti in range(t):
            blk = lvl[ti]
            planes = (_pack2_np(blk[..., 0], blk[..., 1]),
                      _pack2_np(blk[..., 2], blk[..., 5]),
                      _pack2_np(blk[..., 3], blk[..., 4]))
            if lv < HI_LEVELS:
                r0 = ti * HI_ROWS + HI_OFFS[lv]
                for pi, pl in enumerate(planes):
                    hi[pi, r0:r0 + s, :s] = pl
            else:
                r0 = ti * LO_ROWS + LO_OFFS[lv - HI_LEVELS]
                for pi, pl in enumerate(planes):
                    lo[pi, r0:r0 + s, :s] = pl
    atlas = TextureAtlas(lo=torch.from_numpy(lo).to(device),
                         hi=torch.from_numpy(hi).to(device))
    if atlas.lo.device.type == "cuda":
        atlas = with_texels(atlas)
    return atlas, tuple(kept)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the JAX package's _sample_ref)
# ---------------------------------------------------------------------------

def level_from_lod(lod):
    """Continuous mip level from the ray-cone lod proxy (footprint lod·S0
    texels; one level per doubling)."""
    f = torch.clamp(lod * float(S0), min=1.0)
    return torch.clamp(torch.log2(f), 0.0, float(LEVELS - 1))


def _bilinear_coords(u, v, s):
    """Wrap-tiled bilinear taps at a per-pixel level size s (int32)."""
    sf = s.to(torch.float32)
    x = u * sf - 0.5
    y = v * sf - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0 = torch.remainder(floor_i32(x0f), s)
    y0 = torch.remainder(floor_i32(y0f), s)
    x1 = torch.remainder(x0 + 1, s)
    y1 = torch.remainder(y0 + 1, s)
    return x0, y0, x1, y1, wx, wy


def _tile_reduce_min(x, pad_val: int):
    """Per-pixel map of the per-(32, 128)-tile minimum over the padded
    tiling (padding = pad_val)."""
    H, W = x.shape
    Hp = H + (-H) % TILE_R
    Wp = W + (-W) % TILE_C
    xp = torch.nn.functional.pad(x, (0, Wp - W, 0, Hp - H), value=pad_val)
    bl = xp.reshape(Hp // TILE_R, TILE_R, Wp // TILE_C, TILE_C)
    m = bl.amin(dim=(1, 3), keepdim=True)
    return m.expand(bl.shape).reshape(Hp, Wp)[:H, :W]


def _fetch_level(atlas: TextureAtlas, li, tid, py, px):
    is_hi = li < HI_LEVELS
    hi_off = torch.where(li == 0, HI_OFFS[0],
                         torch.where(li == 1, HI_OFFS[1], HI_OFFS[2]))
    hi_rows = atlas.hi.shape[1]
    hi_idx = (torch.clamp(tid * HI_ROWS + hi_off + py, 0, hi_rows - 1) * S0
              + px).long()
    s_lo = 64 >> (torch.clamp(li, min=HI_LEVELS) - HI_LEVELS)
    off_lo = (LO_ROWS - 8) - 2 * s_lo
    lo_rows = atlas.lo.shape[1]
    lo_idx = (torch.clamp(tid * LO_ROWS + off_lo + py, 0, lo_rows - 1)
              * LO_COLS + px).long()
    # each address is in range for the tier it is used for; clamp the
    # other tier's (discarded) address into its array
    hi_idx = torch.clamp(hi_idx, max=atlas.hi[0].numel() - 1)
    lo_idx = torch.clamp(lo_idx, max=atlas.lo[0].numel() - 1)
    out = []
    for p in range(3):
        h = atlas.hi[p].reshape(-1)[hi_idx.reshape(-1)].reshape(li.shape)
        lv = atlas.lo[p].reshape(-1)[lo_idx.reshape(-1)].reshape(li.shape)
        out.append(torch.where(is_hi, h, lv))
    return out


def _sample_level_ref(atlas, li, tid, u, v):
    s = S0 >> li
    x0, y0, x1, y1, wx, wy = _bilinear_coords(u, v, s)
    f00 = _fetch_level(atlas, li, tid, y0, x0)
    f01 = _fetch_level(atlas, li, tid, y0, x1)
    f10 = _fetch_level(atlas, li, tid, y1, x0)
    f11 = _fetch_level(atlas, li, tid, y1, x1)
    out = []
    for p in range(3):
        a00 = unpack2(f00[p])
        a01 = unpack2(f01[p])
        a10 = unpack2(f10[p])
        a11 = unpack2(f11[p])
        for h in range(2):
            top = a00[h] * (1.0 - wx) + a01[h] * wx
            bot = a10[h] * (1.0 - wx) + a11[h] * wx
            out.append(top * (1.0 - wy) + bot * wy)
    return out


def _sample_ref(atlas: TextureAtlas, t_count: int, tid, u, v, lvl):
    lvl_i = lvl.to(torch.int32)
    l0t = torch.clamp(_tile_reduce_min(lvl_i, LEVELS - 1), 0, LEVELS - 2)
    cand = torch.where((lvl_i == l0t) & (tid >= 0), tid, MAX_TEXTURES).to(
        torch.int32)
    t_hi = _tile_reduce_min(cand, MAX_TEXTURES)
    hi_valid = (l0t < HI_LEVELS) & (t_hi < t_count)
    main_hi = hi_valid & (tid == t_hi)
    la = torch.where(main_hi, l0t, torch.clamp(l0t, min=HI_LEVELS))
    w1 = torch.clamp(lvl - la.to(torch.float32), 0.0, 1.0)
    c0 = _sample_level_ref(atlas, la, tid, u, v)
    c1 = _sample_level_ref(atlas, torch.clamp(la + 1, max=LEVELS - 1), tid,
                           u, v)
    return [a * (1.0 - w1) + b * w1 for a, b in zip(c0, c1)]


# ---------------------------------------------------------------------------
# K3 wrapper + public API
# ---------------------------------------------------------------------------

TEXTURE = K.register(K.CudaKernel("texture", "rtvb_texture_tiles",
                                  [K.P] * 6 + [K.I] * 3 + [K.P]))


def _sample_cuda(atlas: TextureAtlas, t_count: int, tid, u, v, lvl):
    """Launch K3 (csrc/texture_kernel.cu) on the atlas's interleaved copy
    (`with_texels`): (6, H, W) channel planes."""
    H, W = u.shape
    dev = u.device
    if atlas.lo4 is None or atlas.hi4 is None:
        raise ValueError("K3 reads the atlas's interleaved copy: build it "
                         "with image_textures.with_texels")
    args = [K.as_input("tid", tid, torch.int32, (H, W), dev),
            K.as_input("u", u, torch.float32, (H, W), dev),
            K.as_input("v", v, torch.float32, (H, W), dev),
            K.as_input("lvl", lvl, torch.float32, (H, W), dev),
            K.as_input("atlas.lo4", atlas.lo4, torch.float32,
                       (t_count * LO_ROWS, LO_COLS, 4), dev),
            K.as_input("atlas.hi4", atlas.hi4, torch.float32,
                       (t_count * HI_ROWS, S0, 4), dev)]
    out = torch.empty((6, H, W), dtype=torch.float32, device=dev)
    TEXTURE.launch(dev, *args, H, W, t_count, out)
    return list(out.unbind(0))


class AuthoredSample(NamedTuple):
    rgb: tuple
    du: torch.Tensor
    dv: torch.Tensor
    rough_mul: torch.Tensor


def sample_atlas(atlas: TextureAtlas, image_id, u, v, lod) -> AuthoredSample:
    """Adaptive trilinear PBR sample.  Pixels with image_id < 0 return the
    neutral sample (albedo 1, flat normal, roughness × 1)."""
    t_count = atlas_count(atlas)
    tid = torch.clamp(image_id.to(torch.int32), -1, t_count - 1).contiguous()
    u = u.contiguous()
    v = v.contiguous()
    lvl = level_from_lod(lod).contiguous()
    if K.on_cuda(u):
        outs = _sample_cuda(atlas, t_count, tid, u, v, lvl)
    else:
        outs = _sample_ref(atlas, t_count, tid, u, v, lvl)
    r, g, b, rough, du, dv = outs
    use = image_id >= 0
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    return AuthoredSample(
        rgb=(torch.where(use, r, one), torch.where(use, g, one),
             torch.where(use, b, one)),
        du=torch.where(use, du, zero), dv=torch.where(use, dv, zero),
        rough_mul=torch.where(use, rough, one))
