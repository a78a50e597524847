"""Micro-benchmarks of the path tracer's pieces at 1080p: the port's
counterpart of the JAX package's tools/micro_pt.py.

    python -m rtvb_tpu_torch.tools.micro_pt [--width W] [--height H]
        [--device cuda|cpu] [--json PATH]

Each piece runs alone over (1080, 1920) planes on the shipped engine's
tables, as the JAX tool's, and reports `timing.time_piece`'s numbers:
eager calls and replays of the piece captured alone, by CUDA events.
The pieces: the exception-list lookup (the port's `searchsorted` lookup
of `ops/dda.py:material_index`, sized by the world's exc_key) and the
light-key lookup (the same search on the light table's keys, as the path
tracer's emitter MIS runs it), where the JAX tool times its keyed
lookups; the 11-field material gather and `block_to_mat` by plain
indexing (the JAX tool's one-hot gathers are TPU workarounds, not
ported); `bsdf.evaluate` and `bsdf.sample`; `sky_radiance`,
`sun_radiance`, `sky_env_sample` and `sky_env_pdf`; the procedural
textures' `sample_scale` and `sample_normal_delta` (on the card one
launch each of csrc/proctex_kernel.cu); 8 draws of
`rng.RandState` (white noise); and the entity intersect, K2 through
`triangles.intersect_packed` against the engine's soup.  On the CPU the
times are the host's and there is no replay.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..assets import textures
from ..ops import bsdf as B
from ..ops import rng as rng_mod
from ..ops import triangles as tri_ops
from ..ops.alias_table import take
from ..render import sky as sky_mod
from . import timing
from .device_trace import shipped_engine


def keyed_lookup(keys, values, key):
    """The port's lower-bound search of a sorted key table → (value where
    the key is found else -1, found)."""
    lo = torch.clamp(torch.searchsorted(keys, key), 0, keys.shape[0] - 1)
    found = keys[lo] == key
    return torch.where(found, values[lo], -1), found


def micro_pt(device="cuda", width: int = 1920, height: int = 1080,
             n_eager: int = 3, n_replay: int = 3, engine=None) -> dict:
    """Each piece's first call, eager, capture and replay ms over
    (height, width) planes → {"device", "card", "shape", "build",
    "sizes", "pieces": {piece: times}}."""
    dev = timing.resolve(device)
    build = timing.ensure_kernels(dev)
    eng = engine if engine is not None else shipped_engine(dev, width,
                                                           height)
    H, W = height, width
    tables, mats, lights, sky = (eng._tables, eng.materials, eng.lights,
                                 eng.sky_state)
    f32 = dict(dtype=torch.float32, device=dev)
    pieces = {}

    def piece(name, body, *keep):
        pieces[name] = timing.time_piece(body, dev, keep=keep,
                                         n_eager=n_eager, n_replay=n_replay)

    key = (torch.arange(H * W, dtype=torch.int32, device=dev)
           .reshape(H, W) % 90000).contiguous()
    n_exc = tables.exc_key.shape[0]
    piece(f"exception lookup (searchsorted, {n_exc} keys)",
          lambda: keyed_lookup(tables.exc_key, tables.exc_id, key)[0],
          key, tables)
    slots = torch.arange(lights.key.shape[0], dtype=torch.int32, device=dev)
    piece(f"light lookup (searchsorted, {lights.key.shape[0]} keys)",
          lambda: keyed_lookup(lights.key, slots, key)[0], key, lights.key,
          slots)
    mi = key % 16
    fields = (mats.albedo[:, 0], mats.albedo[:, 1], mats.albedo[:, 2],
              mats.emissive[:, 0], mats.emissive[:, 1], mats.emissive[:, 2],
              mats.roughness, mats.metallic, mats.translucency,
              mats.texture_id, mats.uv_scale)
    piece("material gather (11 fields, indexing)",
          lambda: [take(t, mi) for t in fields], mi, fields)
    piece("block_to_mat gather (indexing)",
          lambda: take(mats.block_to_mat, mi), mi, mats.block_to_mat)

    one = torch.ones((H, W), **f32)
    dirs = (one * 0.3, one * 0.8, one * 0.52)
    n = (one * 0.0, one, one * 0.0)
    wo = (one * 0.2, one * 0.9, one * 0.4)
    mat = B.Material(albedo_r=one * 0.5, albedo_g=one * 0.5,
                     albedo_b=one * 0.5, roughness=one * 0.6,
                     metallic=one * 0.1, translucency=one * 0.0)
    half = one * 0.5
    piece("bsdf.evaluate", lambda: B.evaluate(mat, n, wo, dirs)[0],
          mat, n, wo, dirs)
    piece("bsdf.sample", lambda: B.sample(mat, n, wo, half, half * 0.7,
                                          half * 0.3).wi, mat, n, wo, half)
    piece("sky_radiance", lambda: sky_mod.sky_radiance(dirs, sky), dirs, sky)
    piece("sun_radiance", lambda: sky_mod.sun_radiance(dirs, sky), dirs, sky)
    piece("sky_env_sample", lambda: sky_mod.sky_env_sample(
        sky, half, half * 0.7, half * 0.3)[0], half, sky)
    piece("sky_env_pdf", lambda: sky_mod.sky_env_pdf(sky, dirs), dirs, sky)

    tid = (key % 5).to(torch.int32)
    uv = one * 0.37
    piece("textures.sample_scale",
          lambda: textures.sample_scale(tid, uv, uv), tid, uv)
    piece("textures.sample_normal_delta",
          lambda: textures.sample_normal_delta(tid, uv, uv)[0], tid, uv)

    px = torch.arange(W, dtype=torch.int64, device=dev)[None, :].expand(H, W)
    py = torch.arange(H, dtype=torch.int64, device=dev)[:, None].expand(H, W)
    frame = torch.full((), 3, dtype=torch.int64, device=dev)

    def rng_draws():
        rs = rng_mod.RandState(px, py, frame, 0)
        return [rs.next() for _ in range(8)]
    piece("rng 8 draws (white noise)", rng_draws, px, py, frame)

    ent = eng.entity_buffers()
    n_tris = None
    if ent is not None:
        n_tris = int(ent.tri_packed.shape[0])
        o = (one * 32.0, one * 40.0, one * 32.0)
        piece(f"entity intersect K2 ({n_tris} rows)",
              lambda: tri_ops.intersect_packed(o, dirs, ent.tri_packed).t,
              o, dirs, ent.tri_packed)
    return dict(device=str(dev),
                card=timing.card_name(dev),
                shape=[H, W], build=build,
                sizes=dict(exc_key=n_exc, light_key=int(lights.key.shape[0]),
                           materials=int(mats.roughness.shape[0]),
                           soup_rows=n_tris),
                pieces=pieces)


def report(res: dict, title: str = "micro_pt", out=print) -> None:
    clock = "CUDA events" if res["card"] else "host clock (CPU)"
    h, w = res["shape"]
    out(f"{title} over {w}x{h} on {res['card'] or res['device']}, ms "
        f"({clock}): eager, replay")
    for name, t in res["pieces"].items():
        out(f"  {name:45s} {timing.fmt_ms(t['eager_ms'])} "
            f"{timing.fmt_ms(t['replay_ms'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the whole result here")
    a = ap.parse_args(argv)
    res = micro_pt(a.device, a.width, a.height)
    report(res)
    timing.write_json(res, a.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
