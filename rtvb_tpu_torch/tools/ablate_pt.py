"""Ablation profile of the path-trace stage: the port's counterpart of the
JAX package's tools/ablate_pt.py.

    python -m rtvb_tpu_torch.tools.ablate_pt [--scale S] [--device D]
        [--json PATH] [variant ...]

Variants (the JAX tool's): full norestir noent nolocal loc2 b2 b1 notex
nosky; by default those of the JAX tool's default list, at scale 2/3 of
a 1920×1080 output.  Each is `pathtracer.render_frame` with the engine's
own configuration (its settings, the atlas, half-res GI, the highlight:
`full` is the engine's path-trace stage, G-buffers to the bit) less one
feature: ReSTIR (no previous reservoirs), the entity soup, the local
light candidates (0, or 2), bounces (2, 1), the procedural textures
(`textures.sample_scale` and `sample_normal_delta` rebound to constants)
or the sky (`sky.sky_radiance` rebound to a constant colour).  `nosky`
does not reach inside K4, which evaluates its own sky from
`sky.sky_scalar_pack`, as the JAX package's Pallas kernel does: it
removes the sky of the misses and, without fused shading, of the NEE
samples.  A patch is in place from before the variant's first call
through its capture and is restored in a `finally`; every variant is
captured anew by this tool (no graph of the engine is reused).

Each variant is timed as replays of its captured graph (CUDA events,
the mean over `timing.CAPTURES` captures) and, for the record, eagerly,
and reported with its delta against `full`.  The replays are what
compare: an eager frame on the card is bound by the host's dispatch of
its thousands of ops, so an eager delta measures Python, not the
device.  On the CPU the times are the host's and there is no replay.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import torch

from ..assets import textures
from ..render import pathtracer
from ..render import restir as restir_mod
from ..render import sky as sky_mod
from . import timing
from .device_trace import shipped_engine

VARIANTS = ("full", "norestir", "noent", "nolocal", "loc2", "b2", "b1",
            "notex", "nosky")
DEFAULT_VARIANTS = ("full", "norestir", "noent", "b2", "b1", "notex",
                    "nosky")
PATCHED = {"notex": ((textures, "sample_scale"),
                     (textures, "sample_normal_delta")),
           "nosky": ((sky_mod, "sky_radiance"),)}


def _no_texture_scale(tid, u, v, lod=None):
    return torch.ones_like(u)


def _no_normal_delta(tid, u, v, lod=None):
    return torch.zeros_like(u), torch.zeros_like(u)


def _constant_sky(d, sky):
    return (torch.full_like(d[0], 0.3), torch.full_like(d[0], 0.4),
            torch.full_like(d[0], 0.6))


_PATCHES = {"notex": (_no_texture_scale, _no_normal_delta),
            "nosky": (_constant_sky,)}


@contextlib.contextmanager
def patched(variant: str):
    """Rebind the module functions `variant` removes, restored on exit
    (also when the body raises); no-op for the other variants."""
    targets = PATCHED.get(variant, ())
    saved = [getattr(mod, name) for mod, name in targets]
    try:
        for (mod, name), fn in zip(targets, _PATCHES.get(variant, ())):
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


def variant_trace_fn(eng, variant: str):
    """The engine's path trace less one feature (call it inside
    `patched(variant)`): trace(tables, mats, lights, sky, cam, hist_cam,
    frame_idx, prev_restir, light_remap, ent, atlas) → (GBuffers, new
    ReSTIR state | None), as `Engine._trace_fn`'s."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    rs = eng.settings.rendering
    rs_cfg = dataclasses.replace(rs, local_light_candidates=eng._n_local)
    if variant == "nolocal":
        rs_cfg = dataclasses.replace(rs_cfg, local_light_candidates=0)
    elif variant == "loc2":
        rs_cfg = dataclasses.replace(rs_cfg, local_light_candidates=2)
    elif variant in ("b2", "b1"):
        rs_cfg = dataclasses.replace(rs_cfg,
                                     total_bounce_limit=int(variant[1]))
    use_restir = rs_cfg.use_restir and variant != "norestir"
    use_ent = variant != "noent"
    cfg, tp, W, H = eng.cfg, eng._tp, eng.width, eng.height

    def run(tables, mats, lights, sky, cam, hist_cam, frame_idx,
            prev_restir, light_remap, ent, atlas):
        return pathtracer.render_frame(
            cfg, tables, tp, mats, lights, sky, cam, hist_cam, frame_idx,
            W, H, rs_cfg, prev_restir=prev_restir if use_restir else None,
            light_remap=light_remap, entities=ent if use_ent else None,
            atlas=atlas, half_res_gi=rs.half_res_gi,
            block_highlight=rs.block_highlight)
    return run


def trace_args(eng, prev_restir=None) -> tuple:
    """The engine's path-trace arguments as they stand, with prev_restir
    (None: a fresh reservoir state, as the JAX tool's) in place of its
    reservoirs."""
    eng._ensure_states()
    inputs = list(eng._trace_inputs())
    if prev_restir is None and eng.settings.rendering.use_restir:
        prev_restir = restir_mod.initial_state(eng.height, eng.width,
                                               device=eng.device)
    inputs[7] = prev_restir
    return (*inputs, eng.entity_buffers(), eng.texture_atlas)


def ablate_pt(device="cuda", scale: float = 2.0 / 3.0, variants=None,
              width: int = 1920, height: int = 1080, n_eager: int = 3,
              n_replay: int = 3, engine=None) -> dict:
    """Time each variant's path trace (`timing.time_piece`: first call,
    eager, capture, replay) on the same inputs → {"device", "card",
    "scale", "internal", "build", "variants": {name: times +
    replay_delta_ms, eager_delta_ms against full (None without full)}}."""
    variants = tuple(variants or DEFAULT_VARIANTS)
    dev = timing.resolve(device)
    build = timing.ensure_kernels(dev)
    eng = engine if engine is not None else shipped_engine(
        dev, width, height, scale)
    eng.set_render_scale(scale)
    args = trace_args(eng)
    out = {}
    for name in variants:
        with patched(name):
            run = variant_trace_fn(eng, name)
            out[name] = timing.time_piece(lambda: run(*args), dev, keep=args,
                                          n_eager=n_eager,
                                          n_replay=n_replay)
    full = out.get("full")
    for t in out.values():
        for k in ("replay", "eager"):
            a = None if full is None else full[f"{k}_ms"]
            b = t[f"{k}_ms"]
            t[f"{k}_delta_ms"] = None if a is None or b is None else b - a
    return dict(device=str(dev),
                card=timing.card_name(dev),
                scale=scale, internal=[eng.width, eng.height], build=build,
                variants=out)



def report(res: dict, out=print) -> None:
    clock = "CUDA events" if res["card"] else "host clock (CPU)"
    out(f"ablate_pt at scale {res['scale']:.4g} ({res['internal'][0]}x"
        f"{res['internal'][1]}) on {res['card'] or res['device']}, ms "
        f"({clock}): replay (the mean over captures), its delta vs full, "
        f"eager, its delta, capture, the replays' spread")
    for name, t in res["variants"].items():
        ms = timing.fmt_ms
        out(f"  {name:9s} {ms(t['replay_ms'])} "
            f"{ms(t['replay_delta_ms'], True)} {ms(t['eager_ms'])} "
            f"{ms(t['eager_delta_ms'], True)} {ms(t['capture_ms'])}  "
            f"{timing.fmt_spread(t)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=" ".join(VARIANTS))
    ap.add_argument("--scale", type=float, default=2.0 / 3.0)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the whole result here")
    a = ap.parse_args(argv)
    unknown = sorted(set(a.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; one of {' '.join(VARIANTS)}")
    res = ablate_pt(a.device, a.scale, a.variants or None, a.width,
                    a.height)
    report(res)
    timing.write_json(res, a.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
