"""Micro-benchmarks of post's pieces from the internal size to 1080p: the
port's counterpart of the JAX package's tools/micro_post.py.

    python -m rtvb_tpu_torch.tools.micro_post [--scale S] [--device D]
        [--json PATH]

At render scale S (1/2 by default, as the JAX tool) of a 1920×1080
output, on a random HDR image made from a seed: `auto_exposure`,
`bloom`, `lens_flare`, `vignette` and `tone_map` at the internal size,
`easu` (K7) to the output, `sharpen` at the output and the whole
`run()`, each alone with `timing.time_piece`'s numbers (eager calls and
replays of the piece captured alone, by CUDA events).  The pieces'
sum exceeds the whole run's: the run feeds each piece its predecessor's
output and skips the disabled ones, as the JAX tool's note says of
XLA's fusion.  On the CPU the times are the host's and there is no
replay.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ..core.config import Settings
from ..render import postprocess as P
from . import timing
from .micro_pt import report as _report


def micro_post(device="cuda", scale: float = 0.5, out_w: int = 1920,
               out_h: int = 1080, n_eager: int = 3, n_replay: int = 3,
               seed: int = 0) -> dict:
    """Each post piece's first call, eager, capture and replay ms →
    {"device", "card", "scale", "shape" (internal h, w), "output",
    "build", "pieces": {piece: times}}."""
    dev = timing.resolve(device)
    build = timing.ensure_kernels(dev)
    h = int(out_h * scale) // 4 * 4
    w = int(out_w * scale) // 4 * 4
    st = Settings()
    cfg, tm = st.post_processing, st.tone_mapping
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rgb = (torch.rand((h, w, 3), generator=gen) * 2.0).to(dev)
    state = P.initial_post_state(dev)
    # the flare's tints too (lens_flare is off in the shipped settings but
    # timed here, as the JAX tool times it)
    consts = P.frame_constants(dataclasses.replace(cfg, lens_flare=True),
                               tm, dev)
    dt = torch.full((), 0.016, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ldr = torch.clamp(rgb, 0.0, 1.0)
    big = torch.rand((out_h, out_w, 3), generator=gen).to(dev)
    pieces = {}

    def piece(name, body, *keep):
        pieces[name] = timing.time_piece(body, dev, keep=keep,
                                         n_eager=n_eager, n_replay=n_replay)

    piece("auto_exposure", lambda: P.auto_exposure(rgb, state, cfg, dt),
          rgb, state, dt)
    piece("bloom", lambda: P.bloom(rgb, cfg), rgb)
    piece("lens_flare", lambda: P.lens_flare(rgb, cfg, consts.flare_tints),
          rgb, consts)
    piece("vignette", lambda: P.vignette(rgb, cfg), rgb)
    piece("tone_map", lambda: P.tone_map(rgb, tm, zero, consts.white_curve),
          rgb, zero, consts)
    piece("easu (K7)", lambda: P.easu(ldr, out_h, out_w), ldr)
    piece("sharpen", lambda: P.sharpen(big, cfg.sharpen_strength), big)
    piece("full run()", lambda: P.run(rgb, state, cfg, tm, dt, out_h, out_w,
                                      consts=consts)[0],
          rgb, state, dt, consts)
    return dict(device=str(dev),
                card=timing.card_name(dev),
                scale=scale, shape=[h, w], output=[out_h, out_w],
                build=build, pieces=pieces)


def report(res: dict, out=print) -> None:
    _report(res, f"micro_post to {res['output'][1]}x{res['output'][0]}",
            out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the whole result here")
    a = ap.parse_args(argv)
    res = micro_post(a.device, a.scale, a.width, a.height)
    report(res)
    timing.write_json(res, a.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
