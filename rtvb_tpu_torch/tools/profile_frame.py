"""Per-stage profile of the real-time frame: the port's counterpart of the
JAX package's tools/profile_frame.py.

    python -m rtvb_tpu_torch.tools.profile_frame [--scale S] [--width W]
        [--height H] [--device cuda|cpu] [--json PATH]

At render scale S (2/3 by default, as the JAX tool) of a 1920×1080
output, each stage of the frame alone: a coherent closest-hit trace wave
with the material epilogue (K1) and an any-hit shadow wave (K1), both on
the JAX tool's rays (a fixed origin and a fan of directions, so the wave
times compare across the two packages); the path trace with temporal
ReSTIR from a fresh reservoir state (K1-K4 and K5's taps); the denoiser
on its G-buffers from a fresh history (K5, K6); post to the output (K7
below scale 1), overlay and u8 as the frame runs it; and the whole frame
through `render_realtime_device`.  Each stage reports `timing.time_piece`'s
four numbers: its first call, its eager calls, its capture as a CUDA
graph (each piece captured on its own) and its replays (CUDA events).
The whole frame's first call is the engine's own first frame (eager,
then the capture); its eager ms are `Engine._eager_frame`'s and its
replays `render_realtime_device`'s.  On the CPU the times are the host's
and there is no capture or replay.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from ..ops.dda import trace
from ..render import postprocess
from ..render.denoiser import denoise_frame, initial_denoiser_state
from . import timing
from .ablate_pt import trace_args
from .device_trace import shipped_engine

STAGES = ("trace wave (closest hit, material epilogue)",
          "shadow wave (any hit)", "path trace (ReSTIR)", "denoise",
          "post", "whole frame")


def wave_rays(h: int, w: int, device):
    """The JAX tool's wave: origin (32, 40, 32) for every pixel and a fan
    of directions over x in [-0.6, 0.6], y in [-0.4, 0.4], pointing down."""
    f32 = dict(dtype=torch.float32, device=device)
    o = tuple(torch.full((h, w), v, **f32) for v in (32.0, 40.0, 32.0))
    yy, xx = torch.meshgrid(torch.linspace(-0.4, 0.4, h, **f32),
                            torch.linspace(-0.6, 0.6, w, **f32),
                            indexing="ij")
    dn = torch.sqrt(xx * xx + yy * yy + 1.0)
    d = (xx / dn, -torch.abs(yy / dn) - 0.1, 1.0 / dn)
    return o, tuple(t.contiguous() for t in d)


def whole_frame_times(eng, n_eager: int = 3, n_replay: int = 3) -> dict:
    """The frame through the engine: first_call_ms (its first frame:
    eager, then the capture, on the card), capture_ms (graph_log's),
    eager_ms (`_eager_frame`) and replay_ms (`render_realtime_device`:
    the mean over `timing.CAPTURES` graphs, the engine's graphs released
    before each, of each one's median of n_replay replays, as
    `timing.time_piece`'s); on the CPU no capture or replay."""
    dev = eng.device
    card = timing.on_card(dev)
    eng.release_graphs()
    timing.sync(dev)
    t0 = time.perf_counter()
    eng.render_realtime_device()
    timing.sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    if not card:
        return dict(first_call_ms=first_ms,
                    eager_ms=timing.host_ms(eng._eager_frame, n_eager),
                    capture_ms=None, replay_ms=None,
                    replay_ms_by_capture=[])
    capture_ms, replays = [], []
    for i in range(timing.CAPTURES):
        if i:
            eng.release_graphs()
            eng.render_realtime_device()
        capture_ms.append(eng.graph_log[-1]["capture_ms"])
        replays.append(timing.cuda_ms(eng.render_realtime_device, n_replay))
    return dict(first_call_ms=first_ms,
                capture_ms=statistics.median(capture_ms),
                eager_ms=timing.cuda_ms(eng._eager_frame, n_eager),
                replay_ms=statistics.fmean(replays),
                replay_ms_by_capture=replays)


def profile_frame(device="cuda", scale: float = 2.0 / 3.0,
                  width: int = 1920, height: int = 1080, n_eager: int = 3,
                  n_replay: int = 3, engine=None) -> dict:
    """Each stage's first call, eager, capture and replay ms (see the
    module's docstring) → {"device", "card", "scale", "internal",
    "output", "build", "stages": {stage: times}}."""
    dev = timing.resolve(device)
    build = timing.ensure_kernels(dev)
    eng = engine if engine is not None else shipped_engine(
        dev, width, height, scale)
    eng.set_render_scale(scale)
    H, W = eng.height, eng.width
    st = eng.settings
    rs = st.rendering
    tables, tp = eng._tables, eng._tp
    o, d = wave_rays(H, W, dev)
    cap = torch.full((H, W), 30.0, dtype=torch.float32, device=dev)

    def piece(body, *keep):
        return timing.time_piece(body, dev, keep=keep, n_eager=n_eager,
                                 n_replay=n_replay)

    stages = {}
    stages[STAGES[0]] = piece(lambda: trace(o, d, tables, tp), o, d, tables)
    stages[STAGES[1]] = piece(
        lambda: trace(o, d, tables, tp, t_cap=cap, any_hit=True), o, d, cap,
        tables)

    pt = eng._trace_fn(eng._n_local, rs.half_res_gi, rs.block_highlight)
    pt_args = trace_args(eng)
    stages[STAGES[2]] = piece(lambda: pt(*pt_args), pt_args)

    g, _ = pt(*pt_args)
    dstate = initial_denoiser_state(H, W, device=dev)
    stages[STAGES[3]] = piece(
        lambda: denoise_frame(g, dstate, st.denoising), g, dstate)

    rgb, _ = denoise_frame(g, dstate, st.denoising)
    consts = eng._frame_constants()
    dt = eng._inputs.dt

    def post():
        out, new_p = postprocess.run(
            rgb, eng.post_state, st.post_processing, st.tone_mapping, dt,
            eng.out_height, eng.out_width, overlay_u8=eng._ui_overlay,
            highlight=g.highlight, consts=consts)
        return (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8), \
            new_p
    stages[STAGES[4]] = piece(post, rgb, g, eng.post_state, eng._ui_overlay,
                              consts, dt)
    stages[STAGES[5]] = whole_frame_times(eng, n_eager, n_replay)
    return dict(device=str(dev),
                card=timing.card_name(dev),
                scale=scale, internal=[W, H],
                output=[eng.out_width, eng.out_height], build=build,
                stages=stages)



def report(res: dict, out=print) -> None:
    clock = "CUDA events" if res["card"] else "host clock (CPU)"
    out(f"profile_frame {res['output'][0]}x{res['output'][1]} at scale "
        f"{res['scale']:.4g} ({res['internal'][0]}x{res['internal'][1]} "
        f"inside) on {res['card'] or res['device']}, ms ({clock}): first "
        f"call, eager, capture, replay (the mean over captures), the "
        f"replays' spread")
    for name, t in res["stages"].items():
        cols = (t[k] for k in ("first_call_ms", "eager_ms", "capture_ms",
                               "replay_ms"))
        out(f"  {name:45s} " + " ".join(map(timing.fmt_ms, cols)) + "  "
            + timing.fmt_spread(t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=2.0 / 3.0)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", help="write the whole result here")
    a = ap.parse_args(argv)
    res = profile_frame(a.device, a.scale, a.width, a.height)
    report(res)
    timing.write_json(res, a.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
