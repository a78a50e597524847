"""Smoke test of the PyTorch + CUDA port (rtvb_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the hand-written CUDA kernels from rtvb_tpu_torch/csrc (one nvcc
   per source, all started together);
2. holds each kernel against its plain PyTorch version on the same CUDA
   inputs at the shapes the 1080p frame gives it (error, CUDA-event times
   of the card's work with a spin kernel queued ahead so the host's launch
   latency stays out, the card's bound for the same work, a one-call
   PyTorch yardstick where one exists); K1 (trace) on the frame's own five
   ray waves as captured from a frame (closest hit at bounces 0-2, any hit
   on bounce 0's shadow rays and on bounces 1-2's batched), random rays at
   the GI shapes and sun shadow rays, its bound counting the sub-steps
   these rays march (the plain version's tally); K6 (à-trous) on the
   frame's own four passes (steps 1, 2, 4, 8), at steps 16, 32, 128 and
   256 (the last two past a block's shared memory, on a column lattice)
   and at phi_normal 32 and 80 (its generic instance; 80 by powf); K2
   (triangles) on the frame's own five launches as captured (bounces 0-2
   and the two shadow waves), the scene camera's rays, random rays, and
   rays in the planes of tilted triangles (tests/torch_tri_probes.py,
   where Möller–Trumbore's determinant is mostly rounding; one of them
   must hit at t = 2, u = 0, v = 1); a frame's time of K1, K2, K4 and K6
   summed from the launches the frame makes; K5 nearest against
   grid_sample in 7 rounds of 20 calls, the order reversed every round;
   registers, stack frames and spills from the ptxas report, and K1's,
   K2's, K4's and K6's resident blocks an SM computed from them; K4
   (fused shade) on the frame's own bounce-0 and bounce-1 inputs: (a) as
   the frame calls it,
   (b) with a synthetic 200-slot light table, 8 candidates, 3 taps and
   entity MIS, (c) at 960×540 with 2 candidates and no taps, (d) with blue
   noise off, (e) with 5 candidates and 2 taps (the kernel's generic
   instance), (f) bounce 1 as the frame calls it (the instance that also
   runs bounce 2), (g) and (h) the synthetic table with (24 candidates,
   6 taps) and (40, 8), past the compile-time instances' counts;
   proctex (the procedural texture stack, textures.sample_scale and
   sample_normal_delta) on the path tracer's own bounce-0 inputs of a
   2560×1440 frame and of its 1/2 rung, both entry points, bit for bit,
   its bound from its 20 or 24 B a pixel and the operations of the
   pattern each pixel's tex_id selects;
3. drives the main path — Engine(device="cuda") with the shipped
   Settings() at 1920×1080 (fused shading, native resolution) — through
   warm-up and timed frames, every kernel's launch counter reset just
   before and read just after; K4 must launch 3 times a frame and proctex
   twice (normal mapping on);
4. checks the frame: u8 shape, finite, non-constant, primary hit fraction;
   then renders two 1080p frames each at settings the dev panel reaches
   past the shipped ones (atrous_iterations 9 with phi_normal 80.0, whose
   K6 steps reach 256; restir_temporal_samples 6, K4's generic instance),
   each checked and with its own launch counts;
5. drives the in-line configuration (slice_settings: fused shading off),
   its launch counters reset just before its warm-up frames and read just
   after (K1-K3, K5, K6 launched, K4 not), and times it in turns with the
   main path, for the record;
6. profiles three more frames (torch.profiler): host ms per engine stage,
   the device's busy share, device ops per frame, the top device kernels;
7. renders two frames at 320×180 with the kernels on the card and with
   the plain versions on the CPU, for both configurations, and compares
   them like the CPU slice tests;
8. the dynamic-resolution rungs (3/4, 2/3, 1/2 of the 1920×1080 output):
   K7 (EASU) against its plain version, bit for bit, on the tone-mapped
   frames the engine upscales at each rung and at a mixed per-axis ratio
   (214×120 → 320×180); each rung's frames with their own launch counts
   (K7 once a frame, K4 three times, K1-K3, K5, K6 launched); the rungs
   and the native frame in turns, and a profile at the 1/2 rung; a walk
   of the DynamicResolution controller fed with measured frame times; two
   frames at the 2/3 rung of 384×216 on the card against the CPU;
9. the gameplay path (the interactive app's Engine calls, 1920×1080, the
   shipped settings with block_highlight): set_sky to midnight, aim at
   the ground, pick_block (timed), warm_light_variant_async, a lantern
   placed on the picked face (the edit latency: set_block through the
   first frame after it), the lit frames with their own launch counts
   (K4 at (8 candidates, 3 taps) and (2, 0)) and in turns with the
   shipped unlit frame; K4's lit instances and K2 on the lit frame's own
   calls, bit for bit; the lantern deleted, 500 bricks by set_blocks in
   place of the visible ground (the exception list grows to 1024, the
   march's tables unchanged) and K1 on the next frame's own calls, bit for
   bit, and in turns against the tables from before the edit; a UI overlay and apply_settings with pre_pass,
   lens_flare, crosshair and the Preetham sky, two frames; then frames
   1 and 2 of the lit, highlighted night world at 320×180 on the card
   against the CPU, and the pick on both equal;
10. live entities (1920×1080, the gameplay settings): a character added
   as the interactive app adds one walks 30 frames across the ground in
   view (Character.update against the engine's host grid, then
   render_realtime_device), its replays against eager frames of a copy
   made before the walk, bit for bit in frames and states, with exactly
   one capture; K2 on the frame's own five launches against the 128-row
   soup (16 flower rows + the character's 72) and K3 on its own call
   (the character's albedo among its images), bit for bit and timed; the
   pack's host and card ms; the walking frame's ms (replays, median of 8
   after 2) with its launch counts; the card frame against the CPU frame
   at 320×180; the same at midnight with the lantern (a 256-row soup);
   then 20 edits that keep every table's shape (written in place: no
   recapture; edit_ms split into the host rebuild, the upload and the
   frame), one growing edit (500 bricks: one capture), and live and
   reserved memory flat over 20 edit-and-walk cycles;
11. the frame as a CUDA graph (1920×1080, the shipped settings; the
   engine replays a captured graph for render_realtime_device and
   render_realtime_device_batch, and `_eager_frame` runs the captured
   function op by op, which the phases above use where they hook the
   frame's calls): the 8-frame batch against 8 eager frames of a copy of
   the same states, bit for bit in frames and states, twice, natively and
   at the 1/2 rung (K7 replayed); one-frame replays against eager frames
   along 10 frames of the flythrough, then a set_block (written in place:
   no recapture) and 3 more; restir_temporal_samples 6 (K4's generic
   instance) replayed;
   launch counts under replay equal the eager ones; then in turns on one
   engine the eager frame, the one-frame replay and the batch's time a
   frame, capture ms, peak memory with and without graphs, profiles of
   replays and of eager frames, and live and reserved memory over 20
   edit-and-frame cycles (flat, no capture);
12. the profiling tools (rtvb_tpu_torch/tools/) at 1920×1080 with the
   shipped settings: first, in a process of their own that has run no
   profiler (`chip_smoke.py --timing-tools PATH`; replays timed after a
   torch.profiler session drift by up to a tenth), profile_frame at
   scale 1 and 2/3 (each stage's first call, eager, capture, replay),
   ablate_pt at 2/3 with all nine variants timed as replays, its full
   replay within 10% of profile_frame's path-trace replay, micro_pt and
   micro_post, every replay time the mean over eight captures; then here
   device_trace at scale 1 and at the 1/2 rung on one engine (three
   eager frames under torch.profiler with the Python stacks, each device
   kernel attributed through the profiler's correlation to its launching
   op and dtypes, the innermost rtvb_tpu_torch function and the stage;
   three replays in turns with them in the same profile), each hand
   kernel in its kernel-name group with the launch counters' count for
   the same frames (K1-K6 at scale 1, K7 too at 1/2), the port functions
   holding ≥ 95% of the eager device time and the eager busy ms within
   10% of the replays'; the top 15 port functions at each scale printed;
   all of it under "tools" in chip_smoke.json;
13. the frame as 4 extended row bands (rtvb_tpu_torch/parallel/) at
   1920×1080, the shipped settings with full-res GI (rows 270, halo 37,
   ext 344, from rows 0, 233, 503, 736), run band after band on the one
   card by LocalBands, its launch counts reset just before its frames and
   read just after (K1-K6; K4 12 times a frame): three frames, two with
   the camera still and one moved, against the unsharded frame of the
   same engine — frame 1 equal (u8, own rows of the slow history and of
   every reservoir plane, to the bit), frame 2 with every reservoir plane
   to the bit and the u8 frame at the whole-frame bar, frame 3 reported
   (each band scales its v-motion by its own rows, as the JAX package's
   do) beside the same frames with the v-motion rescaled to the image's
   rows (a what-if, which must come closer); K4 at the four band offsets,
   K5 and K6 at 344 rows on a banded frame's own calls, bit for bit;
   K5 nearest at 1920×344 against grid_sample in 7 rounds of 20 calls,
   the order reversed every round; each band step's ms, the banded and
   the unsharded frame in turns, peak memory; a real NCCL group of one rank
   through sharded_frame_fn's all-gather, three frames equal to the
   unsharded ones bit for bit;
14. the interactive app (apps/interactive.py) at 1920×1080 with the app's
   settings (shipped + block_highlight, dynamic resolution on), driven
   through its own loop and its own StdinInputSource by scripted keys: the
   MainMenu, NEW GAME, CREATE; the dev panel and one live setting
   (tone_mapping.gain); look down, descend, dig, select the lantern and
   place it; wait for dynamic resolution to hold a rung; the first-person
   camera with the character walking; F5; quit.  Its launch counts reset
   just before and read just after; it checks that the captures are the
   rule's (the first frame, each new rung, the dev-panel edit, the
   lantern), that K7 launched once for each frame below scale 1, that the
   scales are a fresh controller's on the recorded times, that every
   presented frame is 1080×1920 u8 and not blank, that the saved world
   loads back bit for bit and that the first replay after the edit equals
   an eager frame of a copy, bit for bit; it prints the tracker's summary
   row, the completed-frame ms, the scales and the captures;
15. the offline app (apps/offline.py) against data/canonical's goldens at
   their own sizes and frame counts (the 128² canonical, the 512² one,
   the three scripted edit sequences at 96², the flythrough's frame 16):
   each verdict with RMSE, SSIM and diff share, held to "close" where the
   JAX package itself meets the golden and otherwise to the reference's
   own miss; each accumulated golden's card frame is held to the port's
   CPU render of the same run at "close" (the 512² run at its frame 4);
   then the accumulated frame's ms at 512² and 720², in turns; K1-K5 and
   proctex must have launched.

Exits non-zero, without the final line, on any failure or without a card.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON.  Every measured case goes to chiprun_out/chip_smoke.json
and nvcc's register / spill report to chiprun_out/nvcc_ptxas.log.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np

from rtvb_tpu_torch.tools import device_trace as DT
from rtvb_tpu_torch.tools.timing import (card_line, cuda_ms, sync,
                                         timed_rounds)

REPO = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(REPO, "chiprun_out")
FRAME = (1920, 1080)          # the product frame (width, height)
VS_CPU = (320, 180)           # whole-frame card-vs-CPU comparison size

# each hand kernel: csrc source, the TPU pallas_call it replaces (or none:
# the port's own kernel of a piece the JAX package leaves to XLA)
KERNELS = {
    "trace": ("rtvb_tpu_torch/csrc/trace_kernel.cu",
              "rtvb_tpu/ops/trace_kernel.py:208"),
    "tri": ("rtvb_tpu_torch/csrc/tri_kernel.cu",
            "rtvb_tpu/ops/tri_kernel.py:142"),
    "texture": ("rtvb_tpu_torch/csrc/texture_kernel.cu",
                "rtvb_tpu/assets/image_textures.py:507"),
    "warp": ("rtvb_tpu_torch/csrc/warp_kernel.cu",
             "rtvb_tpu/ops/warp_kernel.py:160"),
    "atrous": ("rtvb_tpu_torch/csrc/atrous_kernel.cu",
               "rtvb_tpu/ops/denoise/atrous_kernel.py:130"),
    "shade": ("rtvb_tpu_torch/csrc/shade_kernel.cu",
              "rtvb_tpu/render/ris_kernel.py:484"),
    "easu": ("rtvb_tpu_torch/csrc/easu_kernel.cu",
             "rtvb_tpu/ops/easu_kernel.py:249"),
    "proctex": ("rtvb_tpu_torch/csrc/proctex_kernel.cu",
                "none, the port's own"),
}
# kernels that run only below render_scale 1, on the rung frames' path
RUNG_ONLY = ("easu",)
RUNGS = {"1/2": 0.5, "2/3": 2.0 / 3.0, "3/4": 0.75}
RUNG_VS_CPU = (384, 216)      # card-vs-CPU at the 2/3 rung: 256×144 inside

# the least time the card could take for a kernel's work: its bytes (each
# input read once, each output written once) over the memory rate, or its
# operations over the f32 rate outside the tensor cores, whichever is
# larger (NVIDIA H100 SXM data sheet, at its 700 W limit).  The f32 rate
# of 67 T/s counts an FMA as two operations; every kernel builds with
# --fmad=false, so each product and each sum issues on its own, at half
# that rate
HBM_BYTES_PER_S = 3.35e12
F32_NON_FMA_OPS_PER_S = 33.5e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def errors(a, b):
    """(max abs, max rel) error of tensor a against reference b."""
    import torch
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    finite = torch.isfinite(b)
    check(bool((torch.isfinite(a) == finite).all()), "non-finite mismatch")
    d = (a - b).abs()[finite]
    if d.numel() == 0:
        return 0.0, 0.0
    rel = d / b.abs()[finite].clamp(min=1e-6)
    return float(d.max()), float(rel.max())


def bound_ms(n_bytes: float, n_ops: float):
    """(bound ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_NON_FMA_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Report:
    def __init__(self):
        self.cases = []

    def case(self, kernel, name, kern_fn, plain_fn, compare, work, n=10,
             library_fn=None):
        """compare(kernel_out, plain_out) → (max_abs, max_rel); raises on
        a disagreement beyond the case's stated tolerance.  work = (bytes,
        operations) of the case; library_fn: one PyTorch call computing
        the same function (a yardstick the port never calls)."""
        k_out = kern_fn()
        p_out = plain_fn()
        sync()
        abs_e, rel_e = compare(k_out, p_out)
        ms = cuda_ms(kern_fn, n)
        plain_ms = cuda_ms(plain_fn, n)
        lib_ms = cuda_ms(library_fn, n) if library_fn is not None else None
        b_ms, b_by = bound_ms(*work)
        self.cases.append(dict(kernel=kernel, case=name, max_abs_err=abs_e,
                               max_rel_err=rel_e, ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               bytes=work[0], ops=work[1],
                               library_ms=lib_ms))
        lib = "" if lib_ms is None else f"  library {lib_ms:.4f} ms"
        log(f"  {kernel:8s} {name:40s} max_abs {abs_e:.3g}  max_rel "
            f"{rel_e:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by}){lib}")


def exact(fields):
    """Comparison that requires bit equality of the named record fields."""
    import torch

    def cmp(a, b):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype == torch.float32:
                x, y = x.contiguous().view(torch.int32), \
                    y.contiguous().view(torch.int32)
            bad = int((x != y).sum())
            check(bad == 0, f"{f}: {bad} values differ")
        return 0.0, 0.0
    return cmp


def capture_frame_calls(eng, run=None):
    """The K1, K6, K2 and K5 calls of one frame (run(), by default one
    eager frame of `eng`, which advances the engine's state like any
    frame), their tensors copied: ([(o, d, t_cap, any_hit)], [(illum, var,
    depth, normal, step, phis)], [(o, d, tri, t_cap)], [(bilinear, hist,
    sy, sx)]) in call order."""
    from rtvb_tpu_torch.ops import triangles
    from rtvb_tpu_torch.ops.denoise import passes
    from rtvb_tpu_torch.render import denoiser, pathtracer, restir
    traces, atrous, tris, warps = [], [], [], []
    orig_trace, orig_atrous = pathtracer.trace, denoiser.atrous_pass
    orig_tri = triangles.intersect_packed
    orig_nearest, orig_bilinear = restir.warp_nearest, passes.warp_bilinear

    def rec_trace(o, d, tables, tp, t_cap=None, any_hit=False):
        traces.append((tuple(c.clone() for c in o),
                       tuple(c.clone() for c in d),
                       None if t_cap is None else t_cap.clone(), any_hit))
        return orig_trace(o, d, tables, tp, t_cap=t_cap, any_hit=any_hit)

    def rec_atrous(illum, var, depth, normal, step, *phis):
        atrous.append((illum.clone(), var.clone(), depth.clone(),
                       normal.clone(), step, phis))
        return orig_atrous(illum, var, depth, normal, step, *phis)

    def rec_tri(o, d, tri, t_cap=None):
        tris.append((tuple(c.clone() for c in o),
                     tuple(c.clone() for c in d), tri.clone(),
                     None if t_cap is None else t_cap.clone()))
        return orig_tri(o, d, tri, t_cap)

    def rec_nearest(h, sy, sx):
        warps.append((False, h.clone(), sy.clone(), sx.clone()))
        return orig_nearest(h, sy, sx)

    def rec_bilinear(h, sy, sx, pair_channels=0):
        check(pair_channels == 6, f"bilinear warp with {pair_channels}")
        warps.append((True, h.clone(), sy.clone(), sx.clone()))
        return orig_bilinear(h, sy, sx, pair_channels)
    pathtracer.trace, denoiser.atrous_pass = rec_trace, rec_atrous
    triangles.intersect_packed = rec_tri
    restir.warp_nearest, passes.warp_bilinear = rec_nearest, rec_bilinear
    try:
        (run or eng._eager_frame)()
    finally:
        pathtracer.trace, denoiser.atrous_pass = orig_trace, orig_atrous
        triangles.intersect_packed = orig_tri
        restir.warp_nearest, passes.warp_bilinear = orig_nearest, \
            orig_bilinear
    return traces, atrous, tris, warps


def trace_inputs(eng, traces) -> dict:
    """K1's cases: {label: (o, d, t_cap, any_hit)}.  First the frame's five
    launches as captured (closest hit at bounce 0 and the half-res bounces
    1 and 2; any hit on bounce 0's shadow rays and on bounces 1-2's batched
    into one wave), then random rays at the GI shapes and shadow rays
    toward the sun from the primary hits."""
    import torch
    from rtvb_tpu_torch.core.camera import camera_rays
    from rtvb_tpu_torch.ops import dda
    from rtvb_tpu_torch.ops import mathutil as m
    bounces = eng.settings.rendering.total_bounce_limit
    check(len(traces) == bounces + 2 and not any(c[3] for c in
                                                 traces[:bounces]),
          f"{len(traces)} K1 calls in a frame")
    cases = {}
    for i, (o, d, cap, any_hit) in enumerate(traces):
        h, w = o[0].shape
        what = (f"bounce {i} closest" if not any_hit else
                "bounce 0 shadows, any hit" if i == bounces else
                "bounces 1-2 shadows batched, any hit")
        cases[f"frame {what} {w}x{h}"] = (o, d, cap, any_hit)
    dev = eng.device
    H, W = eng.height, eng.width
    gen = torch.Generator(device="cpu").manual_seed(7)
    h2, w2 = H // 2, W // 2
    ro, rd = random_rays(gen, h2, w2, dev)
    cases[f"random rays {w2}x{h2}, closest"] = (ro, rd, None, False)
    bo, bd = random_rays(gen, 2 * h2, w2, dev)
    bcap = (torch.rand(2 * h2, w2, generator=gen) * 59.5 + 0.5).to(dev)
    cases[f"random rays {w2}x{2 * h2}, any hit"] = (bo, bd, bcap, True)
    o, d = camera_rays(eng.camera, W, H)
    o = tuple(c.contiguous() for c in o)
    d = tuple(c.contiguous() for c in d)
    rec = dda.trace(o, d, eng._tables, eng._tp)
    p = m.add(o, m.scale(d, torch.where(rec.hit, rec.t, 0.0)))
    n = (rec.nx, rec.ny, rec.nz)
    so = tuple(c.contiguous() for c in m.add(p, m.scale(n, 1e-3)))
    sun = tuple(torch.full_like(p[0], float(c)) for c in
                eng.sky_state.sun_dir)
    cap = torch.where(rec.hit, 1e30, 0.0).contiguous()
    cases[f"sun shadow rays {W}x{H}, any hit"] = (so, sun, cap, True)
    return cases


def random_rays(gen, h, w, dev):
    """(o, d) of h×w random rays over the world (64 × 20 × 64)."""
    import torch
    u = torch.rand(3, h, w, generator=gen)
    o = (u[0] * 64.0, u[1] * 19.0 + 1.0, u[2] * 64.0)
    d = torch.randn(3, h, w, generator=gen)
    d = d / d.norm(dim=0, keepdim=True)
    return (tuple(c.contiguous().to(dev) for c in o),
            tuple(c.contiguous().to(dev) for c in d))


def tri_inputs(eng, tris) -> dict:
    """K2's cases: {label: (o, d, tri, t_cap)}.  First the frame's five
    launches as captured (bounces 0-2 against the soup, capped at the
    voxel hit; bounce 0's shadow rays and bounces 1-2's batched, capped
    at the light and the voxel occluder), then the scene camera's rays
    capped at their voxel hit and K1's random rays at the GI shape."""
    import torch
    from rtvb_tpu_torch.core.camera import camera_rays
    from rtvb_tpu_torch.ops import dda
    bounces = eng.settings.rendering.total_bounce_limit
    check(len(tris) == bounces + 2, f"{len(tris)} K2 calls in a frame")
    cases = {}
    for i, (o, d, tri, cap) in enumerate(tris):
        h, w = o[0].shape
        what = (f"bounce {i} closest" if i < bounces else
                "bounce 0 shadows" if i == bounces else
                "bounces 1-2 shadows batched")
        cases[f"frame {what} {w}x{h}"] = (o, d, tri, cap)
    dev = eng.device
    H, W = eng.height, eng.width
    tri = eng.entity_buffers().tri_packed
    o, d = camera_rays(eng.camera, W, H)
    o = tuple(c.contiguous() for c in o)
    d = tuple(c.contiguous() for c in d)
    t_cap = dda.trace(o, d, eng._tables, eng._tp).t.contiguous()
    n = tri.shape[0]
    cases[f"{n} tris, camera rays {W}x{H}"] = (o, d, tri, t_cap)
    gen = torch.Generator(device="cpu").manual_seed(7)
    h2, w2 = H // 2, W // 2
    ro, rd = random_rays(gen, h2, w2, dev)     # K1's random closest rays
    cases[f"{n} tris, random rays {w2}x{h2}"] = (ro, rd, tri, None)
    return cases


def tri_pairs(o, d, tri, cap, chunk: int = 1 << 15) -> int:
    """The (ray, row) pairs whose segment [0, cap] meets the row's box,
    over the soup's rows that are not padding: the Möller–Trumbore tests
    this run's rays need at least (the kernel's culls test no fewer)."""
    import torch
    v0 = tri[:, 0:3]
    v1, v2 = v0 + tri[:, 3:6], v0 + tri[:, 6:9]
    live = (tri != 0).any(1)
    lo = torch.minimum(torch.minimum(v0, v1), v2)[live]
    hi = torch.maximum(torch.maximum(v0, v1), v2)[live]
    O = torch.stack([c.reshape(-1) for c in o], -1)
    D = torch.stack([c.reshape(-1) for c in d], -1)
    C = (torch.full((O.shape[0],), float("inf"), device=O.device)
         if cap is None else cap.reshape(-1))
    total = 0
    for s in range(0, O.shape[0], chunk):
        oo, dd = O[s:s + chunk, None, :], D[s:s + chunk, None, :]
        t1, t2 = (lo - oo) / dd, (hi - oo) / dd
        flat = dd == 0
        inside = (oo >= lo) & (oo <= hi)
        inf = torch.full_like(t1, float("inf"))
        tmin = torch.where(flat, torch.where(inside, -inf, inf),
                           torch.minimum(t1, t2))
        tmax = torch.where(flat, torch.where(inside, inf, -inf),
                           torch.maximum(t1, t2))
        near = torch.clamp(tmin.amax(-1), min=0.0)
        far = torch.minimum(tmax.amin(-1), C[s:s + chunk, None])
        total += int((near <= far).sum())
    return total


def tri_work(o, d, tri, cap):
    """(bytes, ops) of one K2 launch: the rays (24 B) and their cap where
    the call passes one (4 B) in, the record out (the 1-byte hit, t, the
    triangle and u, v: 17 B), the soup once; Möller–Trumbore's 27 flops
    for each (ray, row) pair this run's data needs (tri_pairs)."""
    n_rays = o[0].numel()
    return (n_rays * (24 + 4 * (cap is not None) + 17) + nbytes(tri),
            27 * tri_pairs(o, d, tri, cap))


def _probes():
    """tests/torch_tri_probes.py (numpy and the port only)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        import torch_tri_probes
    finally:
        sys.path.pop(0)
    return torch_tri_probes


PLANE_RAY_O = (24.085620880126953, 32.62156677246094, 15.408795356750488)


def in_plane_inputs(dev, seed: int = 1, n: int = 2000):
    """K2's in-plane probe: the soup of tests/torch_tri_probes.py
    `in_plane_soup` (a lone tilted triangle under each 4-row box) and
    `in_plane_rays` (2 and 20 units out in each triangle's plane, a few
    ulps off it), the plane ray first → (soup, o, d) on `dev`."""
    import torch
    pr = _probes()
    soup = pr.in_plane_soup(seed)
    o, d = pr.in_plane_rays(soup, seed, n)
    check(tuple(float(c[0]) for c in o) == PLANE_RAY_O, "plane ray first")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return T(soup), tuple(T(c) for c in o), tuple(T(c) for c in d)


def atlas_sectors(atlas, t_count, tid, u, v, lvl) -> dict:
    """The distinct 32-byte sectors of K3's atlas reads for these inputs,
    counted from the plain version's level choice and texel indices: of
    the planar atlas (3 words a tap) and of the interleaved copy (one
    16-byte texel a tap), and their bytes."""
    import torch
    from rtvb_tpu_torch.assets import image_textures as it
    lvl_i = lvl.to(torch.int32)
    l0t = torch.clamp(it._tile_reduce_min(lvl_i, it.LEVELS - 1), 0,
                      it.LEVELS - 2)
    cand = torch.where((lvl_i == l0t) & (tid >= 0), tid,
                       it.MAX_TEXTURES).to(torch.int32)
    t_hi = it._tile_reduce_min(cand, it.MAX_TEXTURES)
    main_hi = (l0t < it.HI_LEVELS) & (t_hi < t_count) & (tid == t_hi)
    la = torch.where(main_hi, l0t, torch.clamp(l0t, min=it.HI_LEVELS))
    use = tid >= 0
    hi_w, lo_w = atlas.hi[0].numel(), atlas.lo[0].numel()
    words = []
    for li in (la, torch.clamp(la + 1, max=it.LEVELS - 1)):
        s = it.S0 >> li
        x0, y0, x1, y1, _, _ = it._bilinear_coords(u, v, s)
        for py, px in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
            is_hi = li < it.HI_LEVELS
            hi_off = torch.where(li == 0, 0, torch.where(li == 1, 512, 768))
            hi_idx = torch.clamp(tid * it.HI_ROWS + hi_off + py, 0,
                                 atlas.hi.shape[1] - 1) * it.S0 + px
            s_lo = 64 >> (torch.clamp(li, min=it.HI_LEVELS) - it.HI_LEVELS)
            lo_idx = torch.clamp(tid * it.LO_ROWS + (it.LO_ROWS - 8)
                                 - 2 * s_lo + py, 0,
                                 atlas.lo.shape[1] - 1) * it.LO_COLS + px
            # one index space: the hi texels, then the lo texels
            words.append(torch.where(is_hi, hi_idx.long(),
                                     hi_w + lo_idx.long())[use])
    texel = torch.unique(torch.cat(words))
    n_texels = int(texel.numel())
    sec4 = int(torch.unique(texel // 2).numel())      # 16 B texels
    # planar: 3 planes, 8 words a sector
    hi_t = texel[texel < hi_w]
    lo_t = texel[texel >= hi_w] - hi_w
    sec_planar = 3 * (int(torch.unique(hi_t // 8).numel())
                      + int(torch.unique(lo_t // 8).numel()))
    return dict(texels=n_texels, sectors_interleaved=sec4,
                bytes_interleaved=32 * sec4, sectors_planar=sec_planar,
                bytes_planar=32 * sec_planar, words_total=hi_w + lo_w)


def texture_inputs(eng):
    """K3's case: the frame's primary hits at the scene camera, their
    material's texture, triplanar uv and ray-cone level → (atlas, t_count,
    tid, u, v, lvl)."""
    import torch
    from rtvb_tpu_torch.assets import image_textures as it
    from rtvb_tpu_torch.assets import textures
    from rtvb_tpu_torch.core.camera import camera_rays
    from rtvb_tpu_torch.ops import dda
    from rtvb_tpu_torch.ops import mathutil as m
    from rtvb_tpu_torch.ops.alias_table import take
    H, W = eng.height, eng.width
    o, d = camera_rays(eng.camera, W, H)
    o = tuple(c.contiguous() for c in o)
    d = tuple(c.contiguous() for c in d)
    rec = dda.trace(o, d, eng._tables, eng._tp)
    p = m.add(o, m.scale(d, torch.where(rec.hit, rec.t, 0.0)))
    n = (rec.nx, rec.ny, rec.nz)
    mats = eng.materials
    img = take(mats.image_id, rec.mi).contiguous()
    u, v = textures.triplanar_uv(p[0], p[1], p[2], *n)
    uvs = take(mats.uv_scale, rec.mi)
    u = (u * uvs).contiguous()
    v = (v * uvs).contiguous()
    inc = torch.clamp(torch.abs(m.dot(n, d)), min=0.25)
    lod = rec.t * eng.camera.pixel_cone_spread(H) * 8.0 / inc
    atlas = eng.texture_atlas
    t_count = it.atlas_count(atlas)
    tid = torch.clamp(img, -1, t_count - 1).contiguous()
    return atlas, t_count, tid, u, v, it.level_from_lod(lod).contiguous()


def easu_inputs(eng) -> dict:
    """K7's cases: the tone-mapped frame each rung hands to EASU, and a
    mixed per-axis ratio (the 2/3 rung of 320×180 renders 214×120);
    {label: (img, out_h, out_w)}.  Leaves `eng` at scale 1."""
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    inputs = {}
    for label, scale in RUNGS.items():
        eng.set_render_scale(scale)
        inputs[f"{label} rung"] = capture_easu_input(eng)
    eng.set_render_scale(1.0)
    small = Engine(settings=Settings().replace(rendering={
        "render_width": VS_CPU[0], "render_height": VS_CPU[1],
        "render_scale": RUNGS["2/3"]}), device=eng.device)
    inputs["mixed ratio"] = capture_easu_input(small)
    return inputs


def atrous_inputs(eng, atrous) -> dict:
    """K6's cases: {label: (illum, var, depth, normal, step, phis)}: the
    frame's passes as captured (steps 1, 2, 4, 8), then on the first
    pass's inputs step 16, step 32 (a window past the default 48 KB of
    shared memory), steps 128 and 256 (past a block's shared memory: the
    columns on the step's lattice too) and step 1 at phi_normal 32 and 80
    (the generic instance, 80 by powf)."""
    steps = [a[4] for a in atrous]
    n_it = eng.settings.denoising.atrous_iterations
    check(steps == [1 << i for i in range(n_it)],
          f"K6 steps in a frame: {steps}")
    cases = {}
    for illum, var, depth, normal, step, phis in atrous:
        H, W = depth.shape
        cases[f"frame step {step}, {W}x{H}"] = (illum, var, depth, normal,
                                                step, phis)
    illum, var, depth, normal, _, phis = atrous[0]
    for step in (16, 32, 128, 256):
        cases[f"step {step}, {W}x{H}"] = (illum, var, depth, normal, step,
                                          phis)
    phi_lum, _, phi_depth = phis
    for phi in (32.0, 80.0):
        cases[f"step 1, phi_normal {phi:g} (generic), {W}x{H}"] = (
            illum, var, depth, normal, 1, (phi_lum, phi, phi_depth))
    return cases


# K1's operations, counted from csrc/trace_kernel.cu: a ray's set-up and
# epilogue (3 reciprocals, the slabs, the exit caps, the first column; the
# closest hit's normal and material-index search), and one sub-step's
# unconditional path (the column's y range against its mask, the next
# column, the supercolumn lookups and tests); the skips' branches, taken
# on some sub-steps, are not counted
TRACE_SETUP_OPS = {False: 120, True: 70}
TRACE_SUBSTEP_OPS = 96
# K6's: per tap ≈ 39 flops (luminance 5, depth weight 4, normal dot and 6
# squarings 12, luminance weight 3, the exponent 3, the weight 2, the four
# sums 10), 24 taps and ≈ 15 for the centre
ATROUS_PIXEL_OPS = 24 * 39 + 15


def trace_work(eng, o, d, cap, any_hit):
    """(bytes, ops, sub-steps) of one K1 launch.  Bytes: what the function
    needs to move, each once: the rays (24 B a ray), their cap only where
    the call passes one (4 B), the record out as the function returns it
    (a 1-byte hit and the 4-byte t, and for closest hit the voxel, normal
    and material, 28 B more), the tables the instance reads (the march's
    three, and for closest hit the epilogue's).  Ops: the set-up per ray
    and the sub-steps these rays run, from the plain version's count."""
    from rtvb_tpu_torch.ops import dda
    tab = eng._tables
    n_rays = o[0].numel()
    per = 24 + (4 if cap is not None else 0) + (5 if any_hit else 33)
    read = [tab.colmask, tab.df, tab.maxh]
    if not any_hit:
        read += [tab.schema, tab.exc_mask, tab.exc_key, tab.exc_id,
                 tab.block_to_mat]
    n_sub = dda.substeps(o, d, tab, eng._tp, cap, any_hit)
    return (n_rays * per + nbytes(*read),
            TRACE_SETUP_OPS[any_hit] * n_rays + TRACE_SUBSTEP_OPS * n_sub,
            n_sub)


def kernel_cases(eng, rep: Report, traces, atrous, tris):
    """K1, K2, K3, K5, K6 against their plain versions on CUDA inputs taken
    from the engine's frame (its size, half of it for the GI waves)."""
    import torch
    from rtvb_tpu_torch.assets import image_textures as it
    from rtvb_tpu_torch.core.camera import camera_rays
    from rtvb_tpu_torch.ops import dda, triangles, warp_kernel
    from rtvb_tpu_torch.ops import mathutil as m
    from rtvb_tpu_torch.ops.denoise import atrous_kernel, passes
    from rtvb_tpu_torch.ops.pack import pack2, unpack2

    dev = eng.device
    H, W = eng.height, eng.width
    tables, tp = eng._tables, eng._tp
    gen = torch.Generator(device="cpu").manual_seed(7)

    def rnd(*shape, lo=0.0, hi=1.0):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).to(dev)

    # --- K1: the frame's five waves, then random and sun-shadow rays
    o, d = camera_rays(eng.camera, W, H)
    o = tuple(c.contiguous() for c in o)
    d = tuple(c.contiguous() for c in d)
    rec = dda.trace(o, d, tables, tp)
    hit_frac = float(rec.hit.float().mean())
    log(f"primary hit fraction at the scene camera: {hit_frac:.4f}")
    check(0.5 < hit_frac < 0.9, f"hit fraction {hit_frac} off 0.7")
    p = m.add(o, m.scale(d, torch.where(rec.hit, rec.t, 0.0)))
    n = (rec.nx, rec.ny, rec.nz)
    substeps = {}
    k1 = trace_inputs(eng, traces)
    for label, (to, td, tc, ah) in k1.items():
        n_bytes, n_ops, n_sub = trace_work(eng, to, td, tc, ah)
        substeps[label] = dict(rays=to[0].numel(), substeps=n_sub)
        log(f"    {label}: {n_sub} sub-steps, "
            f"{n_sub / max(to[0].numel(), 1):.2f} a ray")
        rep.case("trace", label,
                 lambda a=(to, td, tc, ah): dda.trace_cuda(
                     a[0], a[1], tables, tp, a[2], a[3]),
                 lambda a=(to, td, tc, ah): dda.trace_plain(
                     a[0], a[1], tables, tp, a[2], a[3]),
                 exact(("hit", "t") if ah else dda.HitRecord._fields),
                 (n_bytes, n_ops))

    # --- K2: the frame's five launches, then the flower soup against the
    # scene camera's rays and random rays
    for label, (to, td, tt, tc) in tri_inputs(eng, tris).items():
        rep.case("tri", label,
                 lambda a=(to, td, tt, tc): triangles.intersect_packed_cuda(
                     *a),
                 lambda a=(to, td, tt, tc): triangles.intersect_packed_plain(
                     *a),
                 exact(triangles.TriHit._fields), tri_work(to, td, tt, tc))

    # rays in the planes of tilted triangles, where the determinant is
    # mostly rounding: the cull must drop none of the plain version's hits
    soup, po, pd = in_plane_inputs(dev)
    rep.case("tri", f"in-plane probe rays {po[0].numel()}, "
             f"{int((soup[:, 3:6] != 0).any(1).sum())} tilted tris",
             lambda: triangles.intersect_packed_cuda(po, pd, soup),
             lambda: triangles.intersect_packed_plain(po, pd, soup),
             exact(triangles.TriHit._fields), tri_work(po, pd, soup, None))
    ph = triangles.intersect_packed_cuda(po, pd, soup)
    plane_hit = (bool(ph.hit[0]), float(ph.t[0]), float(ph.u[0]),
                 float(ph.v[0]))
    log(f"    the plane ray (o {PLANE_RAY_O}): hit, t, u, v = {plane_hit}")
    check(plane_hit == (True, 2.0, 0.0, 1.0),
          f"K2 on the plane ray: {plane_hit}")

    # --- K3: the authored atlas at the frame's primary-hit lod field
    atlas, t_count, tid, u, v, lvl = texture_inputs(eng)
    use = tid >= 0
    check(float(use.float().mean()) > 0.3, "too few textured pixels")

    def tex_cmp(a, b):
        out = (0.0, 0.0)
        n_diff = 0
        for c in range(6):
            x = torch.where(use, a[c], 0.0)
            y = torch.where(use, b[c], 0.0)
            e = errors(x, y)
            check(e[0] <= 1e-6, f"texture channel {c}: max abs {e[0]}")
            out = (max(out[0], e[0]), max(out[1], e[1]))
            n_diff += int((x.view(torch.int32) != y.view(torch.int32)).sum())
        log(f"    texture: {n_diff} values differ in a bit")
        return out
    check(atlas.hi4 is not None, "the card's atlas has no interleaved copy")
    log(f"    the atlas's sectors of 32 bytes the frame's inputs touch: "
        f"{atlas_sectors(atlas, t_count, tid, u, v, lvl)}")
    rep.case("texture", f"{t_count} textures, {W}x{H} lod field",
             lambda: it._sample_cuda(atlas, t_count, tid, u, v, lvl),
             lambda: it._sample_ref(atlas, t_count, tid, u, v, lvl), tex_cmp,
             # tid, u, v, level in, 6 channels out (the texels read depend
             # on the data: not counted); 2 levels × 4 taps × 6 channels
             # of bilinear blends ≈ 100 flops a pixel
             (H * W * (16 + 24), 100 * H * W))

    # --- K5: ReSTIR reservoirs (nearest, bitwise) and the denoiser history
    # (bilinear, 6 bf16 pairs) under a camera-pan warp
    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    sy = (yy + 3.3 + 0.8 * torch.sin(xx / 97.0)).contiguous()
    sx = (xx - 7.6 + 0.8 * torch.cos(yy / 61.0)).contiguous()
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, H, W), generator=gen,
                         dtype=torch.int32).to(dev)
    hist8 = bits.view(torch.float32)
    # yardstick: torch's grid_sample over the same source coordinates
    # (pixel centres → normalised, edge-clamped), timed only here
    grid = torch.stack([(sx + 0.5) / W * 2.0 - 1.0,
                        (sy + 0.5) / H * 2.0 - 1.0], dim=-1)[None]
    grid_sample = torch.nn.functional.grid_sample
    rep.case("warp", f"nearest, 8 planes {W}x{H}",
             lambda: warp_kernel._warp_cuda(hist8, sy, sx, False, 0),
             lambda: warp_kernel.warp_nearest_ref(hist8, sy, sx),
             lambda a, b: _cmp_pairs(a, b, exact_bits=True),
             (H * W * (8 + 8 * 4 + 8 * 4 + 1), 4 * H * W),
             library_fn=lambda: grid_sample(
                 hist8[None], grid, mode="nearest", padding_mode="border",
                 align_corners=False))
    vals = rnd(13, H, W, lo=-4.0, hi=4.0)
    hist7 = torch.stack([pack2(vals[2 * c], vals[2 * c + 1])
                         for c in range(6)] + [vals[12]]).contiguous()
    vals13 = torch.stack([x for c in range(6) for x in unpack2(hist7[c])]
                         + [vals[12]])[None].contiguous()
    rep.case("warp", f"bilinear, 7 planes (6 pairs) {W}x{H}",
             lambda: warp_kernel._warp_cuda(hist7, sy, sx, True, 6),
             lambda: warp_kernel.warp_bilinear_ref(hist7, sy, sx, 6),
             lambda a, b: _cmp_pairs(a, b, exact_bits=False, tol=1e-6),
             (H * W * (8 + 7 * 4 + 13 * 4 + 1), 8 * 13 * H * W),
             library_fn=lambda: grid_sample(
                 vals13, grid, mode="bilinear", padding_mode="border",
                 align_corners=False))

    # --- K6: the denoiser's à-trous passes as the frame runs them
    def atrous_cmp(a, b, label):
        e1 = errors(a[0], b[0])
        e2 = errors(a[1], b[1])
        check(e1[1] <= 1e-5 or e1[0] <= 1e-6, f"atrous illum {e1}")
        check(e2[1] <= 1e-5 or e2[0] <= 1e-7, f"atrous var {e2}")
        n_diff = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                     for x, y in zip(a, b))
        log(f"    {label}: {n_diff} values differ in a bit")
        return max(e1[0], e2[0]), max(e1[1], e2[1])
    for label, args in atrous_inputs(eng, atrous).items():
        rep.case("atrous", label,
                 lambda a=args: atrous_kernel._atrous_cuda(*a[:5], *a[5]),
                 lambda a=args: passes.atrous_pass_plain(*a[:5], *a[5]),
                 lambda a, b, label=label: atrous_cmp(a, b, label),
                 # illum, var, depth, normal in; illum, var out
                 (H * W * (32 + 16), ATROUS_PIXEL_OPS * H * W))
    return substeps


# ---------------------------------------------------------------------------
# K4, the fused shade kernel
# ---------------------------------------------------------------------------

def synthetic_lights(k: int, n_lit: int, seed: int, device):
    """A LightTable of k slots holding n_lit random emissive triangles
    (alias table over luminance × area, random entity flags)."""
    from rtvb_tpu_torch.ops import alias_table
    from rtvb_tpu_torch.world import lighting
    r = np.random.default_rng(seed)
    v0 = np.zeros((k, 3), np.float32)
    e1 = np.zeros((k, 3), np.float32)
    e2 = np.zeros((k, 3), np.float32)
    nrm = np.zeros((k, 3), np.float32)
    area = np.zeros(k, np.float32)
    rad = np.zeros((k, 3), np.float32)
    w = np.zeros(k)
    for i in range(n_lit):
        v0[i] = r.uniform([0, 2, 0], [64, 24, 64])
        e1[i] = r.normal(size=3) * 0.6
        e2[i] = r.normal(size=3) * 0.6
        c = np.cross(e1[i], e2[i])
        nrm[i] = c / max(np.linalg.norm(c), 1e-12)
        area[i] = 0.5 * np.linalg.norm(c)
        rad[i] = r.uniform(0.5, 20.0, 3)
        w[i] = (0.2126 * rad[i, 0] + 0.7152 * rad[i, 1]
                + 0.0722 * rad[i, 2]) * area[i]
    tab = alias_table.build(w)
    arrays = dict(area=area, rad_r=rad[:, 0], rad_g=rad[:, 1],
                  rad_b=rad[:, 2], key=np.arange(k, dtype=np.int32),
                  ent=r.random(k) < 0.4, active=np.arange(k) < n_lit,
                  count=n_lit, prob=tab.prob, alias=tab.alias, pmf=tab.pmf)
    for i, c in enumerate("xyz"):
        arrays.update({f"v0{c}": v0[:, i], f"e1{c}": e1[:, i],
                       f"e2{c}": e2[:, i], f"n{c}": nrm[:, i]})
    arrays = {f: np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a
              for f, a in arrays.items()}
    return lighting.light_table_from_numpy(arrays, device)


def capture_shade_calls(eng, run=None):
    """The fused_shade calls of one frame (run(), by default one eager
    frame of `eng`, which advances the engine's state like any frame):
    [(args, kwargs)] per call."""
    from rtvb_tpu_torch.render import ris_kernel as RK
    calls = []
    orig = RK.fused_shade

    def record(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)
    RK.fused_shade = record
    try:
        (run or eng._eager_frame)()
    finally:
        RK.fused_shade = orig
    return calls


def shade_cases(eng, seed: int = 5):
    """The six K4 cases on the frame's own inputs: {name: (args, kw)}.
    (a) bounce 0 as the frame calls it; (b) bounce 0 with a synthetic
    200-slot light table, 8 candidates, 3 taps, entity MIS; (c) bounce 1
    (half resolution) with the synthetic table, 2 candidates, no taps;
    (d) bounce 0 with blue noise off; (e) bounce 0 with the synthetic
    table, 5 candidates and 2 taps, which runs the kernel's generic
    instance (runtime counts); (f) bounce 1 as the frame calls it, the
    instance that bounces 1 and 2 run; (g) and (h) bounce 0 with the
    synthetic table, (24 candidates, 6 taps) and (40, 8), the frame's
    three taps repeated, past the compile-time instances' counts."""
    from rtvb_tpu_torch.render import ris_kernel as RK
    from rtvb_tpu_torch.render import sky as sky_mod
    calls = capture_shade_calls(eng)
    check(len(calls) == eng.settings.rendering.total_bounce_limit,
          f"{len(calls)} fused_shade calls in a frame")
    (a0, kw0), (a1, kw1) = calls[0], calls[1]
    check(a0[0].n_taps == 3 and a0[0].blue_noise and a1[0].n_taps == 0,
          f"unexpected frame configs {a0[0]} {a1[0]}")
    dev = eng.device
    lights = synthetic_lights(200, 150, seed, dev)
    remap = random_remap(200, seed, dev)
    lf, li = RK.pack_light_tables(lights, remap)
    sf = sky_mod.sky_scalar_pack(eng.sky_state, True)

    def with_lights(args, **cfg):
        c = args[0]._replace(k_slots=200, **cfg)
        return (c, args[1], args[2], sf, lf, li) + tuple(args[6:])
    (h0, w0), (h1, w1) = a0[8][0].shape, a1[8][0].shape
    return {
        f"(a) bounce 0 {w0}x{h0}, 3 taps, blue noise": (a0, kw0),
        f"(b) 200 lights {w0}x{h0}, 8 cand, 3 taps, ent": (
            with_lights(a0, n_local=8, ent_unreachable=True), kw0),
        f"(c) 200 lights {w1}x{h1}, 2 cand, 0 taps": (
            with_lights(a1, n_local=2), kw1),
        f"(d) bounce 0 {w0}x{h0}, 3 taps, white noise": (
            (a0[0]._replace(blue_noise=False),) + tuple(a0[1:]),
            dict(kw0, bn=None)),
        # a pair with no compile-time instance: the generic one
        f"(e) 200 lights {w0}x{h0}, 5 cand, 2 taps (generic)": (
            with_lights(a0, n_local=5, n_taps=2),
            dict(kw0, taps=kw0["taps"][:2])),
        f"(f) bounce 1 {w1}x{h1}, 0 taps, as the frame calls it": (a1, kw1),
        f"(g) 200 lights {w0}x{h0}, 24 cand, 6 taps (generic)": (
            with_lights(a0, n_local=24, n_taps=6, ent_unreachable=True),
            dict(kw0, taps=(kw0["taps"] * 3)[:6])),
        f"(h) 200 lights {w0}x{h0}, 40 cand, 8 taps (generic)": (
            with_lights(a0, n_local=40, n_taps=8, ent_unreachable=True),
            dict(kw0, taps=(kw0["taps"] * 3)[:8])),
    }


def random_remap(k: int, seed: int, device):
    """A light-slot remap holding -1s (slots removed by an edit)."""
    import torch
    r = np.random.default_rng(seed).permutation(k).astype(np.int32)
    r[::7] = -1
    return torch.from_numpy(r).to(device)


def shade_work(args, kw):
    """(bytes, ops) of one K4 launch: every input plane read once, the 26
    output planes written once, the tables; ops ≈ 100 flops per RIS
    candidate (the luminance BSDF proxy and the weights), 120 per tap,
    450 for winner shading and the BSDF sample."""
    from rtvb_tpu_torch.render import ris_kernel as RK
    cfg = args[0]
    H, W = args[8][0].shape
    n_in = 15 + (1 + 9 * cfg.n_taps if cfg.n_taps else 0) \
        + (4 if cfg.blue_noise else 0)
    tables = nbytes(*args[3:8])
    flops = 100 * (cfg.n_local + 2) + 120 * cfg.n_taps + 450
    return H * W * 4 * (n_in + RK.N_OUT) + tables, flops * H * W


def shade_diff(a, b) -> dict:
    """K4 against its plain version: the share of pixels whose four int
    outputs all agree, the count of float values that differ in any bit,
    the largest errors of a float output on the pixels where the ints
    agree, and the count of those values off by more than 1e-5 relative
    (1e-7 absolute near zero)."""
    import torch
    from rtvb_tpu_torch.render import ris_kernel as RK
    fa, fb = RK.flatten_out(a), RK.flatten_out(b)
    agree = torch.ones_like(fa[0], dtype=torch.bool)
    for k in RK.OUT_I32:
        agree &= fa[k] == fb[k]
    out = dict(int_agree=float(agree.float().mean()), float_bits_differ={},
               max_rel=0.0, max_abs=0.0, n_over_tol=0)
    for k, (x, y) in enumerate(zip(fa, fb)):
        if k in RK.OUT_I32:
            continue
        bits = int((x.view(torch.int32) != y.view(torch.int32)).sum())
        if bits:
            out["float_bits_differ"][k] = bits
        xd, yd = x.double()[agree], y.double()[agree]
        same = (xd == yd) | (torch.isnan(xd) & torch.isnan(yd))
        d = (xd - yd).abs()
        d = torch.where(same, 0.0, d)
        rel = d / yd.abs().clamp(min=1e-6)
        out["n_over_tol"] += int((d > (1e-5 * yd.abs()).clamp(min=1e-7))
                                 .sum())
        if d.numel():
            out["max_abs"] = max(out["max_abs"], float(d.max()))
            out["max_rel"] = max(out["max_rel"], float(rel.max()))
    return out


def shade_check(d: dict):
    """The bar: ints equal on ≥ 99.9% of pixels, floats within 1e-5
    relative where they are (absolute 1e-7 near zero)."""
    check(d["int_agree"] >= 0.999, f"shade ints agree on {d['int_agree']}")
    check(d["n_over_tol"] == 0,
          f"shade floats: {d['n_over_tol']} values over the bar (max rel "
          f"{d['max_rel']}, max abs {d['max_abs']})")


def shade_kernel_cases(eng, rep: "Report"):
    from rtvb_tpu_torch.render import ris_kernel as RK
    diffs = {}
    for name, (args, kw) in shade_cases(eng).items():
        def cmp(a, b, name=name):
            d = shade_diff(a, b)
            diffs[name] = d
            log(f"    {name}: ints agree {d['int_agree']:.6f}, float values "
                f"differing in a bit per output {d['float_bits_differ']}")
            shade_check(d)
            return d["max_abs"], d["max_rel"]
        rep.case("shade", name,
                 lambda a=args, k=kw: RK.fused_shade_cuda(*a, **k),
                 lambda a=args, k=kw: RK.fused_shade_plain(*a, **k),
                 cmp, shade_work(args, kw))
    return diffs


def _cmp_pairs(a, b, exact_bits: bool, tol: float = 0.0):
    """(out, valid) of the warp kernel against the plain version."""
    import torch
    check(bool((a[1] == b[1]).all()), "warp valid mask differs")
    if exact_bits:
        bad = int((a[0].view(torch.int32) != b[0].view(torch.int32)).sum())
        check(bad == 0, f"warp nearest: {bad} words differ")
        return 0.0, 0.0
    e = errors(a[0], b[0])
    check(e[0] <= tol, f"warp bilinear max abs {e[0]}")
    return e


def frame_run(eng, n_warm: int = 2, n_timed: int = 8):
    """The port's main path: warm-up + timed frames → (median ms, the
    frame times, u8, median ms until the call returned, i.e. the host's
    enqueue time before the final synchronize)."""
    out = None
    for _ in range(n_warm):
        out = eng.render_realtime_device()
    sync()
    times, enqueue = [], []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        out = eng.render_realtime_device()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, out, statistics.median(enqueue)


def interleaved(engines: dict, n_pairs: int) -> dict:
    """Frame times of several engines rendered in turns, the order
    reversed every other turn: {label: [ms, ...]}."""
    out = {k: [] for k in engines}
    labels = list(engines)
    for i in range(n_pairs):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            sync()
            t0 = time.perf_counter()
            engines[label].render_realtime_device()
            sync()
            out[label].append((time.perf_counter() - t0) * 1e3)
    return out


def profile(label: str, frame_fn, eng, n: int = 3) -> dict:
    """torch.profiler over n frames of frame_fn (device_trace's summary,
    without the callers' ranges), logged; eager frames must show each stage's
    range once a frame."""
    prof = DT.profile_frames(frame_fn, n, eng.device, callers=False)
    for name, st in prof["stages"].items():
        check(st["ranges"] == n, f"profiler saw {st['ranges']} {name} ranges")
    DT.log_summary(label, prof, log)
    return prof


def copy_states(src, dst):
    """Carry the feedback states of one engine to another (a copy each:
    the engines write their states in place)."""
    from rtvb_tpu_torch.render.denoiser import DenoiserState
    from rtvb_tpu_torch.render.postprocess import PostState
    from rtvb_tpu_torch.render.restir import ReSTIRState
    dev = dst.device
    dst.denoiser_state = DenoiserState(
        *(t.to(dev, copy=True) for t in src.denoiser_state))
    dst.restir_state = ReSTIRState(
        data=src.restir_state.data.to(dev, copy=True))
    dst.post_state = PostState(
        exposure=src.post_state.exposure.to(dev, copy=True))
    dst.frame_index = src.frame_index


def whole_frame_vs_cpu(settings, setup=None):
    """Frames 1 and 2 with the kernels on the card against the plain
    versions on the CPU; frame 2 starts both from the card's frame-1
    state.  Bars of tests/test_torch_slice.py.  setup(engine), if given,
    runs on both engines first; what it returns must agree."""
    import torch
    from rtvb_tpu_torch.render.renderer import Engine
    gpu = Engine(settings=settings, device="cuda")
    cpu = Engine(settings=settings, device="cpu")
    if setup is not None:
        got = setup(gpu), setup(cpu)
        log(f"  set-up on the card / the CPU: {got[0]} / {got[1]}")
        check(got[0] == got[1], f"set-up differs: {got}")
    width, height = gpu.width, gpu.height
    results = []
    for frame in range(2):
        if frame == 1:
            copy_states(gpu, cpu)
        gpu._ensure_states()
        cpu._ensure_states()
        if frame == 0:
            gg, _ = gpu.render_gbuffers()
            cg, _ = cpu.render_gbuffers()
            planes = [("depth", gg.depth, cg.depth),
                      ("roughness", gg.roughness, cg.roughness),
                      ("motion_u", gg.motion_u, cg.motion_u),
                      ("motion_v", gg.motion_v, cg.motion_v)]
            for name in ("normal", "albedo"):
                for i in range(3):
                    planes.append((f"{name}{i}", getattr(gg, name)[i],
                                   getattr(cg, name)[i]))
            if gg.highlight is not None:
                planes.append(("highlight", gg.highlight, cg.highlight))
            for name, a, b in planes:
                a, b = a.cpu().numpy(), b.numpy()
                frac = float(np.mean(np.isclose(a, b, rtol=1e-4, atol=1e-4)))
                check(frac >= 0.999, f"G-buffer {name}: {frac} within 1e-4")
        a = gpu.render_realtime()
        b = cpu.render_realtime()
        dd = np.abs(a.astype(np.int32) - b.astype(np.int32))
        mean_d = float(dd.mean())
        frac3 = float(np.mean(dd.max(axis=-1) <= 3))
        log(f"  frame {frame + 1} at {width}x{height}: u8 mean |d| "
            f"{mean_d:.4f}, pixels within 3/255 {frac3:.4f}")
        check(mean_d <= 1.0 and frac3 >= 0.90,
              f"whole frame {frame + 1} differs: {mean_d}, {frac3}")
        results.append(dict(frame=frame + 1, mean_abs_u8=mean_d,
                            frac_within_3=frac3))
    return results


# ---------------------------------------------------------------------------
# K7 and the dynamic-resolution rungs
# ---------------------------------------------------------------------------

def capture_easu_input(eng):
    """The (img, out_h, out_w) that one eager frame of `eng` hands to the
    EASU wrapper (the frame advances the engine like any frame)."""
    from rtvb_tpu_torch.ops import easu_kernel as EK
    seen = []
    orig = EK.easu

    def record(img, out_h, out_w):
        seen.append((img, out_h, out_w))
        return orig(img, out_h, out_w)
    EK.easu = record
    try:
        eng._eager_frame()
    finally:
        EK.easu = orig
    check(len(seen) == 1, f"{len(seen)} EASU calls in a frame at scale "
          f"{eng.render_scale}")
    return seen[0]


def easu_work(img, out_h: int, out_w: int):
    """(bytes, ops) of one K7 launch: the (H, W, 3) f32 input read once,
    the (out_h, out_w, 3) f32 output written once; ops counted from the
    source: ≈ 25 flops per input texel (luma, the field) and ≈ 390 per
    output pixel (the field blend, 12 taps × ≈ 26, the division and the
    quad clamp)."""
    H, W = img.shape[:2]
    return 12 * (H * W + out_h * out_w), 25 * H * W + 390 * out_h * out_w


def easu_kernel_cases(inputs: dict, rep: Report):
    """K7 against easu_plain, bit for bit, on each captured input."""
    import torch
    from rtvb_tpu_torch.ops import easu_kernel as EK

    def cmp(a, b):
        check(a.shape == b.shape, f"easu shapes {a.shape} {b.shape}")
        bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        check(bad == 0, f"easu: {bad} values differ")
        return 0.0, 0.0
    for label, (img, oh, ow) in inputs.items():
        h, w = img.shape[:2]
        rep.case("easu", f"{label}: {w}x{h} -> {ow}x{oh}",
                 lambda i=img, a=oh, b=ow: EK._easu_cuda(i, a, b),
                 lambda i=img, a=oh, b=ow: EK.easu_plain(i, a, b), cmp,
                 easu_work(img, oh, ow))


# the procedural texture stack's cases: the benchmark's 2560×1440 window,
# natively and at the 1/2 rung
PROCTEX_FRAME = (2560, 1440)
# proctex's operations, counted from csrc/proctex_kernel.cu (each integer
# and float operation of the source, sinf as 30): a lattice hash 16 (its
# key 4, pcg_hash 9, to_unit_float 3); a value noise 91 (coordinates,
# floors and fractions 6, two smoothsteps 8, two conversions and the
# neighbours' 2, four hashes 64, three lerps 9); an fBm 189 (two noises
# and 7); the stripes 127 (a noise, the sine and 6); the bricks 18 on
# mortar (a brick's face adds its noise and 2, not counted).  Per
# evaluation, by tex_id from -1: nothing, the fBms, stripes, bricks and
# the flat pattern, each with the contrast's 3
PROCTEX_EVAL_OPS = (0, 192, 192, 192, 130, 21, 3)
PROCTEX_LOD_OPS = 4          # 1 / (1 + 2 lod) * 0.6, once a pixel
PROCTEX_DELTA_OPS = 8        # u ± eps, v ± eps, two differences, two products


def proctex_work(tid, lod, delta: bool):
    """(bytes, ops) of one proctex launch: tex_id, u, v (and lod) in,
    4 B a pixel out (scale) or 8 B (du, dv); the operations of each
    pixel's evaluations by its tex_id (4 of them for the delta)."""
    import torch
    n = tid.numel()
    hist = torch.bincount((tid.clamp(-1, 5) + 1).long().flatten(),
                          minlength=len(PROCTEX_EVAL_OPS)).tolist()
    evals = sum(c * o for c, o in zip(hist, PROCTEX_EVAL_OPS))
    ops = (4 if delta else 1) * evals + n * (
        (PROCTEX_DELTA_OPS if delta else 0)
        + (PROCTEX_LOD_OPS if lod is not None else 0))
    n_bytes = n * (12 + (4 if lod is not None else 0) + (8 if delta else 4))
    return n_bytes, ops


def capture_proctex_calls(eng) -> dict:
    """The path tracer's bounce-0 calls of the texture stack in one eager
    frame of `eng` → {"scale": (tex_id, u, v, lod), "normal delta": ...},
    u and v already scaled by the material's uv_scale."""
    from rtvb_tpu_torch.assets import textures
    names = {"scale": "sample_scale", "normal delta": "sample_normal_delta"}
    orig = {k: getattr(textures, n) for k, n in names.items()}
    calls = {k: [] for k in names}

    def recorder(key):
        def rec(tex_id, u, v, lod=None, **kw):
            calls[key].append(tuple(None if t is None else t.clone()
                                    for t in (tex_id, u, v, lod)))
            return orig[key](tex_id, u, v, lod, **kw)
        return rec
    for key, name in names.items():
        setattr(textures, name, recorder(key))
    try:
        eng._eager_frame()
    finally:
        for key, name in names.items():
            setattr(textures, name, orig[key])
    for key, c in calls.items():
        check(len(c) == 1, f"{len(c)} {key} calls of the stack in a frame")
    return {key: c[0] for key, c in calls.items()}


def proctex_kernel_cases(settings, rep: Report) -> dict:
    """proctex against the plain stack, bit for bit, on the path tracer's
    own bounce-0 inputs at 2560×1440 and at its 1/2 rung (both entry
    points), timed → {label: tex_id shares}."""
    import torch
    from rtvb_tpu_torch.assets import textures
    from rtvb_tpu_torch.render.renderer import Engine
    pw, ph = PROCTEX_FRAME
    eng = Engine(settings=settings.replace(rendering={
        "render_width": pw, "render_height": ph}), device="cuda")

    def bits(a, b):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        check(len(a) == len(b), "proctex: outputs differ in number")
        for x, y in zip(a, b):
            bad = int((x.view(torch.int32) != y.view(torch.int32)).sum())
            check(bad == 0, f"proctex: {bad} values differ")
        return 0.0, 0.0
    shares = {}
    for label, scale in (("native", 1.0), ("1/2 rung", 0.5)):
        eng.set_render_scale(scale)
        calls = capture_proctex_calls(eng)
        W, H = eng.width, eng.height
        for key, args in calls.items():
            tid, u, v, lod = args
            check(tuple(u.shape) == (H, W), f"proctex {key} at {label}: "
                  f"shape {tuple(u.shape)}")
            fn, plain = (
                (textures.sample_scale, textures._sample_scale_plain)
                if key == "scale" else
                (textures.sample_normal_delta,
                 textures._sample_normal_delta_plain))
            rep.case("proctex", f"{key}, frame's bounce 0 {label} {W}x{H}",
                     lambda f=fn, a=args: f(*a), lambda f=plain, a=args: f(*a),
                     bits, proctex_work(tid, lod, key != "scale"))
        ids, cnt = torch.unique(calls["scale"][0], return_counts=True)
        shares[label] = {int(i): round(int(c) / calls["scale"][0].numel(), 4)
                         for i, c in zip(ids.tolist(), cnt.tolist())}
        log(f"    proctex at {label}: tex_id shares {shares[label]}")
    del eng
    return shares


def check_frame(out, shape, label):
    import torch
    u8 = out.cpu().numpy()
    check(u8.shape == shape and u8.dtype == np.uint8,
          f"{label}: frame shape {u8.shape} {u8.dtype}")
    check(bool(torch.isfinite(out.float()).all()), f"{label}: not finite")
    check(u8.std() > 1.0, f"{label}: frame is constant")


def rung_frames(eng, K, n_warm: int, n_timed: int) -> dict:
    """Each rung on `eng`: launch counts reset right before its warm-up
    and timed frames and read right after."""
    out = {}
    n_frames = n_warm + n_timed
    shape = (eng.out_height, eng.out_width, 3)
    bounces = eng.settings.rendering.total_bounce_limit
    for label, scale in RUNGS.items():
        eng.set_render_scale(scale)
        K.reset_launch_counts()
        ms, times, frame, enq = frame_run(eng, n_warm, n_timed)
        counts = K.launch_counts()
        log(f"rung {label} ({eng.width}x{eng.height} -> {eng.out_width}x"
            f"{eng.out_height}): median {ms:.3f} ms "
            f"{[round(t, 3) for t in times]}; host enqueue median "
            f"{enq:.3f} ms; launches {counts}")
        check(counts["easu"] == n_frames,
              f"rung {label}: easu launched {counts['easu']} times in "
              f"{n_frames} frames")
        check(counts["shade"] == bounces * n_frames,
              f"rung {label}: shade launched {counts['shade']} times")
        for name in KERNELS:
            check(counts.get(name, 0) > 0,
                  f"rung {label}: kernel {name} never launched")
        check_frame(frame, shape, f"rung {label}")
        out[label] = dict(scale=scale, internal=(eng.width, eng.height),
                          frame_ms=ms, frame_ms_all=times, enqueue_ms=enq,
                          launches=counts)
    return out


def widened_frames(shipped, K, n_frames: int = 2) -> dict:
    """Frames at settings past the shipped ones that the dev panel reaches
    (Settings.adjust): atrous_iterations 9 with phi_normal 80.0 (K6 at
    steps 1 … 256, its generic instance), restir_temporal_samples 6 (K4's
    generic instance at bounce 0).  Each engine renders n_frames with its
    launch counts reset just before and read just after."""
    from rtvb_tpu_torch.render.renderer import Engine
    fh, fw = shipped.rendering.render_height, shipped.rendering.render_width
    out = {}
    for label, st in (
            ("atrous_iterations 9, phi_normal 80", shipped.replace(
                denoising={"atrous_iterations": 9, "phi_normal": 80.0})),
            ("restir_temporal_samples 6", shipped.replace(
                rendering={"restir_temporal_samples": 6}))):
        eng = Engine(settings=st, device="cuda")
        K.reset_launch_counts()
        times = []
        for _ in range(n_frames):
            t0 = time.perf_counter()
            frame = eng.render_realtime_device()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        log(f"frame {fw}x{fh} at {label}: ms {[round(t, 3) for t in times]};"
            f" launches {counts}")
        check_frame(frame, (fh, fw, 3), label)
        its = st.denoising.atrous_iterations
        check(counts["atrous"] == its * n_frames,
              f"{label}: atrous launched {counts['atrous']} times")
        check(counts["shade"] == st.rendering.total_bounce_limit * n_frames,
              f"{label}: shade launched {counts['shade']} times")
        for name in KERNELS:
            if name not in RUNG_ONLY:
                check(counts.get(name, 0) > 0,
                      f"{label}: kernel {name} never launched")
        out[label] = dict(frame_ms=times, launches=counts)
        del eng
    return out


# ---------------------------------------------------------------------------
# The gameplay path: the interactive app's Engine calls at 1920×1080
# ---------------------------------------------------------------------------

# the camera aimed at the ground, the centre ray's voxel within the pick's
# reach (a +y face at 6.3 units)
GAMEPLAY_POSE = dict(pos=(32.0, 14.0, 8.0), yaw=1.1, pitch=-0.9)
DEV_PANEL = dict(denoising={"pre_pass": True},
                 post_processing={"lens_flare": True, "crosshair": True},
                 sky={"model": "preetham"})


def gameplay_settings(width: int, height: int):
    """The interactive app's config: the shipped settings with the picked
    block's highlight."""
    from rtvb_tpu_torch.core.config import Settings
    return Settings().replace(rendering={
        "render_width": width, "render_height": height,
        "block_highlight": True})


def night_with_lantern(eng):
    """set_sky to midnight, aim at the ground, pick, and place a lantern on
    the picked face (the app's right click) → the pick."""
    from rtvb_tpu_torch.assets import blocks as B
    eng.set_sky(time_of_day=0.0)
    eng.set_camera(**GAMEPLAY_POSE)
    pick = eng.pick_block()
    hit, (x, y, z), n = pick
    check(hit, f"the gameplay pose picks nothing: {pick}")
    eng.set_block(int(x + n[0]), int(y + n[1]), int(z + n[2]), B.LANTERN)
    check(eng._n_local > 0, "the lantern lit no light")
    return pick


def surface_bricks(eng):
    """(500, 3) voxel coordinates: the top solid voxel of each column x
    5-54, z 5-14, in front of and below the gameplay camera.  Bricks there
    deviate from the terrain schema but occupy what was occupied: the
    exception list grows and the march's tables (occupancy, distance
    field, height envelope) stay as they were."""
    cfg = eng.cfg
    xs, zs = np.meshgrid(np.arange(5, 55), np.arange(5, 15))
    xs, zs = xs.ravel(), zs.ravel()
    cols = eng.world.colmask.cpu().numpy().view(np.uint32)
    top = np.array([int(cols[x * cfg.z + z]).bit_length() - 1
                    for x, z in zip(xs, zs)])
    check((top >= 0).all(), "a column without a solid voxel")
    return np.stack([xs, top, zs], axis=1)


def bit_exact_shade(a, b):
    """K4 against its plain version: every output plane equal to the bit."""
    d = shade_diff(a, b)
    check(d["int_agree"] == 1.0 and not d["float_bits_differ"],
          f"lit K4 differs: ints agree {d['int_agree']}, float values "
          f"differing {d['float_bits_differ']}")
    return 0.0, 0.0


def gameplay(shipped, K, rep: Report) -> dict:
    """The gameplay path at 1920×1080: Engine(gameplay_settings) on the
    card; set_sky(0); aim, pick_block and place a lantern on the picked
    face; warm_light_variant_async; the lit frames (launch counts reset
    just before, read just after), then in turns with the shipped unlit
    frame; K4's lit instances and K2 on the lit frame's own calls, bit for
    bit; delete the lantern; 500 bricks by set_blocks in place of the
    visible ground (the exception list grows past 512) and K1 on the
    frame's own calls with the grown list, bit for bit; a UI overlay and
    apply_settings with the four dev-panel settings, two frames.  Prints
    the lit frame's median ms, the edit latency (set_block through the
    first frame after it) and the pick's time."""
    import torch
    from rtvb_tpu_torch.assets import blocks as B
    from rtvb_tpu_torch.ops import dda, triangles
    from rtvb_tpu_torch.render import ris_kernel as RK
    from rtvb_tpu_torch.render.renderer import Engine
    fw, fh = FRAME
    shape = (fh, fw, 3)
    eng = Engine(settings=gameplay_settings(fw, fh), device="cuda")
    eng.set_sky(time_of_day=0.0)
    eng.set_camera(**GAMEPLAY_POSE)
    for _ in range(2):                 # unlit: the app's frames before
        eng.render_realtime_device()
    sync()
    picks = []
    for _ in range(10):
        t0 = time.perf_counter()
        pick = eng.pick_block()
        picks.append((time.perf_counter() - t0) * 1e3)
    pick_ms = statistics.median(picks)
    hit, (x, y, z), n = pick
    check(hit and n == (0.0, 1.0, 0.0), f"gameplay pick {pick}")
    log(f"pick_block: {pick}; median {pick_ms:.3f} ms of 10 "
        f"{[round(t, 3) for t in picks]}")

    warm = eng.warm_light_variant_async()
    check(warm is not None, "warm_light_variant_async returned None")
    t0 = time.perf_counter()
    warm.join(timeout=300)
    check(not warm.is_alive(), "the light-variant warm-up did not end")
    warm_ms = (time.perf_counter() - t0) * 1e3
    log(f"light-variant warm-up: joined after {warm_ms:.1f} ms")

    soup0 = eng.entity_buffers().tri_packed.shape[0]
    sync()
    t0 = time.perf_counter()
    eng.set_block(int(x + n[0]), int(y + n[1]), int(z + n[2]), B.LANTERN)
    edit_host_ms = (time.perf_counter() - t0) * 1e3
    out = eng.render_realtime_device()
    sync()
    edit_ms = (time.perf_counter() - t0) * 1e3
    lit_capture = eng.graph_log[-1]
    check(lit_capture["key"][-1] == eng._n_local,
          f"the first lit frame captured no lit graph: {lit_capture}")
    log(f"the lit variant's graph: capture "
        f"{lit_capture['capture_ms']:.3f} ms")
    check(eng._n_local == eng.settings.rendering.local_light_candidates,
          "the lantern did not light the frame")
    soup1 = eng.entity_buffers().tri_packed.shape[0]
    log(f"edit latency (set_block through the first frame after it): "
        f"{edit_ms:.3f} ms, of which set_block {edit_host_ms:.3f} ms; "
        f"lights {eng.lights.count}, soup rows {soup0} -> {soup1}")
    check(soup1 > soup0, "the lantern did not grow the soup")
    check_frame(out, shape, "first lit frame")

    n_warm, n_timed = 2, 8
    K.reset_launch_counts()
    lit_ms, lit_times, out, lit_enq = frame_run(eng, n_warm, n_timed)
    counts = K.launch_counts()
    n_frames = n_warm + n_timed
    log(f"lit gameplay frame {fw}x{fh}: median {lit_ms:.3f} ms "
        f"{[round(t, 3) for t in lit_times]}; host enqueue median "
        f"{lit_enq:.3f} ms; launches {counts}")
    for name in KERNELS:
        if name in RUNG_ONLY:
            check(counts.get(name, 0) == 0, f"gameplay launched {name}")
        else:
            check(counts.get(name, 0) > 0,
                  f"kernel {name} never launched in the gameplay frames")
    check(counts["shade"] == 3 * n_frames,
          f"gameplay: shade launched {counts['shade']} times")
    check_frame(out, shape, "lit gameplay frame")
    turns = interleaved({"lit gameplay": eng, "shipped": shipped}, n_pairs=8)
    for label, ts in turns.items():
        log(f"frame {fw}x{fh} in turns, {label}: median "
            f"{statistics.median(ts):.3f} ms {[round(t, 3) for t in ts]}")

    # K4's lit instances and K2 on the lit frame's own calls
    calls = capture_shade_calls(eng)
    configs = [(a[0].n_local, a[0].n_taps) for a, _ in calls]
    check(configs == [(8, 3), (2, 0), (2, 0)],
          f"lit frame's K4 instances {configs}")
    for (args, kw), label in zip(calls[:2], (
            f"(i) lit bounce 0 {fw}x{fh}, 8 cand, 3 taps",
            f"(j) lit bounce 1 {fw // 2}x{fh // 2}, 2 cand, 0 taps")):
        rep.case("shade", label,
                 lambda a=args, k=kw: RK.fused_shade_cuda(*a, **k),
                 lambda a=args, k=kw: RK.fused_shade_plain(*a, **k),
                 bit_exact_shade, shade_work(args, kw))
    _, _, tris, _ = capture_frame_calls(eng)
    to, td, tt, tc = tris[0]
    rep.case("tri", f"lit bounce 0, {tt.shape[0]}-row soup",
             lambda: triangles.intersect_packed_cuda(to, td, tt, tc),
             lambda: triangles.intersect_packed_plain(to, td, tt, tc),
             exact(triangles.TriHit._fields), tri_work(to, td, tt, tc))

    # delete, then the bulk edit that grows the exception list: bricks in
    # place of the visible ground, so the frame's rays search the list
    eng.delete_block(int(x + n[0]), int(y + n[1]), int(z + n[2]))
    tables_before = eng._tables
    xyz = surface_bricks(eng)
    sync()
    t0 = time.perf_counter()
    eng.set_blocks(xyz, np.full(len(xyz), B.BRICK, np.uint8))
    bulk_ms = (time.perf_counter() - t0) * 1e3
    n_exc = eng._tables.exc_key.shape[0]
    log(f"set_blocks of {len(xyz)} bricks: {bulk_ms:.3f} ms; exception "
        f"list {n_exc} entries")
    check(n_exc >= 512, f"the exception list did not grow: {n_exc}")
    check(all(torch.equal(getattr(tables_before, f), getattr(eng._tables, f))
              for f in ("colmask", "df", "maxh")),
          "the bricks changed the march's tables")
    K.reset_launch_counts()
    traces, _, _, _ = capture_frame_calls(eng)
    out = eng.render_realtime_device()
    grown_counts = K.launch_counts()
    check_frame(out, shape, "frame with the grown exception list")
    check(grown_counts["trace"] > 0, "K1 not launched on the grown list")
    tables, tp = eng._tables, eng._tp
    brick_mi = eng.materials.block_to_mat[B.BRICK]
    rec0 = dda.trace_cuda(*traces[0][:2], tables, tp)
    brick_share = float((rec0.hit & (rec0.mi == brick_mi)).float().mean())
    log(f"    bounce-0 rays whose hit voxel is a brick (the list searched): "
        f"{brick_share:.4f}")
    check(brick_share > 0.01, "the frame sees no brick")
    for i, (o, d, cap, any_hit) in enumerate(traces):
        fields = ("hit", "t") if any_hit else dda.HitRecord._fields
        if i == 0:          # timed: the closest-hit wave of bounce 0
            rep.case("trace", f"grown list ({n_exc}) bounce 0 closest "
                     f"{fw}x{fh}",
                     lambda: dda.trace_cuda(o, d, tables, tp, cap, any_hit),
                     lambda: dda.trace_plain(o, d, tables, tp, cap, any_hit),
                     exact(fields), trace_work(eng, o, d, cap, any_hit)[:2])
        else:
            exact(fields)(dda.trace_cuda(o, d, tables, tp, cap, any_hit),
                          dda.trace_plain(o, d, tables, tp, cap, any_hit))
    log(f"    K1 on the grown list: the frame's {len(traces)} calls equal "
        f"their plain versions to the bit")
    # the same bounce-0 rays against the tables before the bulk edit (the
    # same march; there the brick voxels are unmarked): the search's cost
    o, d, cap, _ = traces[0]
    k1_rounds = timed_rounds({
        f"{tables_before.exc_key.shape[0]} entries":
            lambda: dda.trace_cuda(o, d, tables_before, tp, cap, False),
        f"{n_exc} entries": lambda: dda.trace_cuda(o, d, tables, tp, cap,
                                                   False)})
    for label, ts in k1_rounds.items():
        log(f"    K1 bounce 0 closest, exception list of {label}: median "
            f"{statistics.median(ts):.4f} ms of 7 rounds "
            f"{[round(t, 4) for t in ts]}")

    # the dev panel: an overlay and the four settings the port now runs
    ov = np.zeros((fh, fw, 4), np.uint8)
    ov[40:200, 60:700] = (230, 230, 240, 160)
    eng.set_ui_overlay(ov)
    eng.apply_settings(eng.settings.replace(**DEV_PANEL))
    K.reset_launch_counts()
    dev_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = eng.render_realtime_device()
        sync()
        dev_times.append((time.perf_counter() - t0) * 1e3)
        check_frame(out, shape, "dev-panel frame")
    dev_counts = K.launch_counts()
    u8 = out.cpu().numpy()
    check((u8[fh // 2, fw // 2 - 1: fw // 2 + 1] == 255).all(),
          "no crosshair at the centre")
    log(f"dev-panel frames (pre_pass, lens_flare, crosshair, preetham, "
        f"overlay): ms {[round(t, 3) for t in dev_times]}; launches "
        f"{dev_counts}")
    return dict(pick=pick, pick_ms=pick_ms, pick_ms_all=picks,
                warm_join_ms=warm_ms, edit_ms=edit_ms,
                lit_capture=lit_capture,
                edit_host_ms=edit_host_ms, soup_rows=(soup0, soup1),
                frame_ms=lit_ms, frame_ms_all=lit_times,
                enqueue_ms=lit_enq, launches=counts, in_turns_ms=turns,
                bulk_edit_ms=bulk_ms, exceptions=n_exc,
                brick_share=brick_share,
                k1_list_rounds=k1_rounds,
                launches_grown=grown_counts, dev_panel_ms=dev_times,
                launches_dev_panel=dev_counts)


def dynres_walk(eng, K, n_frames: int = 30) -> dict:
    """The DynamicResolution controller driving `eng`: each frame's
    measured time is fed to it and the scale it returns applied."""
    from rtvb_tpu_torch.apps.interactive import DynamicResolution
    rs = eng.settings.rendering
    check(rs.dynamic_resolution, "the shipped settings turn dynamic "
          "resolution on")

    def controller():
        return DynamicResolution(target_fps=rs.target_fps,
                                 min_scale=rs.min_render_scale,
                                 start_scale=1.0)
    dr = controller()
    shape = (eng.out_height, eng.out_width, 3)
    scales, times = [], []
    K.reset_launch_counts()
    for _ in range(n_frames):
        eng.set_render_scale(dr.scale)
        scales.append(dr.scale)
        sync()
        t0 = time.perf_counter()
        out = eng.render_realtime_device()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        check(tuple(out.shape) == shape, f"walk frame shape {out.shape}")
        dr.update(times[-1])
    counts = K.launch_counts()
    below = sum(s < 1.0 for s in scales)
    log(f"DynamicResolution walk, {n_frames} frames: scales "
        f"{[round(s, 4) for s in scales]}; ms {[round(t, 1) for t in times]};"
        f" easu launches {counts['easu']}, frames below scale 1: {below}")
    check(counts["easu"] == below, f"walk: easu launched {counts['easu']} "
          f"times in {below} frames below scale 1")
    fresh = controller()
    replay = []
    for t in times:
        replay.append(fresh.scale)
        fresh.update(t)
    check(replay == scales, "walk: the scales differ from a fresh "
          "controller's on the recorded times")
    return dict(scales=scales, frame_ms=times, launches=counts,
                frames_below_1=below)


# ---------------------------------------------------------------------------
# Live entities: a walking character in the captured frame, edits in place
# ---------------------------------------------------------------------------

WALK_DT = 1.0 / 30.0          # the character's step (the app's frame time)
WALK_START = (31.5, 11.5)     # (x, z): in view of GAMEPLAY_POSE, walking +x


def walking_character(eng, start=WALK_START):
    """A Character standing on the ground at `start`, added to `eng` (the
    interactive app always adds one) → the Character."""
    from rtvb_tpu_torch.models.character import Character
    ch = Character(cfg_world=eng.cfg, move=eng.settings.character_movement)
    x, z = start
    col = eng.host_world.blocks[int(x), :, int(z)]
    ch.position = np.array([x, float(col.nonzero()[0].max() + 1), z],
                           np.float32)
    ch.update(eng.host_world, WALK_DT)
    eng.add_entity(ch.entity)
    return ch


def walk(ch, eng):
    """One step of the app's loop: Character.update against the engine's
    host grid (walking +x)."""
    ch.update(eng.host_world, WALK_DT, (1.0, 0.0), False, False, False)


def entity_engine(settings, lantern: bool):
    """Engine(settings) on the card at the gameplay pose with a walking
    character; lantern: midnight and a lantern on the picked face (the
    gameplay phase's set-up) → (engine, character)."""
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=settings, device="cuda")
    if lantern:
        night_with_lantern(eng)
    else:
        eng.set_camera(**GAMEPLAY_POSE)
    return eng, walking_character(eng)


def entity_walk_vs_eager(eng, ch, n: int) -> dict:
    """n frames of the walking character: `eng` replays its captured frame
    (its first frame eager, then the capture) and a copy of it made before
    the walk renders each frame eagerly; frames and states bit for bit.
    Returns the captures over the walk (must be 1) and the soup's rows."""
    ref = copy.copy(eng)
    n0 = len(eng.graph_log)
    ptr = None
    for i in range(n):
        walk(ch, eng)
        frames_equal(eng.render_realtime_device(), ref._eager_frame(),
                     f"walk frame {i}")
        states_equal(eng, ref, f"walk frame {i}")
        ent = eng.entity_buffers()
        check(ptr is None or ent.tri_packed.data_ptr() == ptr,
              "the soup moved during the walk")
        ptr = ent.tri_packed.data_ptr()
    captures = len(eng.graph_log) - n0
    check(captures == 1, f"{captures} captures over a {n}-frame walk")
    return dict(frames=n, captures=captures,
                soup_rows=int(eng.entity_buffers().tri_packed.shape[0]),
                position=[float(v) for v in ch.position])


def capture_texture_call(eng):
    """K3's call in one eager frame of `eng` → (atlas, t_count, tid, u, v,
    lvl) as sample_atlas hands them to the kernel."""
    import torch
    from rtvb_tpu_torch.assets import image_textures as it
    calls = []
    orig = it.sample_atlas

    def rec(atlas, image_id, u, v, lod):
        calls.append((atlas, image_id.clone(), u.clone(), v.clone(),
                      lod.clone()))
        return orig(atlas, image_id, u, v, lod)
    it.sample_atlas = rec
    try:
        eng._eager_frame()
    finally:
        it.sample_atlas = orig
    check(len(calls) == 1, f"{len(calls)} K3 calls in a frame")
    atlas, image_id, u, v, lod = calls[0]
    t_count = it.atlas_count(atlas)
    tid = image_id.to(torch.int32).clamp(-1, t_count - 1).contiguous()
    return (atlas, t_count, tid, u.contiguous(), v.contiguous(),
            it.level_from_lod(lod).contiguous())


def texture_bits(use):
    """K3 against its plain version: every channel equal to the bit where
    a texture is sampled."""
    import torch

    def cmp(a, b):
        for c in range(6):
            x = torch.where(use, a[c], 0.0).view(torch.int32)
            y = torch.where(use, b[c], 0.0).view(torch.int32)
            bad = int((x != y).sum())
            check(bad == 0, f"texture channel {c}: {bad} values differ")
        return 0.0, 0.0
    return cmp


def entity_kernel_cases(eng, rep: "Report", label: str) -> dict:
    """K2 on the frame's own five launches against the soup with the
    character, and K3 on the frame's own call (the character's albedo
    among its images), each bit for bit against its plain version and
    timed → {"tri_ms": the five launches' ms, "texture": counts}."""
    from rtvb_tpu_torch.assets import image_textures as it
    from rtvb_tpu_torch.ops import triangles
    _, _, tris, _ = capture_frame_calls(eng)
    rows = tris[0][2].shape[0]
    tri_ms = []
    for i, (o, d, tri, cap) in enumerate(tris):
        h, w = o[0].shape
        rep.case("tri", f"{label} call {i}, {rows}-row soup {w}x{h}",
                 lambda a=(o, d, tri, cap): triangles.intersect_packed_cuda(
                     *a),
                 lambda a=(o, d, tri, cap): triangles.intersect_packed_plain(
                     *a),
                 exact(triangles.TriHit._fields), tri_work(o, d, tri, cap))
        tri_ms.append(rep.cases[-1]["ms"])
    atlas, t_count, tid, u, v, lvl = capture_texture_call(eng)
    slot = eng.texture_atlas_names.index("character_albedo")
    n_char = int((tid == slot).sum())
    check(n_char > 0, "the frame's K3 call samples no character texel")
    H, W = tid.shape
    rep.case("texture", f"{label} call, {W}x{H}",
             lambda: it._sample_cuda(atlas, t_count, tid, u, v, lvl),
             lambda: it._sample_ref(atlas, t_count, tid, u, v, lvl),
             texture_bits(tid >= 0), (H * W * (16 + 24), 100 * H * W))
    log(f"    {label}: K2 a frame {sum(tri_ms):.4f} ms over 5 launches at "
        f"{rows} rows; K3 samples the character's albedo at {n_char} "
        f"pixels")
    return dict(rows=rows, tri_ms=tri_ms, tri_frame_ms=sum(tri_ms),
                texture_pixels=int((tid >= 0).sum()),
                character_pixels=n_char)


def pack_times(eng, n: int = 20) -> dict:
    """The pack (entity_buffers: the pose matrices through pinned memory,
    the skinning and the row writes): host ms of the call, and the card's
    ms (CUDA events with a spin kernel queued ahead), medians of n."""
    host = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        eng.entity_buffers()
        host.append((time.perf_counter() - t0) * 1e3)
    dev = cuda_ms(eng.entity_buffers, n)
    return dict(host_ms=statistics.median(host), device_ms=dev)


def edits_keeping_shapes(eng, ch, n: int) -> dict:
    """n edits that keep every table's shape (a soil block placed on the
    ground beside the path, then removed, alternately), each followed by
    a walking step and one frame: no recapture.  edit_ms from set_block
    through that frame, split into the host rebuild, the upload (through
    its completion) and the frame."""
    from rtvb_tpu_torch.assets import blocks as B
    x, z = 36, 14
    y = int(eng.host_world.blocks[x, :, z].nonzero()[0].max()) + 1
    n0 = len(eng.graph_log)
    total, host, upload, frame = [], [], [], []
    for i in range(n):
        walk(ch, eng)
        sync()
        t0 = time.perf_counter()
        eng.set_block(x, y, z, B.SOIL if i % 2 == 0 else 0)
        sync()
        t1 = time.perf_counter()
        eng.render_realtime_device()
        sync()
        t2 = time.perf_counter()
        total.append((t2 - t0) * 1e3)
        host.append(eng.last_edit["host_ms"])
        upload.append((t1 - t0) * 1e3 - eng.last_edit["host_ms"])
        frame.append((t2 - t1) * 1e3)
    recaptures = len(eng.graph_log) - n0
    check(recaptures == 0, f"{recaptures} recaptures over {n} edits that "
          f"keep the shapes")

    def med(v):
        return dict(median=statistics.median(v), min=min(v), max=max(v))
    return dict(edits=n, recaptures=recaptures, edit_ms=med(total),
                host_ms=med(host), upload_ms=med(upload),
                frame_ms=med(frame), edit_ms_all=total)


def growing_edit(eng) -> dict:
    """500 bricks in place of the visible ground: the exception list grows
    past its entries, so the next frame captures once."""
    from rtvb_tpu_torch.assets import blocks as B
    n0 = len(eng.graph_log)
    xyz = surface_bricks(eng)
    n_exc0 = eng._tables.exc_key.shape[0]
    sync()
    t0 = time.perf_counter()
    eng.set_blocks(xyz, np.full(len(xyz), B.BRICK, np.uint8))
    eng.render_realtime_device()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    eng.render_realtime_device()
    recaptures = len(eng.graph_log) - n0
    n_exc = eng._tables.exc_key.shape[0]
    check(n_exc > n_exc0, "the bricks did not grow the exception list")
    check(recaptures == 1, f"{recaptures} captures after a growing edit")
    return dict(recaptures=recaptures, exceptions=(n_exc0, n_exc),
                edit_ms=ms, capture=eng.graph_log[-1])


def memory_cycles(eng, ch, cycles: int = 20) -> dict:
    """cycles × (an edit that keeps the shapes, a walking step, a frame):
    live and reserved device memory after each (the reserved after
    empty_cache) must stay flat, and no graph is captured anew."""
    import torch
    from rtvb_tpu_torch.assets import blocks as B
    x, z = 40, 20
    y = int(eng.host_world.blocks[x, :, z].nonzero()[0].max()) + 1
    n0, graphs0 = len(eng.graph_log), len(eng._graphs)
    live, reserved = [], []
    for i in range(cycles):
        eng.set_block(x, y, z, B.BRICK if i % 2 == 0 else 0)
        if ch is not None:
            walk(ch, eng)
        eng.render_realtime_device()
        sync()
        torch.cuda.empty_cache()
        live.append(torch.cuda.memory_allocated())
        reserved.append(torch.cuda.memory_reserved())
    check(len(eng._graphs) == graphs0, f"{len(eng._graphs)} graphs held, "
          f"{graphs0} before")
    check(len(eng.graph_log) == n0, "an edit that keeps the shapes "
          "captured anew")
    mb = 2 ** 20
    grow_live = (max(live[1:]) - live[1]) / mb
    grow_res = (max(reserved[1:]) - reserved[1]) / mb
    log(f"{cycles} edit-and-frame cycles: live MiB "
        f"{[round(v / mb, 1) for v in live]}; reserved MiB after "
        f"empty_cache {[round(v / mb, 1) for v in reserved]}")
    check(grow_live <= 64 and grow_res <= 64,
          f"memory grew over {cycles} cycles: live +{grow_live:.1f} MiB, "
          f"reserved +{grow_res:.1f} MiB")
    return dict(live_bytes=live, reserved_bytes=reserved,
                growth_live_mib=grow_live, growth_reserved_mib=grow_res)


def character_in_view(eng):
    """whole_frame_vs_cpu's set-up: the gameplay pose and a character two
    steps into its walk → the soup's rows."""
    eng.set_camera(**GAMEPLAY_POSE)
    ch = walking_character(eng)
    for _ in range(2):
        walk(ch, eng)
    return int(eng.entity_buffers().tri_packed.shape[0])


def lantern_and_character(eng):
    pick = night_with_lantern(eng)
    return pick, character_in_view(eng)


def entities_phase(K, rep: "Report") -> dict:
    """The walking character at 1920×1080 with the gameplay settings: a
    30-frame walk replayed against eager frames of a copy (one capture),
    K2 and K3 on the frame's own calls, the pack's cost, frame_ms while
    walking (replays, median of 8 after 2, the launch counts reset just
    before and read just after), in turns with an engine without the
    character (daylight only), card against CPU at 320×180; the same
    with the lantern at night; then on the daylight engine 20 edits that
    keep the shapes (no recapture), one growing edit (one), and memory
    over 20 edit-and-walk cycles."""
    fw, fh = FRAME
    out = {}
    keep = None
    for label, lantern in (("entity", False), ("lit entity", True)):
        eng, ch = entity_engine(gameplay_settings(fw, fh), lantern)
        res = dict(walk=entity_walk_vs_eager(eng, ch, 30))
        log(f"{label}: a 30-frame walk, replays bit-exact against eager "
            f"frames of a copy; captures {res['walk']['captures']}; soup "
            f"{res['walk']['soup_rows']} rows; character at "
            f"{res['walk']['position']}")
        res["kernels"] = entity_kernel_cases(eng, rep, f"{label} frame")
        res["pack"] = pack_times(eng)
        log(f"{label}: the pack, host {res['pack']['host_ms']:.3f} ms, card "
            f"{res['pack']['device_ms']:.4f} ms a frame")
        for _ in range(2):
            walk(ch, eng)
            eng.render_realtime_device()
        sync()
        K.reset_launch_counts()
        times = []
        for _ in range(8):
            walk(ch, eng)
            t0 = time.perf_counter()
            frame = eng.render_realtime_device()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res["launches"] = K.launch_counts()
        check_frame(frame, (fh, fw, 3), f"{label} frame")
        check(res["launches"]["tri"] == 5 * 8
              and res["launches"]["texture"] == 8,
              f"{label}: launches {res['launches']}")
        res["frame_ms"] = statistics.median(times)
        res["frame_ms_all"] = times
        log(f"{label} frame {fw}x{fh} while walking (replays): median "
            f"{res['frame_ms']:.3f} ms {[round(t, 3) for t in times]}; "
            f"launches over 8 frames {res['launches']}")
        if not lantern:
            # the character's cost without the drift between phases: in
            # turns with the same settings and pose without a character
            # (the character stands, packed before each frame)
            from rtvb_tpu_torch.render.renderer import Engine
            bare = Engine(settings=gameplay_settings(fw, fh), device="cuda")
            bare.set_camera(**GAMEPLAY_POSE)
            for _ in range(2):
                bare.render_realtime_device()
            turns = interleaved({"character": eng, "no character": bare},
                                n_pairs=8)
            del bare
            res["in_turns_ms"] = turns
            wins = sum(a > b for a, b in zip(turns["character"],
                                             turns["no character"]))
            log(f"frame {fw}x{fh} in turns, with the character: median "
                f"{statistics.median(turns['character']):.3f} ms, without: "
                f"{statistics.median(turns['no character']):.3f} ms; slower "
                f"with it in {wins} of 8 turns")
        log(f"whole frame ({label}), kernels on the card vs plain versions "
            f"on the CPU:")
        res["vs_cpu"] = whole_frame_vs_cpu(
            gameplay_settings(*VS_CPU),
            setup=lantern_and_character if lantern else character_in_view)
        out[label] = res
        if not lantern:
            keep = (eng, ch)
        del eng, ch
    eng, ch = keep
    out["edits"] = edits_keeping_shapes(eng, ch, 20)
    e = out["edits"]
    log(f"20 edits that keep the shapes: recaptures {e['recaptures']}; "
        f"edit_ms median {e['edit_ms']['median']:.3f} (range "
        f"{e['edit_ms']['min']:.3f} - {e['edit_ms']['max']:.3f}): host "
        f"rebuild {e['host_ms']['median']:.3f}, upload "
        f"{e['upload_ms']['median']:.3f}, frame {e['frame_ms']['median']:.3f}")
    out["growing edit"] = growing_edit(eng)
    g = out["growing edit"]
    log(f"a growing edit (500 bricks, exception list {g['exceptions']}): "
        f"recaptures {g['recaptures']}, set_blocks through its frame "
        f"{g['edit_ms']:.3f} ms (capture {g['capture']['capture_ms']:.3f})")
    out["memory"] = memory_cycles(eng, ch)
    return out


# ---------------------------------------------------------------------------
# The frame as a CUDA graph: the batch, the one-frame replay, their costs
# ---------------------------------------------------------------------------

GRAPH_BATCH = 8               # bench.py's BATCH


def states_equal(a, b, label):
    """The two engines' feedback states and frame index, bit for bit."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    pairs = [("restir", a.restir_state.data, b.restir_state.data),
             ("exposure", a.post_state.exposure, b.post_state.exposure)]
    pairs += [(f"denoiser.{f}", x, y) for f, x, y in zip(
        a.denoiser_state._fields, a.denoiser_state, b.denoiser_state)]
    for name, x, y in pairs:
        check(torch.equal(bits(x), bits(y)), f"{label}: {name} differs")
    check(a.frame_index == b.frame_index,
          f"{label}: frame index {a.frame_index} against {b.frame_index}")


def frames_equal(a, b, label):
    import torch
    check(a.shape == b.shape and torch.equal(a, b),
          f"{label}: the u8 frames differ "
          f"({int((a != b).sum()) if a.shape == b.shape else a.shape})")


def graph_batch_vs_eager(settings, nb: int = GRAPH_BATCH,
                         n_batches: int = 2) -> dict:
    """render_realtime_device_batch(nb) of one engine against nb eager
    frames of a copy of its states (the history-camera rule: the camera is
    moved first), bit for bit, frames and states; n_batches batches, each
    from the states the last left.  The engine's first batch runs eagerly
    and captures the graph; the compared batches are replays."""
    import torch
    from rtvb_tpu_torch.render.renderer import Engine
    eng = Engine(settings=settings, device="cuda")
    eng.render_realtime_device()
    eng.render_realtime_device_batch(nb)         # eager, then the capture
    check(len(eng.graph_log) == 2, f"captures {eng.graph_log}")
    out = {}
    for i in range(n_batches):
        pos, yaw, _ = eng.camera_pose()
        eng.set_camera(pos=(pos[0] + 0.25, pos[1], pos[2] - 0.1),
                       yaw=yaw + 0.02)
        ref = copy.copy(eng)
        got = eng.render_realtime_device_batch(nb)
        want = torch.stack([ref._eager_frame() for _ in range(nb)])
        sync()
        check(tuple(got.shape) == (nb, eng.out_height, eng.out_width, 3),
              f"batch shape {tuple(got.shape)}")
        frames_equal(got, want, f"batch {i + 1} of {nb}")
        states_equal(eng, ref, f"batch {i + 1} of {nb}")
        check(eng._light_remap is eng._identity_remap(), "remap after batch")
        check(all(torch.equal(x, y) for x, y in zip(eng.history_camera,
                                                     eng.camera)),
              "the history camera after a batch is not the camera")
        out[f"batch {i + 1}"] = "bit-exact"
    check(len(eng.graph_log) == 2, "a batch replay captured anew")
    return dict(out, internal=(eng.width, eng.height), graph_log=eng.graph_log)


def graph_flythrough_vs_eager(settings, n: int = 10,
                              n_after: int = 3) -> dict:
    """One-frame replays against eager frames of a copy, bit for bit,
    along n frames of the flythrough path; then a set_block on both (an
    edit that keeps every table's shape: written in place, the graph
    replays on) and n_after more frames."""
    from rtvb_tpu_torch.assets import blocks as B
    from rtvb_tpu_torch.render.renderer import Engine
    from rtvb_tpu_torch.utils.flypath import apply_flythrough
    eng = Engine(settings=settings, device="cuda")
    eng.render_realtime_device()                 # eager, then the capture
    ref = copy.copy(eng)
    p = q = (None, None)
    for i in range(n):
        p = apply_flythrough(eng, i, n, *p)
        q = apply_flythrough(ref, i, n, *q)
        frames_equal(eng.render_realtime_device(), ref._eager_frame(),
                     f"flythrough frame {i}")
        states_equal(eng, ref, f"flythrough frame {i}")
    check(len(eng.graph_log) == 1, "the flythrough captured anew")
    x, z = 20, 30
    y = int(eng.world.blocks[x, :, z].nonzero().max()) + 1
    for e in (eng, ref):
        e.set_block(x, y, z, B.BRICK)
    for i in range(n_after):
        frames_equal(eng.render_realtime_device(), ref._eager_frame(),
                     f"frame {i} after the edit")
        states_equal(eng, ref, f"frame {i} after the edit")
    check(len(eng.graph_log) == 1, f"the edit captured anew: "
          f"{len(eng.graph_log)} captures")
    return dict(frames=n, after_edit=n_after, graph_log=eng.graph_log)


def graph_widened_vs_eager(settings, n: int = 2) -> dict:
    """restir_temporal_samples 6 (K4's generic instance, its pointer table
    written by a kernel on the stream): n replays against eager frames."""
    from rtvb_tpu_torch.render.renderer import Engine
    st = settings.replace(rendering={"restir_temporal_samples": 6})
    eng = Engine(settings=st, device="cuda")
    eng.render_realtime_device()
    ref = copy.copy(eng)
    for i in range(n):
        frames_equal(eng.render_realtime_device(), ref._eager_frame(),
                     f"restir_temporal_samples 6, frame {i}")
        states_equal(eng, ref, f"restir_temporal_samples 6, frame {i}")
    return dict(frames=n, graph_log=eng.graph_log)


def graph_launch_counts(eng, K, n: int = 3) -> dict:
    """Launch counts of n eager frames and of n replays: the same; K4 3, K1
    5 and proctex 2 (1 without normal mapping) a replay."""
    K.reset_launch_counts()
    for _ in range(n):
        eng._eager_frame()
    eager = K.launch_counts()
    eng.render_realtime_device()                  # a replay, not counted
    K.reset_launch_counts()
    for _ in range(n):
        eng.render_realtime_device()
    replay = K.launch_counts()
    sync()
    log(f"launch counts of {n} frames, eager {eager}; replayed {replay}")
    check(eager == replay, f"replay counts {replay} != eager {eager}")
    n_proctex = 2 if eng.settings.rendering.normal_mapping else 1
    check(replay["shade"] == 3 * n and replay["trace"] == 5 * n
          and replay["proctex"] == n_proctex * n, f"replay counts {replay}")
    return dict(eager=eager, replay=replay)


def graph_phase(shipped, K) -> dict:
    """The frame as a CUDA graph at 1920×1080 with the shipped settings:
    the bit-exact checks (the 8-frame batch native and at the 1/2 rung,
    the one-frame replay along the flythrough and after an edit, K4's
    generic instance), launch counts under replay, memory over 20 edits
    (none captures anew); then, in turns in one engine, the eager frame,
    the one-frame replay and the batch's time a frame, capture ms, peak
    memory with and without graphs and a profile of replays."""
    import torch
    from rtvb_tpu_torch.render.renderer import Engine
    out = {}
    out["batch native"] = graph_batch_vs_eager(shipped)
    log(f"graph batch of {GRAPH_BATCH}, native: {out['batch native']}")
    half = shipped.replace(rendering={"render_scale": 0.5})
    easu0 = K.launch_counts()["easu"]
    out["batch 1/2 rung"] = graph_batch_vs_eager(half)
    check(K.launch_counts()["easu"] > easu0, "the 1/2-rung batch ran no K7")
    log(f"graph batch of {GRAPH_BATCH}, 1/2 rung: {out['batch 1/2 rung']}")
    out["flythrough"] = graph_flythrough_vs_eager(shipped)
    log(f"one-frame replays along the flythrough and after an edit (in "
        f"place): bit-exact; captures {out['flythrough']['graph_log']}")
    out["restir_temporal_samples 6"] = graph_widened_vs_eager(shipped)
    log("restir_temporal_samples 6 (K4 generic), replays: bit-exact")

    # the costs, on one engine, peak memory first without graphs
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(settings=shipped, device="cuda")
    for _ in range(2):
        eng._eager_frame()
    sync()
    peak_eager = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng.render_realtime_device()
    eng.render_realtime_device_batch(GRAPH_BATCH)
    eng.render_realtime_device()
    eng.render_realtime_device_batch(GRAPH_BATCH)
    sync()
    peak_graphs = torch.cuda.max_memory_allocated()
    captures = {("batch" if isinstance(g["key"][0], tuple) else "frame"):
                g for g in eng.graph_log}
    log(f"peak memory allocated: eager frames {peak_eager / 2 ** 20:.1f} MiB,"
        f" with the one-frame and {GRAPH_BATCH}-frame graphs "
        f"{peak_graphs / 2 ** 20:.1f} MiB; captures "
        f"{[(k, round(g['capture_ms'], 3)) for k, g in captures.items()]}")
    out["launches"] = graph_launch_counts(eng, K)

    fns = {"eager": lambda: eng._eager_frame(),
           "replay": lambda: eng.render_realtime_device(),
           f"batch {GRAPH_BATCH}": lambda: eng.render_realtime_device_batch(
               GRAPH_BATCH)}
    turns = {k: [] for k in fns}
    labels = list(fns)
    for i in range(8):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            sync()
            t0 = time.perf_counter()
            fns[label]()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            turns[label].append(ms / (GRAPH_BATCH if label.startswith(
                "batch") else 1))
    for label, ts in turns.items():
        log(f"frame {eng.out_width}x{eng.out_height} in turns, {label} (ms a"
            f" frame): median {statistics.median(ts):.3f}, range "
            f"{min(ts):.3f} - {max(ts):.3f} {[round(t, 3) for t in ts]}")
    prof_replay = profile("one-frame replays", eng.render_realtime_device,
                          eng)
    prof_eager = profile("eager frames", eng._eager_frame, eng)
    out["memory"] = memory_cycles(eng, None)
    out.update(turns_ms=turns, peak_eager_bytes=peak_eager,
               peak_graphs_bytes=peak_graphs,
               capture_ms={k: g["capture_ms"] for k, g in captures.items()},
               profile_replay=prof_replay, profile_eager=prof_eager)
    return out


# ---------------------------------------------------------------------------
# The profiling tools (rtvb_tpu_torch/tools/) on the card
# ---------------------------------------------------------------------------

TRACE_SCALES = {"1": 1.0, "1/2": 0.5}     # device_trace: main path, a rung
PROFILE_SCALES = {"1": 1.0, "2/3": 2.0 / 3.0}
TOOLS_BAR = 0.10   # eager busy against replays, ablate full against the stage
TIMING_TOOLS_FLAG = "--timing-tools"   # the timing tools' own process


def within(a: float, b: float, bar: float = TOOLS_BAR) -> bool:
    return abs(a - b) <= bar * abs(b)


def timing_tools(path: str) -> int:
    """The four timing tools on one 1080p engine with the shipped
    settings: profile_frame at scale 1 and 2/3, ablate_pt at 2/3 with
    every variant, micro_pt and micro_post; their tables printed, their
    results written to `path` as JSON.  It runs as a process of its own
    (`chip_smoke.py --timing-tools PATH`), one that has run no profiler:
    after a torch.profiler session, replays timed in the same process
    drift by up to a tenth from one second to the next, and this
    script profiles in earlier phases."""
    import torch
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    from rtvb_tpu_torch.tools import (ablate_pt, micro_post, micro_pt,
                                      profile_frame)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    fw, fh = FRAME
    eng = Engine(settings=Settings().replace(rendering={
        "render_width": fw, "render_height": fh}), device="cuda")
    out = {"profile_frame": {}}
    for label, scale in PROFILE_SCALES.items():
        res = profile_frame.profile_frame("cuda", scale, engine=eng)
        out["profile_frame"][label] = res
        profile_frame.report(res, out=log)
    out["ablate_pt"] = ablate_pt.ablate_pt("cuda", PROFILE_SCALES["2/3"],
                                           ablate_pt.VARIANTS, engine=eng)
    ablate_pt.report(out["ablate_pt"], out=log)
    out["micro_pt"] = micro_pt.micro_pt("cuda", engine=eng)
    micro_pt.report(out["micro_pt"], out=log)
    out["micro_post"] = micro_post.micro_post("cuda")
    micro_post.report(out["micro_post"], out=log)
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def tools_phase(shipped) -> dict:
    """The five tools at 1920×1080 with the shipped settings: first the
    timing tools in a process of their own (`timing_tools`: profile_frame
    at scale 1 and 2/3; ablate_pt at 2/3 with every variant, its full
    replay within 10% of profile_frame's path-trace replay; micro_pt;
    micro_post), then device_trace here at scale 1 and at the 1/2 rung
    on one engine, each hand kernel in its kernel-name group with the
    launch counters' count for the same eager frames (K1-K6 at scale 1,
    K7 too at 1/2), the port functions holding ≥ 95% of the eager device
    time and the eager frames' device busy ms within 10% of the
    replays'."""
    import subprocess
    import torch
    from rtvb_tpu_torch.render.renderer import Engine
    t0 = time.perf_counter()
    sync()
    torch.cuda.empty_cache()
    path = os.path.join(LOG_DIR, "timing_tools.json")
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          TIMING_TOOLS_FLAG, path], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        log(line)
    check(res.returncode == 0, f"the timing tools' process exited "
          f"{res.returncode}: {res.stderr[-4000:]}")
    with open(path) as f:
        out = json.load(f)
    out["timing_tools_s"] = time.perf_counter() - t0
    pt_ms = out["profile_frame"]["2/3"]["stages"]["path trace (ReSTIR)"][
        "replay_ms"]
    full_ms = out["ablate_pt"]["variants"]["full"]["replay_ms"]
    log(f"  ablate_pt full {full_ms:.3f} ms, profile_frame's path trace "
        f"{pt_ms:.3f} ms (replays at 2/3, each the mean over captures)")
    check(within(full_ms, pt_ms), f"ablate_pt full {full_ms} ms against "
          f"profile_frame's path trace {pt_ms} ms")
    eng = Engine(settings=shipped, device="cuda")
    out["device_trace"] = {}
    for label, scale in TRACE_SCALES.items():
        res = DT.device_trace("cuda", scale, engine=eng)
        out["device_trace"][label] = res
        e, r = res["eager"], res["replay"]
        n = res["frames"]
        log(f"  device_trace at scale {label}: {n} eager frames, device busy "
            f"{e['device_busy_ms_per_frame']:.3f} ms a frame "
            f"({e['kernels_per_frame']:.0f} kernels), replays "
            f"{r['device_busy_ms_per_frame']:.3f} ms "
            f"({r['kernels_per_frame']:.0f} kernels); port functions hold "
            f"{e['function_share']:.4f}, int64 ops {e['int64_share']:.4f}")
        log(f"  top port functions at scale {label}, device ms a frame:")
        for row in e["by_function"][:15]:
            log(f"    {row['ms_per_frame']:9.4f}  x{row['per_frame']:7.1f}"
                f"  {row['name']}")
        hand = {k: v["count"] for k, v in e["hand_kernels"].items()}
        log(f"  hand kernels in the kernel groups {hand}, launch counters "
            f"{res['launches']}")
        for name in KERNELS:
            check(hand[name] == res["launches"][name],
                  f"device_trace at {label}: {name} {hand[name]} kernels, "
                  f"{res['launches'][name]} launches")
            check(hand[name] > 0 or (name in RUNG_ONLY and scale == 1.0),
                  f"device_trace at {label}: no {name} kernel")
        check(e["function_share"] >= 0.95, f"device_trace at {label}: port "
              f"functions hold {e['function_share']}")
        check(within(e["device_busy_ms_per_frame"],
                     r["device_busy_ms_per_frame"]),
              f"device_trace at {label}: eager busy "
              f"{e['device_busy_ms_per_frame']} against replays' "
              f"{r['device_busy_ms_per_frame']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  the tools took {out['seconds']:.1f} s (the timing tools' "
        f"process {out['timing_tools_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# The frame as extended row bands (rtvb_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

BANDS = 4        # 1080 / 4 with the shipped denoiser: rows 270, halo 37,
#                  ext 344, the bands from rows 0, 233, 503 and 736
BAND_TURNS = 4   # pairs of the banded and the unsharded frame in turns
# The reference's own frames 2-3 deviate from the unsharded frame: each band
# reprojects its history in its own rows (the caveat of
# tests/test_torch_parallel.py).  Their bars, from the readings on the card
# (frame 2: u8 mean |Δ| 0.0276, 99.47% of pixels within 1/255, 99.81% of
# own-row slow values within JAX's tolerance; frame 3: 1.421, 87.70%
# within 3/255), with room for a change of rounding and none for a broken
# band: {frame index: (max u8 mean |Δ|, {share: least value})}.
BAND_BARS = {1: (0.1, {"u8_within_1": 0.99, "slow_within_jax_tol": 0.995}),
             2: (2.0, {"u8_within_3": 0.85})}


def bands_settings(width: int, height: int):
    """The shipped settings with full-res GI, which the bands render (their
    offsets can be odd, so half-res GI's 2x2 quads could not align)."""
    from rtvb_tpu_torch.core.config import Settings
    return Settings().replace(rendering={
        "render_width": width, "render_height": height,
        "half_res_gi": False})


def band_frames(eng):
    """The bands' three frames, (camera, history camera, frame index): two
    with the camera still, then one with it moved as
    tests/test_parallel.py moves it."""
    from rtvb_tpu_torch.core.camera import Camera, make_camera
    cam = Camera(*(t.clone() for t in eng.camera))
    moved = make_camera(
        pos=(float(cam.pos_x) + 0.05, float(cam.pos_y), float(cam.pos_z)),
        yaw=float(cam.yaw) + 0.01, pitch=float(cam.pitch),
        fov_y_degrees=eng.settings.camera_movement.fov_y_degrees,
        aspect=eng.out_width / eng.out_height, device=eng.device)
    return [(cam, cam, 0), (cam, cam, 1), (moved, cam, 2)]


def band_call(fn, eng, cam, hist, frame, states):
    """fn (Engine run's signature) on eng's tables and the given states
    (restir, dstate, post) → (u8, restir, dstate, post)."""
    import torch
    dev = eng.device
    return fn(eng._tables, eng.materials, eng.lights, eng.sky_state, cam,
              hist, torch.tensor(frame, dtype=torch.int64, device=dev),
              states[0], eng._identity_remap(), states[1], states[2],
              torch.tensor(1.0 / 60.0, dtype=torch.float32, device=dev),
              eng.entity_buffers(), eng.texture_atlas)


def bits32(t):
    import torch
    return t.contiguous().view(torch.int32) \
        if t.dtype == torch.float32 else t


def bands_vs_unsharded(k, mono, bands, eng, n, layout, label) -> dict:
    """Frame k of a banded run against the unsharded one: the u8 frames,
    the own rows of the denoiser's slow history (bits, and the share of
    pixels within JAX's rtol 1e-4 / atol 1e-5) and of every reservoir
    plane (bits; M's largest difference)."""
    import torch
    from rtvb_tpu_torch.ops.pack import unpack2
    from rtvb_tpu_torch.parallel.frame import own_rows
    H = eng.height
    (m_u8, m_r, m_d, _), (s_u8, s_r, s_d, _) = mono, bands
    own_r = own_rows(s_r.data, H, n, layout, 1)
    slow = own_rows(s_d.slow, H, n, layout, 0)
    d = (s_u8.int() - m_u8.int()).abs().max(dim=-1).values
    sM, _ = unpack2(own_r[4])
    mM, _ = unpack2(m_r.data[4])
    in_tol = ((slow - m_d.slow).abs()
              <= 1e-5 + 1e-4 * m_d.slow.abs()).all(dim=-1)
    out = dict(
        u8_max_diff=int(d.max()), u8_pixels_differing=int((d > 0).sum()),
        u8_mean_abs_diff=float((s_u8.int() - m_u8.int()).abs().float()
                               .mean()),
        u8_within_1=float((d <= 1).float().mean()),
        u8_within_3=float((d <= 3).float().mean()),
        slow_values_differing=int((bits32(slow) != bits32(m_d.slow)).sum()),
        slow_within_jax_tol=float(in_tol.float().mean()),
        restir_values_differing=int((bits32(own_r)
                                     != bits32(m_r.data)).sum()),
        M_max_diff=float((sM - mM).abs().max()),
        M_pixels_differing=int((sM != mM).sum()))
    log(f"  {label} frame {k + 1}: {out}")
    check_frame(s_u8, m_u8.shape, f"{label} frame {k + 1}")
    return out


def hold_exact(out: dict, label: str):
    """The band frame equals the unsharded one: u8, own-row slow history
    and reservoirs to the bit."""
    check(out["u8_pixels_differing"] == 0, f"{label}: u8 differs")
    check(out["slow_values_differing"] == 0, f"{label}: slow differs")
    check(out["restir_values_differing"] == 0,
          f"{label}: reservoirs differ")


def hold_jax_tolerance(out: dict, label: str):
    """JAX's bar for its banded frames (tests/test_parallel.py: every
    own-row slow value within rtol 1e-4 / atol 1e-5, M within 1e-3), and
    every u8 value within 1/255."""
    check(out["slow_within_jax_tol"] == 1.0 and out["M_max_diff"] <= 1e-3
          and out["u8_max_diff"] <= 1, f"{label}: off JAX's tolerance")


def hold_bars(out: dict, bars, label: str):
    max_mean, least = bars
    check(out["u8_mean_abs_diff"] <= max_mean
          and all(out[k] >= v for k, v in least.items()),
          f"{label}: off its bars {bars}")


@contextlib.contextmanager
def image_row_reprojection(bands):
    """A what-if, not the reference: ReSTIR's taps and the denoiser's
    history reprojection on a band, with their source rows computed as the
    unsharded frame computes them (in the image's rows, then less the
    band's first row) in place of the band's own rows.  It corrects both
    the v-motion's scale (band rows for image rows) and the rounding of a
    band-local row coordinate."""
    import torch
    from rtvb_tpu_torch.ops.denoise import passes
    from rtvb_tpu_torch.render import restir
    height = bands.height
    orig = (restir.warp_taps, passes.temporal_accumulate,
            restir.warp_nearest, passes.warp_bilinear)
    at = {"y0": 0, "mv": None}

    def keep(mu, mv):          # the v-motion as both callers mask it
        ok = (torch.abs(mu) < 1.5) & (torch.abs(mv) < 1.5)
        at["mv"] = torch.where(ok, mv, 0.0)

    def image_sy(sy):
        y0 = at["y0"]
        rows = torch.arange(height, device=sy.device)[y0:y0 + sy.shape[0]]
        v = 1.0 - (rows + 0.5)[:, None] / height
        return (((1.0 - (v + at["mv"])) * height - 0.5) - y0).contiguous()

    def taps(prev, mu, mv, *rest):
        keep(mu, mv)
        return orig[0](prev, mu, mv, *rest)

    def accumulate(illum, moments, mu, mv, *rest):
        keep(mu, mv)
        return orig[1](illum, moments, mu, mv, *rest)

    def nearest(h, sy, sx):
        return orig[2](h, image_sy(sy), sx)

    def bilinear(h, sy, sx, pair_channels=0):
        return orig[3](h, image_sy(sy), sx, pair_channels)

    def band(rank, *a):
        at["y0"] = bands.offset(rank)
        return type(bands).band(bands, rank, *a)
    (restir.warp_taps, passes.temporal_accumulate, restir.warp_nearest,
     passes.warp_bilinear) = taps, accumulate, nearest, bilinear
    bands.band = band
    try:
        yield
    finally:
        (restir.warp_taps, passes.temporal_accumulate, restir.warp_nearest,
         passes.warp_bilinear) = orig
        del bands.band


def band_kernel_cases(bands, shade, warps, atrous, rep: Report) -> dict:
    """K4 (every call: three bounces at each band's y0), K5 (nearest and
    bilinear) and K6 (four steps) on a banded frame's own calls, as
    capture_shade_calls and capture_frame_calls record them (band after
    band), each bit-exact against its plain version; the band at row 233
    (and K4 bounce 0 at every offset) also timed into the report."""
    import torch
    from rtvb_tpu_torch.ops import warp_kernel
    from rtvb_tpu_torch.ops.denoise import atrous_kernel, passes
    from rtvb_tpu_torch.render import ris_kernel as RK
    n = bands.n
    check(len(shade) == n * 3, f"{len(shade)} K4 calls in a banded frame")
    y0s = sorted({a[2] for a, _ in shade})
    check(y0s == [bands.offset(r) for r in range(n)],
          f"K4's y0 over the bands: {y0s}")
    out = {"shade_y0": y0s}
    for i, (a, kw) in enumerate(shade):
        h, w = a[8][0].shape
        check(h == bands.ext, f"K4 on {h} rows, not the band's {bands.ext}")
        label = f"band y0 {a[2]}, bounce {i % 3}, {w}x{h}"
        if i % 3 == 0:
            rep.case("shade", label,
                     lambda a=a, k=kw: RK.fused_shade_cuda(*a, **k),
                     lambda a=a, k=kw: RK.fused_shade_plain(*a, **k),
                     bit_exact_shade, shade_work(a, kw), n=5)
        else:
            bit_exact_shade(RK.fused_shade_cuda(*a, **kw),
                            RK.fused_shade_plain(*a, **kw))
    log(f"    K4 bit-exact on all {len(shade)} band calls, y0 {y0s}")
    timed = 1                  # the band from row 233

    def warp_bits(a, b):
        check(bool((a[1] == b[1]).all()), "warp valid mask differs")
        check(torch.equal(bits32(a[0]), bits32(b[0])), "warp words differ")
        return 0.0, 0.0
    check(len(warps) == 2 * n, f"{len(warps)} K5 calls in a banded frame")
    for i, (bil, hist, sy, sx) in enumerate(warps):
        h, w = sy.shape
        check(h == bands.ext, f"K5 on {h} rows")
        kern = (lambda a=(hist, sy, sx, bil): warp_kernel._warp_cuda(
            *a[:3], a[3], 6 if a[3] else 0))
        plain = (lambda a=(hist, sy, sx): warp_kernel.warp_bilinear_ref(
            *a, 6)) if bil else (lambda a=(hist, sy, sx):
                                 warp_kernel.warp_nearest_ref(*a))
        if i // 2 == timed:
            work = (h * w * (8 + 7 * 4 + 13 * 4 + 1), 8 * 13 * h * w) \
                if bil else (h * w * (8 + 8 * 4 + 8 * 4 + 1), 4 * h * w)
            rep.case("warp", f"band y0 {bands.offset(timed)}, "
                     f"{'bilinear' if bil else 'nearest'}, {w}x{h}", kern,
                     plain, warp_bits, work)
        else:
            warp_bits(kern(), plain())
    log(f"    K5 bit-exact on all {len(warps)} band calls")

    def atrous_bits(a, b):
        for x, y in zip(a, b):
            check(torch.equal(bits32(x), bits32(y)), "atrous differs")
        return 0.0, 0.0
    steps = len(atrous) // n
    check(steps * n == len(atrous) and steps > 0,
          f"{len(atrous)} K6 calls over {n} bands")
    for i, args in enumerate(atrous):
        h, w = args[2].shape
        check(h == bands.ext, f"K6 on {h} rows")
        kern = (lambda a=args: atrous_kernel._atrous_cuda(*a[:5], *a[5]))
        plain = (lambda a=args: passes.atrous_pass_plain(*a[:5], *a[5]))
        if i // steps == timed:
            rep.case("atrous", f"band y0 {bands.offset(timed)}, step "
                     f"{args[4]}, {w}x{h}", kern, plain, atrous_bits,
                     (h * w * (32 + 16), ATROUS_PIXEL_OPS * h * w))
        else:
            atrous_bits(kern(), plain())
    log(f"    K6 bit-exact on all {len(atrous)} band calls")
    out.update(n_calls=dict(shade=len(shade), warp=len(warps),
                            atrous=len(atrous)))
    return out


def world_of_one(eng, frames, mono_outs) -> dict:
    """A real NCCL process group of world size 1 (a file store in a temp
    directory) running sharded_frame_fn through its all-gather: each frame
    equal to the unsharded one bit for bit, states included."""
    import torch
    import torch.distributed as dist
    from rtvb_tpu_torch.parallel.frame import (initial_sharded_state,
                                               sharded_frame_fn)
    from rtvb_tpu_torch.parallel.mesh import init_group
    from rtvb_tpu_torch.render.postprocess import initial_post_state
    check(dist.is_available() and dist.is_nccl_available(),
          "torch.distributed has no nccl")
    with tempfile.TemporaryDirectory() as td:
        group = init_group("nccl", 1, 0, os.path.join(td, "store"))
        try:
            step, layout = sharded_frame_fn(eng, group)
            check(layout == (eng.height, eng.height, 0),
                  f"world size 1 layout {layout}")
            states = initial_sharded_state(eng, 1, group) + (
                initial_post_state(eng.device),)
            for k, ((cam, hist, fi), mono) in enumerate(zip(frames,
                                                            mono_outs)):
                out = band_call(step, eng, cam, hist, fi, states)
                states = out[1:]
                frames_equal(out[0], mono[0], f"nccl frame {k + 1}")
                for name, x, y in ([("restir", out[1].data, mono[1].data)]
                                   + list(zip(mono[2]._fields, out[2],
                                              mono[2]))):
                    check(torch.equal(bits32(x), bits32(y)),
                          f"nccl frame {k + 1}: {name} differs")
            sync()
            check(dist.get_backend(group) == "nccl",
                  f"the group's backend {dist.get_backend(group)}")
        finally:
            dist.destroy_process_group()
    log(f"  a nccl group of one rank: {len(frames)} frames equal to the "
        f"unsharded ones bit for bit")
    return dict(backend="nccl", frames=len(frames))


def dryrun_on_card() -> dict:
    """The port's dry run entry, dryrun_multichip(1, "cuda"): one NCCL
    rank in a process of its own renders its 64×64 frames; its frame and
    states equal LocalBands' on this card to the bit."""
    import torch
    from rtvb_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                dryrun_settings, run_frames)
    from rtvb_tpu_torch.parallel.frame import (initial_sharded_state,
                                               sharded_frame_fn)
    from rtvb_tpu_torch.render.renderer import Engine
    t0 = time.perf_counter()
    got = dryrun_multichip(1, "cuda", timeout_s=180.0)
    ms = (time.perf_counter() - t0) * 1e3
    eng = Engine(settings=dryrun_settings(), device="cuda")
    step, layout = sharded_frame_fn(eng, n_devices=1)
    restir, dstate = initial_sharded_state(eng, 1)
    u8, restir, dstate = run_frames(eng, step, restir, dstate)
    check(got.layout == layout, f"dry run layout {got.layout}")
    check(torch.equal(got.u8, u8.cpu()), "dry run u8 differs")
    check(torch.equal(bits32(got.restir), bits32(restir.data.cpu())),
          "dry run reservoirs differ")
    for a, b in zip(got.dstate, dstate):
        check(torch.equal(bits32(a), bits32(b.cpu())),
              "dry run denoiser state differs")
    log(f"  dryrun_multichip(1, 'cuda'): {tuple(got.u8.shape)} u8 and its "
        f"states equal LocalBands' bit for bit, {ms:.1f} ms with the "
        f"rank's start")
    return dict(ms=ms, layout=got.layout)


def bands_phase(K, rep: Report) -> dict:
    """The frame as 4 extended row bands at 1920×1080 (the shipped
    settings with full-res GI), emulated on the one card with LocalBands:
    three frames against the unsharded frame of the same engine (and the
    same frames with the reprojection in image rows, a what-if), the band
    path's launch counts, K4 / K5 / K6 on the bands' own calls, a real
    NCCL group of world size 1, the dry run entry on the card, the band
    steps' ms, the banded and unsharded frames in turns, peak memory."""
    import torch
    from rtvb_tpu_torch.parallel.frame import (initial_sharded_state,
                                               sharded_frame_fn)
    from rtvb_tpu_torch.render import restir as restir_mod
    from rtvb_tpu_torch.render.denoiser import initial_denoiser_state
    from rtvb_tpu_torch.render.postprocess import initial_post_state
    from rtvb_tpu_torch.render.renderer import Engine
    fw, fh = FRAME
    eng = Engine(settings=bands_settings(fw, fh), device="cuda")
    dev = eng.device
    mono = eng._build_run()
    step, layout = sharded_frame_fn(eng, n_devices=BANDS)
    bands = step.bands
    y0s = [bands.offset(r) for r in range(BANDS)]
    log(f"  {BANDS} bands: rows {layout[0]}, ext {layout[1]}, halo "
        f"{layout[2]}, from rows {y0s}")
    frames = band_frames(eng)
    m_states = (restir_mod.initial_state(fh, fw, device=dev),
                initial_denoiser_state(fh, fw, device=dev),
                initial_post_state(dev))
    mono_outs = []
    for cam, hist, fi in frames:
        o = band_call(mono, eng, cam, hist, fi, m_states)
        m_states = o[1:]
        mono_outs.append(o)
    sync()

    # the band path: its counts reset right before and read right after
    s_states = initial_sharded_state(eng, BANDS) + (initial_post_state(dev),)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    band_outs = []
    for cam, hist, fi in frames:
        o = band_call(step, eng, cam, hist, fi, s_states)
        s_states = o[1:]
        band_outs.append(o)
    sync()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launch counts over {len(frames)} banded frames: {counts}")
    for name in KERNELS:
        if name in RUNG_ONLY:
            check(counts.get(name, 0) == 0, f"the bands launched {name}")
        else:
            check(counts.get(name, 0) > 0, f"the bands never launched {name}")
    n_shade = BANDS * len(frames) * eng.settings.rendering.total_bounce_limit
    check(counts["shade"] == n_shade,
          f"K4 launched {counts['shade']} times, not {n_shade}")
    compare = [bands_vs_unsharded(k, m, s, eng, BANDS, layout, "4 bands")
               for k, (m, s) in enumerate(zip(mono_outs, band_outs))]
    hold_exact(compare[0], "4 bands frame 1")
    check(compare[1]["restir_values_differing"] == 0,
          "4 bands frame 2: reservoirs differ")
    for k, bars in BAND_BARS.items():
        hold_bars(compare[k], bars, f"4 bands frame {k + 1}")
    # what frames 2-3 owe to the reprojection in the band's rows: the same
    # frames with it in the image's rows, frame 2 to the bit (as read on
    # the card) and frame 3 within JAX's tolerances and 1/255
    w_states = initial_sharded_state(eng, BANDS) + (initial_post_state(dev),)
    what_if = []
    with image_row_reprojection(bands):
        for k, (cam, hist, fi) in enumerate(frames):
            w_out = band_call(step, eng, cam, hist, fi, w_states)
            w_states = w_out[1:]
            what_if.append(bands_vs_unsharded(
                k, mono_outs[k], w_out, eng, BANDS, layout,
                "4 bands, reprojection in image rows (what-if)"))
    hold_exact(what_if[0], "what-if frame 1")
    hold_exact(what_if[1], "what-if frame 2")
    hold_jax_tolerance(what_if[2], "what-if frame 3")
    del w_states, w_out

    # K4 at the four offsets, K5 and K6 at the band's height, on the calls
    # of a banded frame (the second frame's inputs: live reservoirs)
    s1 = (restir_mod.ReSTIRState(data=band_outs[0][1].data.clone()),
          type(band_outs[0][2])(*(t.clone() for t in band_outs[0][2])),
          initial_post_state(dev))

    def second_frame():
        band_call(step, eng, *frames[1], s1)
    shade = capture_shade_calls(eng, second_frame)
    _, atrous, _, warps = capture_frame_calls(eng, second_frame)
    kernels = band_kernel_cases(bands, shade, warps, atrous, rep)
    del shade, atrous, warps, s1
    # K5 nearest at the band's height against its library yardstick
    kernels["warp_vs_grid_sample"] = warp_vs_grid_sample(bands.ext, fw, dev)

    # each band step's ms (host clock around work that ends in a sync),
    # then the banded frame against the unsharded one in turns
    card = card_line()
    cam, hist, fi = frames[1]
    idx = torch.tensor(fi, dtype=torch.int64, device=dev)
    remap, ent = eng._identity_remap(), eng.entity_buffers()
    st = initial_sharded_state(eng, BANDS)
    step_ms = {}
    for r in range(BANDS):
        sl = slice(r * bands.ext, (r + 1) * bands.ext)
        pr = restir_mod.ReSTIRState(data=st[0].data[:, sl].contiguous())
        ds = type(st[1])(*(t[sl] for t in st[1][:-1]), st[1].bootstrapped)
        ts = []
        for _ in range(4):
            sync()
            t0 = time.perf_counter()
            bands.band(r, eng._tables, eng.materials, eng.lights,
                       eng.sky_state, cam, hist, idx, pr, remap, ds, ent,
                       eng.texture_atlas)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        step_ms[y0s[r]] = statistics.median(ts[1:])
    log(f"  band step ms (median of 3 after 1) by first row, on {card}: "
        f"{step_ms}")
    fns = {"bands": lambda: band_call(step, eng, cam, hist, fi, s_states),
           "unsharded": lambda: band_call(mono, eng, cam, hist, fi,
                                          m_states)}
    turns = {k: [] for k in fns}
    labels = list(fns)
    for i in range(2 * BAND_TURNS):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            sync()
            t0 = time.perf_counter()
            fns[label]()
            sync()
            turns[label].append((time.perf_counter() - t0) * 1e3)
    for label, ts in turns.items():
        log(f"  frame {fw}x{fh} full-res GI in turns, {label}, on {card}: "
            f"median {statistics.median(ts):.3f} ms "
            f"{[round(t, 3) for t in ts]}")
    log(f"  peak memory allocated over the banded frames "
        f"{peak / 2 ** 20:.1f} MiB")

    group = world_of_one(eng, frames, mono_outs)
    dry = dryrun_on_card()
    return dict(card=card, layout=layout, y0=y0s, launches=counts,
                frames=compare, image_row_reprojection=what_if,
                kernels=kernels, step_ms=step_ms, turns_ms=turns,
                peak_bytes=peak, world_of_one=group, dryrun=dry)


# ---------------------------------------------------------------------------
# The interactive app: a scripted keyboard session through its own loop
# ---------------------------------------------------------------------------

SESSION_GAIN_FIELD = "tone_mapping.gain"   # the one setting edited live
SESSION_REACH = 5.0      # the player descends until the ground is this close
SESSION_SETTLE = 12      # frames at one scale before the character walks
SESSION_SETTLE_CAP = 80  # ... or this many frames of waiting
SESSION_WALK = 20        # frames the character walks
SESSION_PANEL_PX = 256   # columns the dev panel may cover (ui/overlay.py)


class ScriptedKeys:
    """The keys a player types, one line a frame, written into a pipe that
    the app's own StdinInputSource reads (select on the descriptor, one
    line a frame, so no line waits in the stream's buffer).  `steps(app,
    keys)` is a generator of lines: between lines it may look at the
    engine's host copies, as a player looks at the screen.  Records the
    frame each marked key was sent at and, at each frame's input, the
    engine's number of captures so far."""

    def __init__(self, app, steps):
        from rtvb_tpu_torch.apps.interactive import StdinInputSource
        r, w = os.pipe()
        self._rf, self._wf = os.fdopen(r, "r"), os.fdopen(w, "w")
        self.src = StdinInputSource(stream=self._rf)
        self.app = app
        self.steps = steps
        self.lines: list[str] = []
        self.marks: dict = {}
        self.captures_before: list[int] = []
        self._gen = None

    def mark(self, label):
        """The key about to be sent is `label`'s (its frame recorded)."""
        self.marks[label] = len(self.lines)

    def __call__(self, frame):
        if self._gen is None:
            self._gen = self.steps(self.app, self)
        self.captures_before.append(len(self.app.engine.graph_log))
        line = next(self._gen, "quit")
        self.lines.append(line)
        self._wf.write(line + "\n")
        self._wf.flush()
        return self.src(frame)

    def close(self):
        self._wf.close()
        self._rf.close()


def height_above_ground(eng) -> float:
    """The camera's height over the top of the column under it, from the
    engine's host copies."""
    (x, y, z), _, _ = eng.camera_pose()
    col = eng.host_world.blocks[int(np.clip(x, 0, eng.cfg.x - 1)), :,
                                int(np.clip(z, 0, eng.cfg.z - 1))]
    solid = np.nonzero(col)[0]
    return y - (float(solid.max()) + 1.0 if solid.size else 0.0)


def session_steps(app, keys):
    """The session: boot into MainMenu, NEW GAME → CREATE; the dev panel,
    the cursor down to tone_mapping.gain and `+` (one live setting: the
    next frame captures, the one after it is compared with an eager frame
    of a copy); look down and descend until the ground is in reach, dig
    (`x`), select the lantern (12) and place it (`b`) on the face under the
    dug block; wait until dynamic resolution holds one rung (a capture's
    long frame would step the falling character through the ground); `c`
    (the first-person camera: the character starts to fall), `c` again
    (the follow camera) and the character walks with `w`, the view raised
    again; F5; quit."""
    eng = app.engine
    names = [n for n, _ in app.settings.value_list()]
    keys.mark("menu")
    yield ""                                   # the MainMenu
    yield "enter"                              # NEW GAME
    yield "enter"                              # CREATE → Gameplay
    keys.mark("dev panel")
    yield "F3"
    for _ in range(names.index(SESSION_GAIN_FIELD)):
        yield "n"
    keys.mark("edit")
    yield "+"
    eng.compare_armed = True                   # the first replay after it
    yield " ".join(["k"] * 46)                 # look straight down
    while height_above_ground(eng) > SESSION_REACH:
        yield "q"
    keys.mark("dig")
    yield "x"
    yield ""
    keys.mark("lantern")
    yield "12 b"
    start = len(app.frame_scales)
    while (len(app.frame_scales) - start < SESSION_SETTLE_CAP
           and (len(app.frame_scales) < start + SESSION_SETTLE
                or len(set(app.frame_scales[-SESSION_SETTLE:])) > 1)):
        yield ""
    keys.mark("first person")
    yield "c"                                  # the camera at the eye
    keys.mark("walk")
    yield "c"                                  # the follow camera
    yield " ".join(["w"] + ["i"] * 40)         # walk, looking up again
    for _ in range(SESSION_WALK - 1):
        yield "w"
    keys.mark("save")
    yield "F5"
    yield "quit"


def session_engine_class(K):
    """The port's Engine, recording what the session checks: the scales
    the app applies, the picks and edits with their frame, and the first
    replay after `compare_armed` is set held against an eager frame of a
    copy made just before it, bit for bit in frames and states (that eager
    frame's launches kept apart from the session's)."""
    from rtvb_tpu_torch.render.renderer import Engine

    class SessionEngine(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.scale_calls: list[float] = []
            self.edits: list = []
            self.picks: list = []
            self.compare_armed = False
            self.compared_at = None
            self.twin_launches: dict = {}

        def set_render_scale(self, scale):
            self.scale_calls.append(scale)
            return super().set_render_scale(scale)

        def pick_block(self, *a, **kw):
            got = super().pick_block(*a, **kw)
            self.picks.append((self.frame_index, got))
            return got

        def set_blocks(self, xyz, ids):
            self.edits.append((self.frame_index,
                               np.asarray(xyz).reshape(-1, 3).tolist(),
                               np.asarray(ids).reshape(-1).tolist()))
            return super().set_blocks(xyz, ids)

        def render_realtime_device(self, dt=1.0 / 60.0):
            if not self.compare_armed:
                return super().render_realtime_device(dt)
            twin = copy.copy(self)
            n = len(self.graph_log)
            out = super().render_realtime_device(dt)
            if len(self.graph_log) == n:          # a replay
                before = K.launch_counts()
                want = twin._eager_frame(dt)
                after = K.launch_counts()
                self.twin_launches = {k: after[k] - before.get(k, 0)
                                      for k in after}
                frames_equal(out, want, "the frame after the dev-panel edit")
                states_equal(self, twin, "the frame after the dev-panel "
                             "edit")
                self.compared_at = self.frame_index - 1
                self.compare_armed = False
            return out

    return SessionEngine


class SessionPresenter:
    """Takes each frame the app presents: its shape, type and device
    checked on the spot, the mean and spread of its scene (right of the
    dev panel) reduced on the card (read once after the session); keeps
    the menu's first frame, the dev panel's (the frame before the edit),
    the lantern's (two frames after it) and the last."""

    def __init__(self):
        self.keys = None
        self.stats = []
        self.kept = {}
        self.shapes = set()

    def present(self, frame, index):
        import torch
        self.shapes.add((tuple(frame.shape), frame.dtype, frame.device.type))
        # the scene right of the dev panel (its 240 px and margins)
        f = frame[:, SESSION_PANEL_PX:].float()
        self.stats.append((index, torch.stack([f.mean(), f.std()])))
        marks = self.keys.marks
        if index == 1:              # frame 0's overlay is drawn after it
            self.kept["menu"] = frame
        elif index == marks.get("edit", -9) - 1:
            self.kept["dev panel"] = frame
        elif index == marks.get("lantern", -9) + 2:
            self.kept["lantern"] = frame
        elif "walk" in marks and index > marks["walk"]:
            self.kept["walk"] = frame


def interactive_session(K, width: int, height: int, worlds_dir: str,
                        png_dir: str | None = None) -> dict:
    """InteractiveApp on the card at width×height with the app's settings
    (shipped + block_highlight, dynamic resolution on), driven through
    its own StdinInputSource by `session_steps`; returns what it measured
    and raises where a check fails: the captures equal the rule's (the
    first frame, the first frame at each rung, the dev-panel edit, the
    placed lantern; the dig, ordinary frames, the walk and the overlay
    redraws capture nothing), K7's launches equal the frames below scale
    1, the scales equal a fresh controller's on the recorded times, every
    presented frame is (height, width, 3) u8 on the card and not blank,
    the saved world loads back to the engine's host grid bit for bit, and
    the first replay after the dev-panel edit equals an eager frame of a
    copy of the engine bit for bit."""
    import threading
    import torch
    from rtvb_tpu_torch.apps import interactive as app_mod
    from rtvb_tpu_torch.assets import blocks as B
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.core.scene import SceneConfig
    from rtvb_tpu_torch.world.persistence import WorldStore
    settings = Settings().replace(rendering={
        "render_width": width, "render_height": height,
        "block_highlight": True})
    rs = settings.rendering
    check(rs.dynamic_resolution, "the app's settings run dynamic resolution")
    store = WorldStore(worlds_dir)
    pres = SessionPresenter()
    app = app_mod.InteractiveApp(settings=settings, scene=SceneConfig(),
                                 presenter=pres, store=store,
                                 auto_start=False, device="cuda")
    keys = ScriptedKeys(app, session_steps)
    pres.keys = keys
    saved_engine = app_mod.Engine
    app_mod.Engine = session_engine_class(K)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        perf = app.run(keys)
    finally:
        app_mod.Engine = saved_engine
        keys.close()
    sync()
    session_s = time.perf_counter() - t0
    counts = K.launch_counts()
    eng = app.engine
    check(not any(t.name == "rtvb-light-variant-warmup"
                  for t in threading.enumerate()),
          "the light-variant warm-up outlived the session")
    n = len(app.frame_scales)
    marks = keys.marks
    log(f"interactive session {width}x{height}: {n} frames in "
        f"{session_s:.1f} s; keys at frames {marks}")

    # the frames
    check(pres.shapes == {((height, width, 3), torch.uint8, "cuda")},
          f"presented frames {pres.shapes}")
    idx = [i for i, _ in pres.stats]
    check(sorted(idx) == list(range(n)), f"presented frames {idx} of {n}")
    # every frame's scene is not blank, but the first-person frame's: the
    # camera at the character's eye sits inside its own mesh (the JAX
    # package's camera and soup; ROADMAP Queue 3)
    stats = torch.stack([s for _, s in pres.stats]).cpu().numpy()
    spread = {i: float(stats[k, 1]) for k, (i, _) in enumerate(pres.stats)}
    blank = [i for i, v in spread.items()
             if not v > 1.0 and i != marks["first person"]]
    check(bool(np.isfinite(stats).all()) and not blank,
          f"blank presented frames {blank}")

    # the captures against the rule
    captures_before = keys.captures_before + [len(eng.graph_log)]
    per_frame = [captures_before[f + 1] - captures_before[f]
                 for f in range(n)]
    captured = [f for f in range(n) if per_frame[f]]
    check(max(per_frame) == 1, f"captures a frame {per_frame}")
    sizes = [eng._internal_size(s) for s in app.frame_scales]
    rungs = [f for f in range(1, n) if sizes[f] != sizes[f - 1]]
    lit = int(eng._host_lights()["count"]) > 0
    predicted = sorted({0, marks["edit"], marks["lantern"], *rungs})
    check(lit, "the session's lantern lit no light")
    check(captured == predicted,
          f"captures at frames {captured}, the rule predicts {predicted}")
    capture_log = [dict(frame=f, key=list(g["key"]),
                        capture_ms=g["capture_ms"])
                   for f, g in zip(captured, eng.graph_log)]
    for c in capture_log:
        log(f"  capture at frame {c['frame']}: key {c['key']}, capture "
            f"{c['capture_ms']:.3f} ms")

    # the edits: the dig, then the lantern in the dug cell
    (dig_frame, dig), (lantern_frame, lantern) = eng.picks[0], eng.picks[1]
    check(dig[0] and lantern[0], f"the session's picks {eng.picks}")
    cell = tuple(int(v + d) for v, d in zip(lantern[1], lantern[2]))
    check(tuple(dig[1]) == cell
          and int(eng.host_world.blocks[cell]) == B.LANTERN,
          f"the dig {dig} and the lantern {lantern}: the cell holds "
          f"{int(eng.host_world.blocks[cell])}")
    log(f"  dig at frame {marks['dig']}: {dig}; lantern at frame "
        f"{marks['lantern']}: {lantern}; edits {eng.edits}")

    # dynamic resolution: K7 once a frame below scale 1; the scales a
    # fresh controller returns on the same times
    twin = eng.twin_launches
    easu = counts.get("easu", 0) - twin.get("easu", 0)
    below = sum(s < 1.0 for s in app.frame_scales)
    check(easu == below, f"session: easu launched {easu} times in {below} "
          f"frames below scale 1")
    fresh = app_mod.DynamicResolution(rs.target_fps, rs.min_render_scale,
                                      start_scale=1.0)
    replay = [fresh.update(t) for t in app.completed_ms]
    check(replay == eng.scale_calls, "session: the scales differ from a "
          "fresh controller's on the recorded times")
    changes = [(f, app.frame_scales[f]) for f in [0] + rungs]
    check(eng.compared_at is not None, "no replay after the dev-panel edit "
          "was compared with an eager frame")
    check(abs(app.settings.tone_mapping.gain - 1.25) < 1e-9,
          f"the dev-panel edit: gain {app.settings.tone_mapping.gain}")
    log(f"  the frame after the dev-panel edit (frame {eng.compared_at}, a "
        f"replay) equals an eager frame of a copy, bit for bit")

    # the save: F5 and the autosave; loaded back to the host grid
    check(store.list_worlds() == ["default"], f"worlds {store.list_worlds()}")
    cfg, world, cam, _ = store.load("default", eng._nonsolid_ids(),
                                    device="cuda")
    host = eng._host_tables()
    for f in ("blocks", "schema", "colmask", "exc_mask", "df_super",
              "maxh_super"):
        check(np.array_equal(getattr(world, f).cpu().numpy(), host[f]),
              f"the loaded world's {f} differs from the engine's host copy")
    check(torch.equal(world.blocks, eng.world.blocks),
          "the loaded grid differs from the engine's device grid")

    # times: completed frames (what the controller is fed), and those at
    # the settled rung that neither captured nor followed a capture
    done = app.completed_ms
    settled = app.frame_scales[-1]
    steady = [t for i, t in enumerate(done)
              if i + 3 < n and app.frame_scales[i + 3] == settled
              and not per_frame[i + 3] and not per_frame[i + 2]]
    row = perf.summary_row(f"interactive {width}x{height}")
    log(f"  PerformanceTracker: {row}")
    log(f"  completed-frame ms over {len(done)} frames: median "
        f"{statistics.median(done):.3f}, min {min(done):.3f}, max "
        f"{max(done):.3f}; at the settled rung {settled:.4f} without a "
        f"capture ({len(steady)} frames): median "
        f"{statistics.median(steady) if steady else float('nan'):.3f}, "
        f"range {min(steady, default=float('nan')):.3f} - "
        f"{max(steady, default=float('nan')):.3f}")
    log(f"  scales: {changes}; launches over the session {counts}, of "
        f"which the compared eager frame's {twin}")
    if png_dir is not None:
        from rtvb_tpu_torch.utils.image import write_png
        os.makedirs(png_dir, exist_ok=True)
        for label, frame in pres.kept.items():
            write_png(os.path.join(png_dir, f"session_{label.replace(' ', '_')}"
                                   ".png"), frame)
        log(f"  frames written to {png_dir}: {sorted(pres.kept)}")
    st = perf.stats()
    return dict(frames=n, seconds=session_s, marks=marks,
                captures=capture_log, predicted=predicted,
                completed_ms=done, steady_ms=steady, scales=changes,
                frame_scales=app.frame_scales, launches=counts,
                twin_launches=twin, summary_row=row,
                stage_ms={k: list(v) for k, v in st.items()},
                compared_at=eng.compared_at, picks=eng.picks,
                edits=eng.edits, camera_saved=cam)


# ---------------------------------------------------------------------------
# The offline app against the blessed goldens
# ---------------------------------------------------------------------------

CANONICAL = os.path.join(REPO, "data", "canonical")
# each golden as the JAX package's tests and tools/bless_goldens.py render
# it: (name, how, size, frames, flag)
GOLDENS = [
    ("canonical_render.png", "accumulated", 128, 8, None),
    ("canonical_512.png", "offline", 512, 64, None),
    ("scripted/sequence_final.png", "offline", 96, 12, "--test-sequence"),
    ("scripted/remove20_final.png", "offline", 96, 44, "--test-remove20"),
    ("scripted/remove_circle_final.png", "offline", 96, 44,
     "--test-remove-circle"),
    ("scripted/flythrough_f16.png", "flythrough", 96, 17, None),
]
PASSING = ("identical", "veryClose", "close")
# The goldens the JAX package itself misses on the CPU: (RMSE, SSIM) of
# its render against the golden, from `python tests/torch_goldens.py`
# (this checkout's rtvb_tpu, the JAX tests' configuration).  Such a golden
# cannot tell a right render from a wrong one; what checks the card there is
# its CPU twin below.  The card's render is also held to the reference's
# own miss, RMSE at most the reference's + 10% + 0.5 and SSIM at least the
# reference's - 0.02 (two renders of one case differ by RMSE 2-4 from each
# other, 1-spp noise, yet lie within 0.15 of each other from a golden),
# which catches only a render far off.  The 1-spp flythrough frame is
# reported, not required.
REFERENCE_MISSES = {
    "canonical_render.png": (29.357578083869946, 0.6470618225312109),
    "canonical_512.png": (23.55552145017798, 0.745426293481131),
    "scripted/sequence_final.png": (33.462013989124046, 0.6478062728867148),
    "scripted/remove20_final.png": (35.06230348776383, 0.6427830176821754),
    "scripted/remove_circle_final.png": (39.03876269512398,
                                         0.8318271504623924),
}
# Each accumulated golden's CPU twin: the frames the port renders of the
# same run on the CPU, whose last frame must be "close" or better to the
# card's frame of that index.  The 512² run is cut to its first 4 frames
# (16 times a 128² frame's work on the CPU), held against the card's saved
# frame_0004.png of its 64-frame run.
CPU_TWIN = {"canonical_render.png": 8, "canonical_512.png": 4,
            "scripted/sequence_final.png": 12,
            "scripted/remove20_final.png": 44,
            "scripted/remove_circle_final.png": 44}


def render_golden(how: str, size: int, frames: int, flag, device,
                  out_dir: str, golden_path: str):
    """One golden's render on `device` → (u8 image, offline.main's exit
    code, or None where the Engine renders it directly)."""
    from rtvb_tpu_torch.apps import offline
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    from rtvb_tpu_torch.utils.flypath import apply_flythrough
    from rtvb_tpu_torch.utils.image import read_png, to_u8
    if how == "offline":
        argv = ["--width", str(size), "--height", str(size), "--frames",
                str(frames), "--out-dir", out_dir, "--device", device,
                "--canonical", golden_path, "--test-canonical"]
        rc = offline.main(argv + ([flag] if flag else []))
        return read_png(os.path.join(out_dir, f"frame_{frames:04d}.png")), rc
    eng = Engine(settings=Settings(), width=size, height=size, device=device)
    if how == "accumulated":
        for _ in range(frames):
            out = eng.render_accumulated()
        return to_u8(out), None
    pos0 = yaw0 = None                        # the flythrough's frame
    for i in range(frames):
        pos0, yaw0 = apply_flythrough(eng, i, 24, pos0, yaw0)
        out = eng.render_realtime()
    return out, None


def offline_phase(K, out_root: str) -> dict:
    """The port's offline path on the card against data/canonical: each
    golden at its own size and frame count, its verdict with RMSE, SSIM
    and diff share; offline.main's exit code (run with --test-canonical)
    agrees with its verdict.  A golden the reference itself passes must be
    "close" or better; one it misses is held to the reference's miss, and
    each accumulated golden's card frame to its CPU twin at "close"."""
    from rtvb_tpu_torch.utils import image_diff, native
    from rtvb_tpu_torch.utils.image import read_png
    log(f"  PNG encoder: {'native (build/native/)' if native.available() else 'PIL'}")
    results = {}
    for name, how, size, frames, flag in GOLDENS:
        golden_path = os.path.join(CANONICAL, name)
        golden = read_png(golden_path)
        tag = os.path.basename(name)[:-4]
        t0 = time.perf_counter()
        card_dir = os.path.join(out_root, f"{tag}_cuda")
        img, rc = render_golden(how, size, frames, flag, "cuda", card_dir,
                                golden_path)
        seconds = time.perf_counter() - t0
        check(img.shape == golden.shape and img.std() > 1.0,
              f"{name} on the card: {img.shape}, spread {img.std()}")
        res = image_diff.compare(img, golden)
        if rc is not None:
            check(rc == (0 if res.verdict in PASSING else 1),
                  f"{name}: offline.main exit {rc} for {res.verdict}")
        row = dict(size=size, frames=frames, verdict=res.verdict,
                   rmse=res.rmse, ssim=res.ssim,
                   diff_fraction=res.diff_pixel_fraction, rc=rc,
                   seconds=seconds)
        log(f"  {name} ({size}², {frames} frames) on the card: {res}; "
            f"exit {rc}; {seconds:.1f} s")
        twin_frames = CPU_TWIN.get(name)
        if twin_frames is not None:
            t0 = time.perf_counter()
            cpu, _ = render_golden(how, size, twin_frames, flag, "cpu",
                                   os.path.join(out_root, f"{tag}_cpu"),
                                   golden_path)
            cpu_seconds = time.perf_counter() - t0
            card = img if twin_frames == frames else read_png(
                os.path.join(card_dir, f"frame_{twin_frames:04d}.png"))
            twin = image_diff.compare(card, cpu)
            row.update(card_vs_cpu=dict(frames=twin_frames,
                                        verdict=twin.verdict, rmse=twin.rmse,
                                        ssim=twin.ssim,
                                        diff_fraction=twin.diff_pixel_fraction),
                       cpu_seconds=cpu_seconds)
            if twin_frames == frames:
                cpu_res = image_diff.compare(cpu, golden)
                row["cpu_vs_golden"] = dict(verdict=cpu_res.verdict,
                                            rmse=cpu_res.rmse,
                                            ssim=cpu_res.ssim)
                log(f"    the port on the CPU: {cpu_res}")
            log(f"    the card's frame {twin_frames} against the CPU's: "
                f"{twin}; {cpu_seconds:.1f} s on the CPU")
            check(twin.verdict in PASSING,
                  f"{name}: the card's frame {twin_frames} against the CPU "
                  f"{twin}")
        ref = REFERENCE_MISSES.get(name)
        if how == "flythrough":
            row["required"] = "reported"
        elif ref is None:
            row["required"] = "close or better"
            check(res.verdict in PASSING, f"{name}: {res}")
        else:
            row["required"] = "close to the CPU twin; the reference's miss"
            row["reference"] = dict(rmse=ref[0], ssim=ref[1])
            check(res.rmse <= ref[0] * 1.1 + 0.5 and res.ssim >= ref[1] - 0.02,
                  f"{name}: {res} misses further than the reference "
                  f"(RMSE {ref[0]}, SSIM {ref[1]})")
        results[name] = row
    return results


def accumulated_ms(sizes=(512, 720), n_warm: int = 2,
                   n_pairs: int = 8) -> dict:
    """render_accumulated on the card at each size², the sizes in turns
    (the order reversed every other turn): ms a frame.  It returns host
    values, so each call is complete on return."""
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    engines = {size: Engine(settings=Settings(), width=size, height=size,
                            device="cuda") for size in sizes}
    for eng in engines.values():
        for _ in range(n_warm):
            eng.render_accumulated()
    times = {size: [] for size in sizes}
    for i in range(n_pairs):
        for size in (sizes if i % 2 == 0 else sizes[::-1]):
            t0 = time.perf_counter()
            engines[size].render_accumulated()
            times[size].append((time.perf_counter() - t0) * 1e3)
    return {size: dict(median_ms=statistics.median(t), ms=t)
            for size, t in times.items()}


def ptxas_report(build_log: str) -> list:
    """Registers, static shared memory, stack frame and spills of each
    kernel entry in nvcc's -Xptxas -v output: [{kernel, registers, smem,
    stack_frame, spill_stores, spill_loads}]."""
    import re
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.append(dict(kernel=name, stack_frame=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3))))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(sm.group(1)) if sm else 0
            name = None
    return [r for r in out if "registers" in r]


# an H100 SM's limits, as the CUDA occupancy calculator counts them
# (compute capability 9.0): registers are given to a warp in units of 256,
# shared memory to a block with 1 KB reserved
SM_REGISTERS, SM_WARPS, SM_BLOCKS = 65536, 64, 32
SM_SHARED, BLOCK_RESERVED, REG_UNIT = 233472, 1024, 256


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Blocks of `threads` threads that one SM holds at once."""
    warps = -(-threads // 32)
    warp_regs = -(-registers * 32 // REG_UNIT) * REG_UNIT
    return min(SM_BLOCKS, SM_WARPS // warps,
               SM_REGISTERS // (warp_regs * warps),
               SM_SHARED // (smem + BLOCK_RESERVED))


# K4's staging (csrc/shade_kernel.cu TILE): a 128-pixel tile of every
# input plane in shared memory
SHADE_TILE = 128


def shade_planes(n_taps: int, blue_noise: bool) -> int:
    """Input planes of a K4 launch: 15 surface planes, the depth and 9 a
    tap when it has taps, 4 blue-noise words."""
    return 15 + (1 + 9 * n_taps if n_taps else 0) + 4 * blue_noise


def resident_blocks(eng, ptxas: list) -> dict:
    """Blocks of K1, K2, K4 and K6 an SM holds at once at the frame's
    settings (the grid K1 and K2 launch is this times the SM count): each
    instance's ptxas registers and static shared memory, plus the dynamic
    shared memory its launch asks for (K1: the column masks and the two
    128-slot supercolumn tables; K2: the flower soup and its rows' bound
    terms, 64 B a triangle, and 40 B a box of 4; K6: nine planes of a
    12-row window, 32 + 4·step
    columns wide; K4: a 128-pixel tile of its input planes), under the
    SM's limits.  K4's generic instance at case (e)'s counts."""
    import re
    out = {}
    tp = eng._tp
    n_tri = eng.entity_buffers().tri_packed.shape[0]
    for r in ptxas:
        if re.search(r"tri_kernel", r["kernel"]):
            out["tri"] = blocks_per_sm(r["registers"], 256, r["smem"]
                                       + 64 * n_tri + 40 * -(-n_tri // 4))
        m = re.search(r"shade_kernelILi(n?\d+)ELi(n?\d+)ELb([01])E",
                      r["kernel"])
        if m:
            nl, nt = (int(g.replace("n", "-")) for g in m.group(1, 2))
            bn = m.group(3) == "1"
            nt_case, nl_case = (2, 5) if nt < 0 else (nt, nl)
            staged = 4 * SHADE_TILE * shade_planes(nt_case, bn)
            out[f"shade n_local={nl_case} n_taps={nt_case} blue_noise={bn}"
                + (" (generic)" if nt < 0 else "")] = blocks_per_sm(
                    r["registers"], SHADE_TILE, r["smem"] + staged)
        m = re.search(r"trace_kernelILb([01])E", r["kernel"])
        if m:
            staged = 4 * (tp.x * tp.z + 2 * 128)
            out[f"trace any_hit={m.group(1) == '1'}"] = blocks_per_sm(
                r["registers"], 256, r["smem"] + staged)
        # the shipped phi_normal's instances: 2^6, at a fixed step or not
        m = re.search(r"atrous_kernelILi6ELi(\d+)E", r["kernel"])
        if m:
            for step in ([int(m.group(1))] if m.group(1) != "0"
                         else [16, 32]):
                window = 4 * 9 * 12 * (32 + 4 * step)
                out[f"atrous step {step}"] = blocks_per_sm(
                    r["registers"], 256, r["smem"] + window)
    return dict(sorted(out.items()))


def warp_vs_grid_sample(H: int, W: int, dev, rounds: int = 7,
                        runs: int = 20) -> dict:
    """K5 nearest against torch's grid_sample on the same 8 planes of H×W
    and coordinates, in turns: `rounds` rounds of `runs` calls each, the
    order reversed every round; the ratio K5 / grid_sample per round."""
    import torch
    from rtvb_tpu_torch.ops import warp_kernel
    gen = torch.Generator(device="cpu").manual_seed(11)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    sy = (yy + 3.3 + 0.8 * torch.sin(xx / 97.0)).contiguous()
    sx = (xx - 7.6 + 0.8 * torch.cos(yy / 61.0)).contiguous()
    hist8 = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, H, W), generator=gen,
                          dtype=torch.int32).to(dev).view(torch.float32)
    grid = torch.stack([(sx + 0.5) / W * 2.0 - 1.0,
                        (sy + 0.5) / H * 2.0 - 1.0], dim=-1)[None]
    t = timed_rounds({
        "k5": lambda: warp_kernel._warp_cuda(hist8, sy, sx, False, 0),
        "grid_sample": lambda: torch.nn.functional.grid_sample(
            hist8[None], grid, mode="nearest", padding_mode="border",
            align_corners=False)}, rounds, runs)
    ratios = [a / b for a, b in zip(t["k5"], t["grid_sample"])]
    slower = sum(r > 1.0 for r in ratios)
    log(f"K5 nearest at {W}x{H} / grid_sample over {rounds} rounds of "
        f"{runs}: median "
        f"{statistics.median(ratios):.4f}, range {min(ratios):.4f} - "
        f"{max(ratios):.4f}; K5 slower in {slower} of {rounds} rounds; ms "
        f"K5 {[round(x, 4) for x in t['k5']]}, grid_sample "
        f"{[round(x, 4) for x in t['grid_sample']]}")
    return dict(shape=[H, W], ms=t, ratios=ratios,
                median_ratio=statistics.median(ratios),
                k5_ms=statistics.median(t["k5"]),
                grid_sample_ms=statistics.median(t["grid_sample"]),
                k5_slower_rounds=slower)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from rtvb_tpu_torch import kernels as K
    os.makedirs(LOG_DIR, exist_ok=True)
    t_start = time.perf_counter()
    phase_s = {}

    def phase(label):
        """Seconds since the start at which `label` begins (logged)."""
        phase_s[label] = time.perf_counter() - t_start
        log(f"[{phase_s[label]:.1f} s] {label}")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    K.LIBRARY.get()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {K.LIBRARY.build_seconds:.1f} s)")
    with open(os.path.join(LOG_DIR, "nvcc_ptxas.log"), "w") as f:
        f.write(K.LIBRARY.build_log or "")

    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine, slice_settings
    fw, fh = FRAME
    shipped = Settings().replace(rendering={"render_width": fw,
                                            "render_height": fh})
    t0 = time.perf_counter()
    eng = Engine(settings=shipped, device="cuda")
    log(f"engine init {fw}x{fh}: {time.perf_counter() - t0:.1f} s, "
        f"textures {len(eng.texture_atlas_names)}, lights {eng.lights.count}")
    rs = eng.settings.rendering
    check(rs.fused_shading and rs.render_scale == 1.0,
          "the main path must run the shipped defaults")

    phase("kernel cases")
    ptxas = ptxas_report(K.LIBRARY.build_log or "")
    for r in ptxas:
        log(f"ptxas {r['kernel']}: {r['registers']} registers, "
            f"{r['stack_frame']} B stack frame, {r['spill_stores']} B spill "
            f"stores, {r['spill_loads']} B spill loads")
    occupancy = resident_blocks(eng, ptxas)
    log(f"resident blocks an SM (registers and shared memory against the "
        f"SM's limits): {occupancy}")
    log("kernels against their plain versions (CUDA events, median of 10):")
    rep = Report()
    traces, atrous, tris, _ = capture_frame_calls(eng)
    substeps = kernel_cases(eng, rep, traces, atrous, tris)
    del traces, atrous, tris
    k5_rounds = warp_vs_grid_sample(eng.height, eng.width, eng.device)
    shade_diffs = shade_kernel_cases(eng, rep)
    # K7 on the tone-mapped frame each rung hands to EASU, and on a mixed
    # per-axis ratio: the 2/3 rung of 320×180 renders 214×120
    easu_kernel_cases(easu_inputs(eng), rep)
    # the texture stack's kernel on the path tracer's own bounce-0 inputs
    # in the benchmark's window, natively and at the 1/2 rung
    proctex_shares = proctex_kernel_cases(shipped, rep)

    # the main path: counts are reset right before and read right after
    phase("main path")
    n_warm, n_timed = 2, 8
    K.reset_launch_counts()
    frame_ms, times, out, enq_ms = frame_run(eng, n_warm, n_timed)
    counts = K.launch_counts()
    log(f"frame {fw}x{fh} (shipped settings, 1 spp, denoised, u8): median "
        f"{frame_ms:.3f} ms over {len(times)} frames "
        f"{[round(t, 3) for t in times]}; host enqueue median "
        f"{enq_ms:.3f} ms")
    log(f"launch counts over the main-path run: {counts}")
    for name in KERNELS:
        if name in RUNG_ONLY:
            check(counts.get(name, 0) == 0,
                  f"kernel {name} launched at render_scale 1")
        else:
            check(counts.get(name, 0) > 0, f"kernel {name} never launched")
    n_frames = n_warm + n_timed
    check(counts["shade"] == rs.total_bounce_limit * n_frames,
          f"shade launched {counts['shade']} times in {n_frames} frames")
    n_proctex = (2 if rs.normal_mapping else 1) * n_frames
    check(counts["proctex"] == n_proctex,
          f"proctex launched {counts['proctex']} times, not {n_proctex}")
    check_frame(out, (fh, fw, 3), "main path")
    u8 = out.cpu().numpy()
    log(f"frame u8: shape {u8.shape}, mean {u8.mean():.2f}, std "
        f"{u8.std():.2f}")

    phase("widened settings")
    widened = widened_frames(shipped, K)

    phase("in-line frame")
    # the in-line configuration (fused shading off), for the record: the
    # host's speed drifts within a call, so the two engines render in turns
    # (fused, in-line, in-line, fused, ...) and each keeps its own median
    inline = Engine(settings=slice_settings(fw, fh), device="cuda")
    K.reset_launch_counts()
    for _ in range(n_warm):
        inline.render_realtime_device()
    sync()
    inline_counts = K.launch_counts()
    log(f"launch counts over {n_warm} in-line frames: {inline_counts}")
    for name in KERNELS:
        if name == "shade" or name in RUNG_ONLY:
            check(inline_counts.get(name, 0) == 0,
                  f"the in-line frame launched kernel {name}")
        else:
            check(inline_counts.get(name, 0) > 0,
                  f"kernel {name} never launched in the in-line frame")
    ab = interleaved({"fused": eng, "inline": inline}, n_pairs=8)
    inline_ms = statistics.median(ab["inline"])
    for label, ts in ab.items():
        log(f"frame {fw}x{fh} in turns, {label}: median "
            f"{statistics.median(ts):.3f} ms {[round(t, 3) for t in ts]}")
    wins = sum(a < b for a, b in zip(ab["fused"], ab["inline"]))
    log(f"fused faster than in-line in {wins} of {len(ab['fused'])} turns")

    phase("profiles")
    prof = profile(f"shipped settings {fw}x{fh}", eng._eager_frame, eng)
    prof_inline = profile(f"in-line shading {fw}x{fh}", inline._eager_frame,
                          inline)
    del inline

    phase("card vs CPU")
    whole = {}
    for label, st in (("shipped", Settings().replace(rendering={
            "render_width": VS_CPU[0], "render_height": VS_CPU[1]})),
            ("inline", slice_settings(*VS_CPU))):
        log(f"whole frame ({label}), kernels on the card vs plain versions "
            f"on the CPU:")
        shade0 = K.launch_counts()["shade"]
        whole[label] = whole_frame_vs_cpu(st)
        check((K.launch_counts()["shade"] > shade0)
              == st.rendering.fused_shading,
              f"{label}: K4 launches do not match fused_shading")

    phase("rung frames")
    # the dynamic-resolution rungs of the 1080p frame, each with its own
    # launch counts (K7's are the ones its kernel line reports)
    rungs = rung_frames(eng, K, n_warm, n_timed)
    rung_launches = {name: sum(r["launches"][name] for r in rungs.values())
                     for name in KERNELS}
    phase("rungs in turns")
    # for the record: the rungs and the native frame in turns (one engine
    # each, sharing the world and asset tables, which no frame writes),
    # and a profile at the 1/2 rung
    eng.set_render_scale(1.0)
    by_rung = {"1": eng}
    for label, scale in RUNGS.items():
        by_rung[label] = copy.copy(eng)
        by_rung[label].set_render_scale(scale)
    for e in by_rung.values():
        for _ in range(n_warm):
            e.render_realtime_device()
    rung_turns = interleaved(by_rung, n_pairs=4)
    for label, ts in rung_turns.items():
        log(f"frame {fw}x{fh} in turns, scale {label}: median "
            f"{statistics.median(ts):.3f} ms {[round(t, 3) for t in ts]}")
    prof_half = profile(f"1/2 rung {fw}x{fh}", by_rung["1/2"]._eager_frame,
                        by_rung["1/2"])
    del by_rung
    phase("DynamicResolution walk")
    walk = dynres_walk(eng, K)
    eng.set_render_scale(1.0)
    phase("card vs CPU at the 2/3 rung")
    log("whole frame (2/3 rung), kernels on the card vs plain versions on "
        "the CPU:")
    easu0 = K.launch_counts()["easu"]
    whole["rung 2/3"] = whole_frame_vs_cpu(Settings().replace(rendering={
        "render_width": RUNG_VS_CPU[0], "render_height": RUNG_VS_CPU[1],
        "render_scale": RUNGS["2/3"]}))
    check(K.launch_counts()["easu"] > easu0, "the 2/3-rung frame vs the "
          "CPU did not launch K7")

    phase("gameplay")
    # the interactive app's path: its own launch counts, reset just before
    # its frames and read just after (inside gameplay())
    play = gameplay(eng, K, rep)
    log(f"gameplay at {fw}x{fh} on {card}: lit frame median "
        f"{play['frame_ms']:.3f} ms; edit latency {play['edit_ms']:.3f} ms; "
        f"pick_block {play['pick_ms']:.3f} ms")
    phase("gameplay card vs CPU")
    log("whole frame (lit, highlighted night world), kernels on the card vs "
        "plain versions on the CPU:")
    whole["gameplay"] = whole_frame_vs_cpu(gameplay_settings(*VS_CPU),
                                           setup=night_with_lantern)

    phase("entities")
    # a walking character in the captured frame, with and without the
    # lantern; edits written in place
    del eng
    entities = entities_phase(K, rep)

    phase("graph")
    # the frame as a CUDA graph: replays and batches against eager frames,
    # bit for bit, then their costs in turns
    graph = graph_phase(shipped, K)

    phase("tools")
    # the port's profiling tools at the main path's scale and at rungs:
    # device time by kernel, op, function and stage, stages, ablations
    tools = tools_phase(shipped)

    phase("bands")
    # the frame as 4 extended row bands on the one card, a real NCCL group
    # of one and the dry run entry on the card: the band path's counts
    # reset right before its frames and read right after (inside)
    bands = bands_phase(K, rep)

    phase("interactive")
    # the interactive app's loop at 1920×1080: its own launch counts are
    # reset right before the session and read right after (inside)
    with tempfile.TemporaryDirectory() as worlds:
        session = interactive_session(K, fw, fh, worlds, png_dir=LOG_DIR)
    for name in KERNELS:
        check(session["launches"].get(name, 0) > 0,
              f"the interactive session never launched kernel {name}")

    phase("offline")
    # the offline app against the goldens; the accumulated path's launch
    # counts reset right before and read right after
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out_root:
        goldens = offline_phase(K, out_root)
    offline_counts = K.launch_counts()
    log(f"launch counts over the offline phase: {offline_counts}")
    for name in ("trace", "tri", "texture", "shade", "warp", "proctex"):
        check(offline_counts.get(name, 0) > 0,
              f"the offline phase never launched kernel {name}")
    accumulated = accumulated_ms()
    for size, acc in accumulated.items():
        log(f"accumulated frame {size}x{size} (render_accumulated, 1 spp "
            f"a frame; 512² and 720² in turns) on {card}: median "
            f"{acc['median_ms']:.3f} ms {[round(t, 3) for t in acc['ms']]}")

    # a frame's time of K1, K2, K4 and K6 from the launches the frame
    # makes: K1's and K2's five waves and K6's four steps as captured; K4
    # bounce 0 (case a) and bounces 1-2 (case f, the same instance and
    # shape for both)
    def frame_sum(label, cases):
        tot = {k: sum(c[k] for c in cases)
               for k in ("ms", "plain_ms", "bound_ms")}
        log(f"{label} a frame: {tot['ms']:.4f} ms against a bound of "
            f"{tot['bound_ms']:.4f} ms ({tot['ms'] / tot['bound_ms']:.2f}x);"
            f" plain {tot['plain_ms']:.4f} ms")
        return tot
    sa = next(c for c in rep.cases if c["case"].startswith("(a)"))
    sf = next(c for c in rep.cases if c["case"].startswith("(f)"))
    per_frame = {
        "trace": frame_sum("K1, its five waves", [
            c for c in rep.cases
            if c["kernel"] == "trace" and c["case"].startswith("frame")]),
        "tri": frame_sum("K2, its five waves", [
            c for c in rep.cases
            if c["kernel"] == "tri" and c["case"].startswith("frame")]),
        "shade": frame_sum("K4, case (a) + 2 x case (f)", [sa, sf, sf]),
        "atrous": frame_sum("K6, steps 1, 2, 4, 8", [
            c for c in rep.cases
            if c["kernel"] == "atrous" and c["case"].startswith("frame")]),
        "proctex": frame_sum("proctex, scale + normal delta at "
                             f"{PROCTEX_FRAME[0]}x{PROCTEX_FRAME[1]}", [
            c for c in rep.cases
            if c["kernel"] == "proctex" and " native " in c["case"]]),
    }
    # launches: the main path's count, or for a kernel that runs only
    # below render_scale 1, its count over the rung frames
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        cs = [c for c in rep.cases if c["kernel"] == name]
        main_case = cs[0]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=(rung_launches if name in RUNG_ONLY else counts)[name],
            max_abs_err=max(c["max_abs_err"] for c in cs),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"]))
    with open(os.path.join(LOG_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, frame=FRAME, frame_ms=frame_ms,
                       frame_ms_all=times, enqueue_ms=enq_ms,
                       in_turns_ms=ab, inline_frame_ms=inline_ms,
                       launches=counts, launches_inline=inline_counts,
                       per_frame=per_frame, cases=rep.cases,
                       trace_substeps=substeps, ptxas=ptxas,
                       resident_blocks=occupancy, warp_rounds=k5_rounds,
                       shade_diffs=shade_diffs, whole_frame=whole,
                       proctex_tex_id_shares=proctex_shares,
                       widened_frames=widened,
                       profile=prof, profile_inline=prof_inline,
                       rungs=rungs, rung_turns_ms=rung_turns,
                       profile_half_rung=prof_half, dynres_walk=walk,
                       gameplay=play, entities=entities, graph=graph,
                       tools=tools, bands=bands,
                       interactive=session, goldens=goldens,
                       offline_launches=offline_counts,
                       accumulated_ms=accumulated, phase_s=phase_s,
                       kernels=kernels), f, indent=1)
    phase("end")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == [TIMING_TOOLS_FLAG]:
            rc = timing_tools(sys.argv[2])
        else:
            rc = main()
    except Exception:       # report any failure and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
