"""The real frame over horizontal pixel bands (port of
rtvb_tpu/parallel/frame.py).

The same stage functions as `Engine._build_run` — `render_frame` with
temporal ReSTIR state, the full denoiser chain, `postprocess.run` — run on
*extended* bands: each rank renders its own rows plus `halo` rows on each
side (clamped into the image) and runs the whole denoiser on them.  The
halo covers the denoiser's stencil reach, so on the first frame a rank's
own rows equal the unsharded frame's to the bit: overlap recompute instead
of an exchange per pass (mesh.py has the exchange-based primitives).

* Temporal state (ReSTIR reservoirs, denoiser history) stays in extended
  band form, so reuse never crosses a band: a rank holds (8, ext, W)
  reservoir planes and an (ext, W) denoiser state; the one-device runner
  `LocalBands` holds the stack of all n, (n·ext) rows, the JAX package's
  sharded layout.  From the second frame on, the halo rows carry history
  filtered against the band's clamped edge, and the stencils reach it.
* The bands render full-res GI (no half_res_gi): band offsets can be odd,
  so a band's 2x2 GI quads could not align with the frame's.
* ReSTIR's taps and the denoiser's history reprojection scale a pixel's
  v-motion by the band's own rows, not the image height, as the JAX
  package's do (a reference caveat the port mirrors).
* The bands' own rows are gathered (tiled on rows) and the whole post
  chain (auto-exposure, bloom, flare: screen-global) runs on the whole
  frame, replicated on every rank.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..render import pathtracer, postprocess
from ..render import restir as restir_mod
from ..render.denoiser import (DenoiserState, denoise_frame,
                               initial_denoiser_state)


def stencil_reach(dn_cfg) -> int:
    """Total row reach of the denoiser's spatial stencils."""
    r = 2  # history clamp / compose margins
    if dn_cfg.firefly_filter:
        r += 1
    if dn_cfg.pre_pass:
        r += 2
    if dn_cfg.history_fix:
        r += 4
    # à-trous: radius-2 kernel at steps 1, 2, 4, ...
    r += sum(2 * (1 << i) for i in range(dn_cfg.atrous_iterations))
    return r


def band_layout(height: int, n_devices: int, dn_cfg):
    """(rows_per_device, ext_rows, halo) for the extended-band sharding."""
    if height % n_devices:
        raise ValueError(f"height {height} not divisible by {n_devices} "
                         f"devices")
    rows = height // n_devices
    halo = min(stencil_reach(dn_cfg), (height - rows) // 2)
    return rows, rows + 2 * halo, halo


def band_offset(rank: int, height: int, rows: int, ext: int,
                halo: int) -> int:
    """First image row of rank's extended band: its own rows less the
    halo, clamped so the band lies inside the image."""
    return min(max(rank * rows - halo, 0), height - ext)


def own_rows(stacked, height: int, n_devices: int, layout, dim: int = 0):
    """Each band's own rows of a state stacked in extended-band layout
    (n_devices · ext rows along `dim`), concatenated: the unsharded
    frame's rows."""
    rows, ext, halo = layout
    parts = []
    for rank in range(n_devices):
        start = rank * ext + rank * rows - band_offset(rank, height, rows,
                                                       ext, halo)
        parts.append(stacked.narrow(dim, start, rows))
    return torch.cat(parts, dim=dim)


def initial_sharded_state(eng, n_devices: int, group=None):
    """(restir_state, denoiser_state) in extended-band layout on eng's
    device: with a group, one rank's (ext rows); without, the stack of
    all n_devices bands (n_devices · ext rows) that `LocalBands` takes."""
    _, ext, _ = band_layout(eng.height, n_devices, eng.settings.denoising)
    if group is not None and dist.get_world_size(group) != n_devices:
        raise ValueError(f"a group of {dist.get_world_size(group)} ranks "
                         f"for {n_devices} bands")
    h = ext if group is not None else n_devices * ext
    rs = restir_mod.initial_state(h, eng.width, device=eng.device) \
        if eng.settings.rendering.use_restir else None
    return rs, initial_denoiser_state(h, eng.width, device=eng.device)


class BandStep:
    """One rank's part of the frame for Engine `eng` split into n_devices
    bands: `band(rank, ...)` path traces and denoises rank's extended band
    and crops its own rows; `finish(...)` post-processes the gathered
    frame into u8.  The engine's static configuration is bound now."""

    def __init__(self, eng, n_devices: int):
        self.n = n_devices
        self.height, self.width = eng.height, eng.width
        self.rows, self.ext, self.halo = band_layout(
            eng.height, n_devices, eng.settings.denoising)
        self.rs_cfg = dataclasses.replace(
            eng.settings.rendering, local_light_candidates=eng._n_local)
        self.dn_cfg = eng.settings.denoising
        self.pp = eng.settings.post_processing
        self.tm = eng.settings.tone_mapping
        self.cfg, self.tp = eng.cfg, eng._tp
        self.out_h, self.out_w = eng.out_height, eng.out_width
        self.consts = eng._frame_constants()

    def offset(self, rank: int) -> int:
        return band_offset(rank, self.height, self.rows, self.ext, self.halo)

    def band(self, rank, tables, mats, lights, sky_state, cam, hist_cam,
             frame_idx, prev_restir, light_remap, dstate, ent, atlas):
        """rank's band → (its own rows of the denoised linear frame
        (rows, W, 3), new ReSTIR state | None, new denoiser state), the
        states on the extended band."""
        y0e = self.offset(rank)
        use_restir = self.rs_cfg.use_restir
        g, new_restir = pathtracer.render_frame(
            self.cfg, tables, self.tp, mats, lights, sky_state, cam,
            hist_cam, frame_idx, self.width, self.height, self.rs_cfg,
            prev_restir=prev_restir if use_restir else None,
            light_remap=light_remap, entities=ent, atlas=atlas,
            y0=y0e, rows=self.ext)
        rgb_ext, new_dstate = denoise_frame(g, dstate, self.dn_cfg)
        crop = rank * self.rows - y0e
        return rgb_ext[crop:crop + self.rows], new_restir, new_dstate

    def finish(self, full, post_state, dt, overlay=None):
        """The gathered (H, W, 3) frame → (u8, new post state)."""
        out, new_pstate = postprocess.run(
            full, post_state, self.pp, self.tm, dt, self.out_h, self.out_w,
            overlay_u8=overlay, consts=self.consts)
        out_u8 = (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        return out_u8, new_pstate


class LocalBands:
    """The n bands of a frame on one device, one after the other: the band
    step for rank 0 .. n-1 in turn, their own rows concatenated (what an
    all-gather over n ranks returns), then the post chain.  The
    counterpart of the JAX package's virtual-device mesh.  Called like
    `Engine._build_run`'s run, with the states stacked (n · ext rows)."""

    def __init__(self, bands: BandStep):
        self.bands = bands

    def __call__(self, tables, mats, lights, sky_state, cam, hist_cam,
                 frame_idx, prev_restir, light_remap, dstate, post_state,
                 dt, ent, atlas=None, overlay=None):
        b = self.bands
        owns, restirs, dstates = [], [], []
        for rank in range(b.n):
            sl = slice(rank * b.ext, (rank + 1) * b.ext)
            pr = None if prev_restir is None else restir_mod.ReSTIRState(
                data=prev_restir.data[:, sl].contiguous())
            ds = DenoiserState(*(t[sl] for t in dstate[:-1]),
                               dstate.bootstrapped)
            own, nr, nd = b.band(rank, tables, mats, lights, sky_state, cam,
                                 hist_cam, frame_idx, pr, light_remap, ds,
                                 ent, atlas)
            owns.append(own)
            restirs.append(nr)
            dstates.append(nd)
        new_restir = None if restirs[0] is None else restir_mod.ReSTIRState(
            data=torch.cat([r.data for r in restirs], dim=1))
        new_dstate = DenoiserState(
            *(torch.cat(ts, dim=0) for ts in zip(*(d[:-1] for d in dstates))),
            dstates[-1].bootstrapped)
        out_u8, new_pstate = b.finish(torch.cat(owns, dim=0), post_state,
                                      dt, overlay)
        return out_u8, new_restir, new_dstate, new_pstate


def sharded_frame_fn(eng, group=None, n_devices: int | None = None):
    """The banded frame for Engine `eng` → (step, (rows, ext, halo)).

    step(tables, mats, lights, sky_state, cam, hist_cam, frame_idx,
    prev_restir, light_remap, dstate, post_state, dt, ent, atlas=None,
    overlay=None) → (u8, new_restir, new_dstate, new_post_state), the
    signature of `Engine._build_run`'s run.  With a torch.distributed
    group, this rank renders its band and the own rows are gathered over
    the group (`all_gather_into_tensor`, tiled on rows); the states are
    the rank's (initial_sharded_state(eng, n, group)).  Without one,
    `LocalBands` renders all n_devices bands on eng's device, the states
    stacked."""
    if group is None:
        if n_devices is None:
            raise ValueError("n_devices is needed without a group")
        bands = BandStep(eng, n_devices)
        return LocalBands(bands), (bands.rows, bands.ext, bands.halo)
    n = dist.get_world_size(group)
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a group of {n} ranks for {n_devices} bands")
    rank = dist.get_rank(group)
    bands = BandStep(eng, n)

    def step(tables, mats, lights, sky_state, cam, hist_cam, frame_idx,
             prev_restir, light_remap, dstate, post_state, dt, ent,
             atlas=None, overlay=None):
        own, new_restir, new_dstate = bands.band(
            rank, tables, mats, lights, sky_state, cam, hist_cam, frame_idx,
            prev_restir, light_remap, dstate, ent, atlas)
        full = torch.empty((bands.height,) + tuple(own.shape[1:]),
                           dtype=own.dtype, device=own.device)
        dist.all_gather_into_tensor(full, own.contiguous(), group=group)
        out_u8, new_pstate = bands.finish(full, post_state, dt, overlay)
        return out_u8, new_restir, new_dstate, new_pstate
    return step, (bands.rows, bands.ext, bands.halo)
