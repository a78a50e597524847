"""The banded frame across processes: n gloo ranks on the CPU, or NCCL
ranks on CUDA devices, each rendering its band of the real frame (path
trace with temporal ReSTIR, the denoiser, post) for two frames at 64×64,
its own rows gathered over the group.  The port's counterpart of the JAX
package's multi-device dry run (`__graft_entry__.dryrun_multichip`).

    python -m rtvb_tpu_torch.parallel.dryrun 2 cpu     # two gloo ranks
    python -m rtvb_tpu_torch.parallel.dryrun 1 cuda    # one NCCL rank

The ranks are started together and joined against a deadline: a rank
still alive at the deadline is killed and the call raises, so it never
waits without a limit.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZE = 64
N_FRAMES = 2


def dryrun_settings(size: int = SIZE):
    """The shipped settings at size×size with full-res GI (what the bands
    render) and two à-trous steps, so that two or more bands of 64 rows
    stay real bands (a halo of 13 rows; the shipped reach is 37)."""
    from ..core.config import Settings
    return Settings().replace(
        rendering={"render_width": size, "render_height": size,
                   "half_res_gi": False},
        denoising={"atrous_iterations": 2})


class DryRun(NamedTuple):
    u8: torch.Tensor            # the last frame, (H, W, 3) uint8
    restir: torch.Tensor        # reservoir planes, (8, n·ext, W)
    dstate: tuple               # denoiser state fields, (n·ext) rows
    layout: tuple               # (rows, ext, halo)


def run_frames(eng, step, restir, dstate, n_frames: int = N_FRAMES):
    """n_frames frames of `step` (Engine run's signature) from the given
    states, the camera still, frame indices 0 .. n_frames - 1 → (last u8,
    restir, dstate)."""
    from ..render.postprocess import initial_post_state
    dev = eng.device
    pstate = initial_post_state(dev)
    remap = torch.arange(eng._light_remap.shape[0], dtype=torch.int32,
                         device=dev)
    dt = torch.tensor(1.0 / 60.0, dtype=torch.float32, device=dev)
    cam = eng.camera
    out = None
    for frame in range(n_frames):
        idx = torch.tensor(frame, dtype=torch.int64, device=dev)
        out, restir, dstate, pstate = step(
            eng._tables, eng.materials, eng.lights, eng.sky_state, cam, cam,
            idx, restir, remap, dstate, pstate, dt, eng.entity_buffers(),
            eng.texture_atlas)
    return out, restir, dstate


def run_ranks(fn, n: int, args: tuple, timeout_s: float):
    """Run fn(rank, *args) in n spawned processes, started together and
    joined against a deadline: raises if a rank raises, and kills every
    rank still alive after timeout_s and raises TimeoutError.  fn must be
    importable by name (the processes start from a fresh import)."""
    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks of {fn.__name__} still "
                                   f"running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def _rank_main(rank: int, n: int, device: str, out_dir: str):
    """One rank: join the group, render its band of N_FRAMES frames, save
    (u8, its states) to out_dir/rank{rank}.pt."""
    from ..render.renderer import Engine
    from .frame import initial_sharded_state, sharded_frame_fn
    from .mesh import init_group
    torch.set_num_threads(1)
    backend = "gloo" if device == "cpu" else "nccl"
    group = init_group(backend, n, rank, os.path.join(out_dir, "store"))
    try:
        dev = "cpu" if device == "cpu" else torch.device(
            "cuda", torch.cuda.current_device())
        eng = Engine(settings=dryrun_settings(), device=dev)
        step, layout = sharded_frame_fn(eng, group)
        restir, dstate = initial_sharded_state(eng, n, group)
        u8, restir, dstate = run_frames(eng, step, restir, dstate)
        torch.save(dict(u8=u8.cpu(), layout=layout,
                        restir=None if restir is None else restir.data.cpu(),
                        dstate=[t.cpu() for t in dstate]),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = 300.0) -> DryRun:
    """Render N_FRAMES banded frames over n_devices ranks (gloo on the
    CPU; NCCL, one card a rank, for device "cuda") → the last u8 frame
    (every rank's, which must agree) and the ranks' states stacked in
    rank order, the layout `LocalBands` holds.  Raises if a rank fails
    or if the ranks are not done within timeout_s (they are killed)."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} NCCL ranks need as many cards, "
                         f"found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as out_dir:
        run_ranks(_rank_main, n_devices, (n_devices, device, out_dir),
                  timeout_s)
        res = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
               for r in range(n_devices)]
    for r in res[1:]:
        if not torch.equal(r["u8"], res[0]["u8"]):
            raise RuntimeError("the ranks' post-processed frames differ")
    restir = None if res[0]["restir"] is None else torch.cat(
        [r["restir"] for r in res], dim=1)
    dstate = tuple(torch.cat(ts, dim=0) if ts[0].dim() else ts[0]
                   for ts in zip(*(r["dstate"] for r in res)))
    return DryRun(res[0]["u8"], restir, dstate, res[0]["layout"])


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: python -m rtvb_tpu_torch.parallel.dryrun "
                 "N_RANKS cpu|cuda")
    n, dev = int(sys.argv[1]), sys.argv[2]
    r = dryrun_multichip(n, dev)
    rows, ext, halo = r.layout
    print(f"dryrun_multichip({n}, {dev}): ok, out {tuple(r.u8.shape)}, "
          f"bands {rows}+2x{halo} halo, mean {float(r.u8.float().mean()):.4f}")
