"""Pixel-band data parallelism on torch.distributed (port of
rtvb_tpu/parallel/mesh.py).

The image's rows are split into equal bands, one a rank; every rank traces
and shades its own band (the world tables are replicated).  The
denoiser's stencils need rows of the neighbouring bands:
`halo_exchange_rows` sends boundary rows to the neighbours, point to
point.  Auto-exposure's reduction is an all-reduce (`global_mean`).
frame.py's banded frame recomputes an overlap instead of exchanging it.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


# how long a collective may wait for the other ranks before it raises
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def init_group(backend: str, world_size: int, rank: int, init_file: str):
    """Join a process group of world_size ranks through a file store at
    init_file (a path every rank sees; no network), the counterpart of
    the JAX package's make_mesh → the default group.  An NCCL rank takes
    the card `rank % device_count` first."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="file://" + init_file, world_size=world_size,
        rank=rank, timeout=COLLECTIVE_TIMEOUT)
    return dist.group.WORLD


def halo_exchange_rows(x, halo: int, group=None):
    """x padded with `halo` rows received from the neighbouring ranks
    (edge-clamped at the image border). x: (rows_local, W[, C])."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    top = x[:halo].contiguous()     # to the previous rank's bottom halo
    bot = x[-halo:].contiguous()    # to the next rank's top halo
    from_prev = torch.empty_like(bot)
    from_next = torch.empty_like(top)
    ops = []
    if rank > 0:
        prev = dist.get_global_rank(group, rank - 1) if group is not None \
            else rank - 1
        ops += [dist.P2POp(dist.isend, top, prev, group),
                dist.P2POp(dist.irecv, from_prev, prev, group)]
    if rank < n - 1:
        nxt = dist.get_global_rank(group, rank + 1) if group is not None \
            else rank + 1
        ops += [dist.P2POp(dist.isend, bot, nxt, group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # the first and last ranks replicate their edge rows
    if rank == 0:
        from_prev = x[:1].expand_as(from_prev)
    if rank == n - 1:
        from_next = x[-1:].expand_as(from_next)
    return torch.cat([from_prev, x, from_next], dim=0)


def global_mean(x, group=None):
    """Mean over the whole (banded) image — auto-exposure's reduction."""
    s = torch.sum(x).reshape(1)
    n = torch.tensor([float(x.numel())], dtype=torch.float32,
                     device=x.device)
    dist.all_reduce(s, group=group)
    dist.all_reduce(n, group=group)
    return (s / n)[0]


def sharded_render(render_rows_fn, height: int, width: int, args,
                   group=None):
    """Run `render_rows_fn(y0, rows, *args)` on this rank's band of rows
    and gather the bands (tiled on rows) → the whole image on every rank.
    render_rows_fn returns per-band outputs with leading dim rows."""
    n = dist.get_world_size(group)
    if height % n:
        raise ValueError(f"height {height} not divisible by {n} ranks")
    rows = height // n
    band = render_rows_fn(dist.get_rank(group) * rows, rows, *args)
    if tuple(band.shape[:2]) != (rows, width):
        raise ValueError(f"a band of shape {tuple(band.shape)} for {rows} "
                         f"rows of width {width}")
    full = torch.empty((height,) + tuple(band.shape[1:]), dtype=band.dtype,
                       device=band.device)
    dist.all_gather_into_tensor(full, band.contiguous(), group=group)
    return full
