"""Timing helpers shared by the tools and chip_smoke.py.

On the card, times come from CUDA events with a spin kernel queued ahead
of the timed window (`cuda_ms`, `timed_rounds`), so the host's launch
latency stays out of a kernel's time.  `time_piece` is the counterpart of
the JAX tools' `bench_fn`: a piece of the frame's first call, its eager
calls, its capture as a CUDA graph and its replays.  On the CPU the same
functions time with the host clock and report no capture or replay (a
graph needs a card); their numbers are never a device's.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from .. import kernels as K
from ..render import frame_graph

# cycles of the card's spin kernel queued ahead of a timed window (~1 ms
# and ~4 ms at the H100's clocks): the host enqueues the timed calls while
# the card waits, so the events time the card's work and not the host's
# launch latency
PAD_CYCLES = 2_000_000
ROUND_PAD_CYCLES = 8_000_000
# captures a piece's replay time is the mean over: one capture's replays
# agree within a fraction of a percent, but a capture of the path trace
# at 2/3 replays ≈ 10% faster than another now and then, for runs of a
# few captures in a row (NVIDIA H100 80GB HBM3, 700 W; the clock reads
# the same), so the mean takes several such runs
CAPTURES = 8


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device=None):
    """Wait for the card (device None or a CUDA device); no-op on the CPU."""
    if device is None or on_card(device):
        torch.cuda.synchronize(device)


def cuda_ms(fn, n: int = 10) -> float:
    """Median over n runs of one call, timed with CUDA events."""
    fn()
    sync()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, n: int = 10) -> float:
    """Median over n runs of one call on the host clock (CPU tensors)."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def timed_rounds(fns: dict, rounds: int = 7, runs: int = 20) -> dict:
    """Several functions timed in turns: each round runs every function
    `runs` times back to back between two CUDA events, the order reversed
    every round → {label: [ms a call, one per round]}."""
    for fn in fns.values():
        fn()
    sync()
    out = {k: [] for k in fns}
    labels = list(fns)
    for i in range(rounds):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(ROUND_PAD_CYCLES)
            start.record()
            for _ in range(runs):
                fns[label]()
            end.record()
            end.synchronize()
            out[label].append(start.elapsed_time(end) / runs)
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def interval_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def card_name(device):
    """torch's name of the card, or None on the CPU."""
    return torch.cuda.get_device_name(device) if on_card(device) else None


def fmt_ms(v, signed: bool = False) -> str:
    """A time for the tools' tables ("—" for a time not taken)."""
    if v is None:
        return "   —    "
    return f"{v:+9.3f}" if signed else f"{v:9.3f}"


def fmt_spread(t: dict) -> str:
    """A piece's replay spread over its captures, "min-max ms over n
    captures" ("" without replays)."""
    ms = t.get("replay_ms_by_capture") or []
    if not ms:
        return ""
    return f"{min(ms):.3f}-{max(ms):.3f} over {len(ms)} captures"


def write_json(res: dict, path) -> None:
    """Write a tool's result to `path` (None: nowhere)."""
    if path:
        with open(path, "w") as f:
            json.dump(res, f, indent=1)


def resolve(device) -> torch.device:
    """The tools' device: "cuda" needs a card and raises without one."""
    from ..render.renderer import resolve_device
    return resolve_device(device)


def ensure_kernels(device) -> dict:
    """Build and load the kernel library before anything is timed, so no
    first call includes it: {"load_s": this call's seconds, "nvcc_s": the
    library's build seconds in this process (0.0: the build was current,
    None: built before this call)}.  Raises when the build fails; {} on
    the CPU, where no kernel runs."""
    if not on_card(device):
        return {}
    t0 = time.perf_counter()
    K.LIBRARY.get()
    return dict(load_s=time.perf_counter() - t0,
                nvcc_s=K.LIBRARY.build_seconds)


def time_piece(body, device, keep=(), n_eager: int = 3,
               n_replay: int = 3) -> dict:
    """One piece of the frame, body() → its outputs, the counterpart of
    the JAX tools' bench_fn: first_call_ms (host clock, through the
    synchronize; the kernel build is `ensure_kernels`' and not in it),
    eager_ms (median of n_eager calls: CUDA events on the card, where an
    eager call of many ops is bound by the host's dispatch), capture_ms
    (host ms of `frame_graph.capture`, instantiation included; median
    over the captures) and replay_ms (CUDA events: the mean over CAPTURES
    captures, each released before the next, of each one's median of
    n_replay replays; each one's in replay_ms_by_capture).  keep: tensors
    the body reads, held while its graph lives.  On the CPU the times are
    the host's and capture_ms and replay_ms are None (no graph)."""
    card = on_card(device)
    t0 = time.perf_counter()
    if card:
        # the first call on a side stream, as a capture asks of its warm-up
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        sync(device)
    else:
        body()
    first_ms = (time.perf_counter() - t0) * 1e3
    if not card:
        return dict(first_call_ms=first_ms, eager_ms=host_ms(body, n_eager),
                    capture_ms=None, replay_ms=None,
                    replay_ms_by_capture=[])
    eager = cuda_ms(body, n_eager)
    capture_ms, replays = [], []
    for _ in range(CAPTURES):
        g = frame_graph.capture(body, frame_graph.tensors(keep))
        try:
            replays.append(cuda_ms(g.replay, n_replay))
        finally:
            g.release()
        capture_ms.append(g.capture_ms)
    return dict(first_call_ms=first_ms, eager_ms=eager,
                capture_ms=statistics.median(capture_ms),
                replay_ms=statistics.fmean(replays),
                replay_ms_by_capture=replays)
