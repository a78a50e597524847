"""A run of one cell: `python3 benchmark/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>`, from the root of a checkout.

Set-up (counted in setup_s, from the process's start): the kernel
library (built once per checkout into build/kernels/, then loaded), the
Engine of the cell's configuration, the character, the warm-up of every
shape the cell's traffic uses.  Then the cell's settle phase (not counted
in setup_s), the window of `--seconds`, then (`--trace 1`) three eager
frames profiled for the stage split, then the output check.  The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
import types

from . import check as check_mod
from . import devtrace
from .roofline import bound_ms
from .session import Session
from .spec import Benchmark, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "rtvb_tpu")
EAGER_FRAMES = 3          # profiled after the window, for the stage split
SLICE_FRAMES = 40         # the traced slice of the window: at most these
SLICE_SECONDS = 3.0       # frames, at most these seconds
SLICE_LEAD_S = 1.0        # it starts SLICE_SECONDS + this before the end


def process_age_s() -> float | None:
    """Seconds since this process started (Linux: /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules(names=None) -> list:
    """The top-level names of JAX and the JAX package among `names` (by
    default the loaded modules), compared whole: rtvb_tpu_torch is not
    rtvb_tpu."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def card_line(n: int) -> dict:
    """The card's name, the count, each card's power limit."""
    import torch
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        power = res.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        power = ["nvidia-smi not available"]
    return dict(kind=names[0], count=n, power=power[:n])


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        vals = [_clone(v) for v in x]
        if hasattr(x, "_fields"):
            return type(x)(*vals)
        return type(x)(vals)
    return x


@contextlib.contextmanager
def hooked_calls(roles: dict):
    """Within: each hand kernel's port function (its role's HOOK) records
    its calls' arguments; yields {role: [(args, kwargs)]}."""
    calls = {name: [] for name in roles}
    saved = []
    for name, mod in roles.items():
        module = importlib.import_module(mod.HOOK[0])
        orig = getattr(module, mod.HOOK[1])

        def rec(*a, _orig=orig, _name=name, **k):
            calls[_name].append((_clone(a), _clone(k)))
            return _orig(*a, **k)
        setattr(module, mod.HOOK[1], rec)
        saved.append((module, mod.HOOK[1], orig))
    try:
        yield calls
    finally:
        for module, attr, orig in saved:
            setattr(module, attr, orig)


def traced_extras(sess, roles: dict) -> dict:
    """After the window: EAGER_FRAMES eager frames in one profile (the
    stage split; the first records the hand kernels' calls), and the
    bound of those calls a frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sess.phase = "eager"
    sess.sync()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if sess.device != "cpu" else [])
    with profile(activities=acts) as prof:
        with hooked_calls(roles) as calls:
            sess.frame(sess.clock() - sess.t0, eager=True)
        for _ in range(EAGER_FRAMES - 1):
            sess.frame(sess.clock() - sess.t0, eager=True)
        sess.sync()
    events = list(devtrace.events_from_kineto(
        prof.profiler.kineto_results.events()))
    stages = devtrace.stage_ms(events, EAGER_FRAMES)
    bounds = {}
    for name, mod in roles.items():
        b = 0.0
        for args, kwargs in calls[name]:
            b += bound_ms(*mod.work(args, kwargs))
        bounds[name] = b
    del calls
    if sess.device != "cpu":
        torch.cuda.empty_cache()
    return dict(stages=stages, bounds=bounds)


def run_cell(bench: Benchmark, cell_name: str, seed: int, seconds: float,
             trace: bool, device="cuda", window=None,
             t_start=None, settle_s=None) -> dict:
    """One run of a cell → the result (without its printing).  settle_s:
    the settle phase's seconds (None: the cell's)."""
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    limits = bench.limits(cell_name)
    roles = bench.kernel_roles() if trace else {}
    import torch
    from rtvb_tpu_torch import kernels as K
    if device != "cpu":
        K.LIBRARY.get()
    sess = Session(cfg, bench.traffic(cell["traffic"]), seed, device=device,
                   window=window)
    sess.build()
    sess.warm()
    sess.start()
    age = process_age_s()
    setup_s = age if age is not None else time.perf_counter() - t_start
    sess.settle(bench.settle_s(cell_name) if settle_s is None
                else settle_s)
    # the traced slice closes the window: the frames before it are the
    # untraced ones device.idle_share divides by
    sess.run_window(seconds, profile_slice=(
        max(0.0, seconds - SLICE_SECONDS - SLICE_LEAD_S),
        lambda n, s: n >= SLICE_FRAMES or s >= SLICE_SECONDS)
        if trace else None)
    on_card = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    replay = extras = None
    if trace:
        prof, frames = sess.profile
        events = list(devtrace.events_from_kineto(
            prof.profiler.kineto_results.events()))
        replay = devtrace.summarize_replays(events, frames, roles)
        del events, prof
        sess.profile = None
        extras = traced_extras(sess, roles)
    numbers = check_mod.check(sess)
    correct, rows = check_mod.judge(numbers, limits)
    run = types.SimpleNamespace(sess=sess, setup_s=setup_s, replay=replay,
                                extras=extras)
    metrics = {}
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    wf = sess.window_frames()
    wc = sess.window_clicks()
    result = dict(
        correct=bool(correct),
        attempted=len(wf) + len(wc),
        failed=sum(not f["ok"] for f in wf) + sum(not c["ok"] for c in wc),
        metrics=metrics,
        device=dict(platform="gpu" if on_card else "cpu",
                    kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                    count=1, memory_peak_bytes=int(peak)))
    if trace:
        result["device"]["busy_s"] = replay["busy_s"]
        result["device"]["window_s"] = replay["window_s"]
        result["breakdown"] = dict(device_ops=replay["top_ops"],
                                   idle_gaps=replay["idle_gaps"])
    result["checks"] = {name: dict(value=v, limit=lim)
                        for name, v, lim in rows}
    return result


def main(argv=None, t_start=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    t_start = t_start if t_start is not None else time.perf_counter()
    bench = Benchmark()
    cell = bench.cell(a.workload)
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
              f"for {cell['chips']}", file=sys.stderr)
        return 2
    print("card: " + json.dumps(card_line(int(cell["chips"]))), flush=True)
    result = run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
