"""K1 (trace) and K6 (à-trous) against other builds of their sources, in
turns on one GPU, at chip_smoke.py's cases (the 1080p frame's own K1 waves
and K6 steps, and its extra K1 rays and K6 step).

    python3 kernel_ab.py --variant LABEL=DIR [--variant LABEL=DIR ...]

Each DIR holds trace_kernel.cu, atrous_kernel.cu and the headers they
include, as of another commit C, written with
    git show C:rtvb_tpu_torch/csrc/<file> > DIR/<file>
and with this checkout's C interfaces of rtvb_trace and rtvb_atrous.  Each
is built with the package's nvcc flags into a temporary directory, and its
entry points take the place of this checkout's for its turns.  For every
case the builds run in turns (`chip_smoke.timed_rounds`: rounds of 20
calls each, the order reversed every round) after their outputs are held
against this checkout's bit for bit (but for the sign of a zero).  The
medians go to stdout and, with every round, to kernel_ab.json in
chip_smoke's log directory; nvcc's register / spill report of each build
to kernel_ab_ptxas.log there.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import traceback

import chip_smoke as S


@contextlib.contextmanager
def using(kernel, library):
    """Run a kernel handle on another build's entry point meanwhile."""
    prev = kernel.use(library)
    try:
        yield
    finally:
        kernel.use(prev)


def same_bits(a, b, label):
    """Every output equal bit for bit, but for the sign of a zero (older
    builds of K1 wrote +0 for the normal of a ray with a zero direction
    component, where the plain version has −0)."""
    import torch
    for x, y in zip(a, b):
        if x is None:
            continue
        same = x == y
        if x.dtype == torch.float32:
            same = (x.view(torch.int32) == y.view(torch.int32)) | (
                (x == 0) & (y == 0))
        S.check(bool(same.all()), f"{label}: outputs differ")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="LABEL=DIR")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from rtvb_tpu_torch import kernels as K
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.ops import dda
    from rtvb_tpu_torch.ops.denoise import atrous_kernel
    from rtvb_tpu_torch.render.renderer import Engine

    card = S.card_line()
    S.log(card)
    os.makedirs(S.LOG_DIR, exist_ok=True)
    K.LIBRARY.get()
    logs = [f"# this checkout\n{K.LIBRARY.build_log or ''}"]
    sources = dict(v.split("=", 1) for v in args.variant)
    builds = {}                 # label → kernels.Library
    tmp = tempfile.mkdtemp(prefix="rtvb_kernel_ab_")
    try:
        for label, src in sources.items():
            lib = K.Library(os.path.abspath(src), os.path.join(tmp, label))
            lib.get()
            builds[label] = lib
            logs.append(f"# {label} ({src})\n{lib.build_log}")
        with open(os.path.join(S.LOG_DIR, "kernel_ab_ptxas.log"), "w") as f:
            f.write("\n".join(logs))

        fw, fh = S.FRAME
        eng = Engine(settings=Settings().replace(rendering={
            "render_width": fw, "render_height": fh}), device="cuda")
        eng.render_realtime_device()
        traces, atrous = S.capture_frame_calls(eng)
        tables, tp = eng._tables, eng._tp

        def on(label, handle, run):
            """`run` on the build `label` ("current": this checkout)."""
            if label == "current":
                return run

            def run_other():
                with using(handle, builds[label]):
                    return run()
            return run_other

        cases = [("trace", dda.TRACE, k,
                  lambda a=v: dda.trace_cuda(a[0], a[1], tables, tp, a[2],
                                             a[3]))
                 for k, v in S.trace_inputs(eng, traces).items()]
        cases += [("atrous", atrous_kernel.ATROUS, k,
                   lambda a=v: atrous_kernel._atrous_cuda(*a[:5], *a[5]))
                  for k, v in S.atrous_inputs(eng, atrous).items()]
        labels = ["current", *builds]
        results = {}
        for kernel, handle, case, run in cases:
            fns = {label: on(label, handle, run) for label in labels}
            ref = fns["current"]()
            for label in builds:
                same_bits(ref, fns[label](), f"{kernel} {case} {label}")
            t = S.timed_rounds(fns, args.rounds, args.runs)
            med = {k: statistics.median(v) for k, v in t.items()}
            results[f"{kernel} | {case}"] = dict(rounds=t, median_ms=med)
            S.log(f"{kernel:6s} {case:45s} " + "  ".join(
                f"{k} {v:.4f}" for k, v in med.items()) + " ms")
        sums = {}
        for kernel in ("trace", "atrous"):
            frame = [r["median_ms"] for k, r in results.items()
                     if k.startswith(f"{kernel} | frame")]
            sums[kernel] = {label: sum(m[label] for m in frame)
                            for label in labels}
            S.log(f"{kernel} a frame (its frame cases): " + "  ".join(
                f"{k} {v:.4f}" for k, v in sums[kernel].items()) + " ms")
        with open(os.path.join(S.LOG_DIR, "kernel_ab.json"), "w") as f:
            json.dump(dict(card=card, sources=sources, rounds=args.rounds,
                           runs=args.runs, cases=results, per_frame=sums),
                      f, indent=1)
        S.log(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:       # report any failure and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
