"""K1 (trace), K2 (triangles), K4 (fused shade) and K6 (à-trous) against
other builds of their sources, in turns on one GPU, at chip_smoke.py's
cases (the 1080p frame's own K1 and K2 waves, K4 bounces and K6 steps,
and chip_smoke's extra rays, K4 cases and K6 steps).

    python3 kernel_ab.py --variant LABEL=DIR [--variant LABEL=DIR ...]
                         [--kernels trace,tri,shade,atrous]

Each DIR holds the csrc/ sources (the .cu files and the headers they
include) as of another commit C, written with
    git show C:rtvb_tpu_torch/csrc/<file> > DIR/<file>
and with this checkout's C interfaces of rtvb_trace, rtvb_shade and
rtvb_atrous.  K2's is taken from either rtvb_tri_box (this checkout's) or
rtvb_tri, the earlier one (an int32 hit and a cap plane, which its wrapper
filled with BIG where the caller passed none and turned into a bool with
`hit != 0`; both ops are timed with it, as the wrapper ran them).  Each
DIR is built with the package's nvcc flags into a temporary directory,
and its entry points take the place of this checkout's for its turns.
For every case the builds run in turns (`chip_smoke.timed_rounds`: rounds
of 20 calls each, the order reversed every round) after their outputs are
held against this checkout's bit for bit (but for the sign of a zero).
The medians go to stdout and, with every round, to kernel_ab.json in
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


def legacy_tri(handle, o, d, tri, t_cap):
    """K2 through the earlier C interface rtvb_tri, as its wrapper called
    it: a BIG cap plane where the caller passes none, an int32 hit turned
    into a bool."""
    import torch
    from rtvb_tpu_torch.ops import triangles
    shape, dev = o[0].shape, o[0].device
    if t_cap is None:
        t_cap = torch.full(shape, triangles.BIG, dtype=torch.float32,
                           device=dev)
    hit = torch.empty(shape, dtype=torch.int32, device=dev)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    u = torch.empty(shape, dtype=torch.float32, device=dev)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    handle.launch(dev, *o, *d, t_cap, tri, o[0].numel(), tri.shape[0],
                  hit, t, idx, u, v)
    return triangles.TriHit(hit=hit != 0, t=t, tri=idx, u=u, v=v)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="LABEL=DIR")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--kernels", default="trace,tri,shade,atrous",
                    help="comma-separated subset of trace,tri,shade,atrous")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from rtvb_tpu_torch import kernels as K
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.ops import dda, triangles
    from rtvb_tpu_torch.ops.denoise import atrous_kernel
    from rtvb_tpu_torch.render import ris_kernel as RK
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
        traces, atrous, tris = S.capture_frame_calls(eng)
        tables, tp = eng._tables, eng._tp
        old_tri = K.CudaKernel("tri", "rtvb_tri", triangles.TRI.argtypes[:-1])

        def on(label, handle, run):
            """`run` on the build `label` ("current": this checkout)."""
            if label == "current":
                return run

            def run_other():
                with using(handle, builds[label]):
                    return run()
            return run_other

        def on_tri(label, a):
            """K2's case `a` on the build `label`, through the C interface
            that build exports."""
            run = lambda: triangles.intersect_packed_cuda(*a)
            if label == "current" or hasattr(builds[label].get(),
                                             triangles.TRI.symbol):
                return on(label, triangles.TRI, run)
            return on(label, old_tri, lambda: legacy_tri(old_tri, *a))

        cases = []
        if "trace" in kernels:
            cases += [("trace", k, lambda label, a=v: on(
                label, dda.TRACE, lambda: dda.trace_cuda(
                    a[0], a[1], tables, tp, a[2], a[3])))
                for k, v in S.trace_inputs(eng, traces).items()]
        if "tri" in kernels:
            cases += [("tri", k, lambda label, a=v: on_tri(label, a))
                      for k, v in S.tri_inputs(eng, tris).items()]
        if "shade" in kernels:
            cases += [("shade", k, lambda label, a=v: on(
                label, RK.SHADE, lambda: RK.flatten_out(
                    RK.fused_shade_cuda(*a[0], **a[1]))))
                for k, v in S.shade_cases(eng).items()]
        if "atrous" in kernels:
            cases += [("atrous", k, lambda label, a=v: on(
                label, atrous_kernel.ATROUS,
                lambda: atrous_kernel._atrous_cuda(*a[:5], *a[5])))
                for k, v in S.atrous_inputs(eng, atrous).items()]
        del traces, atrous, tris
        labels = ["current", *builds]
        results = {}
        for kernel, case, runner in cases:
            fns = {label: runner(label) for label in labels}
            ref = fns["current"]()
            for label in builds:
                same_bits(ref, fns[label](), f"{kernel} {case} {label}")
            t = S.timed_rounds(fns, args.rounds, args.runs)
            med = {k: statistics.median(v) for k, v in t.items()}
            results[f"{kernel} | {case}"] = dict(rounds=t, median_ms=med)
            S.log(f"{kernel:6s} {case:45s} " + "  ".join(
                f"{k} {v:.4f}" for k, v in med.items()) + " ms")
        # a frame: K1's and K2's five waves, K6's four steps, K4's bounce 0
        # (case a) and bounces 1-2 (case f twice)
        sums = {}
        for kernel in kernels:
            if kernel == "shade":
                frame = [r["median_ms"] for k, r in results.items()
                         if k.startswith("shade | (a)")] + 2 * [
                    r["median_ms"] for k, r in results.items()
                    if k.startswith("shade | (f)")]
            else:
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
