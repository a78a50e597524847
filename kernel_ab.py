"""K1 (trace), K2 (triangles), K3 (atlas sample), K4 (fused shade), K6
(à-trous) and K7 (EASU) against other builds of their sources, in turns on
one GPU, at chip_smoke.py's cases (the 1080p frame's own K1 and K2 waves,
K4 bounces and K6 steps, K3's primary-hit field, K7's rung frames, and
chip_smoke's extra rays, K4 cases and K6 steps).

    python3 kernel_ab.py --variant LABEL=DIR [--variant LABEL=DIR ...]
                         [--kernels trace,tri,texture,shade,atrous,easu]

Each DIR holds the csrc/ sources (the .cu files and the headers they
include) as of another commit C, written with
    git show C:rtvb_tpu_torch/csrc/<file> > DIR/<file>
Each DIR is built with the package's nvcc flags into a temporary
directory, and its entry points take the place of this checkout's for its
turns.  A build that exports this checkout's entry point of a kernel runs
through it; one that exports only an earlier one (K3's rtvb_texture,
on the planar atlas; K4's rtvb_shade_tab, with the frame index as a host
value, or rtvb_shade, with no pointer table either; K6's rtvb_atrous,
with a power-of-two phi_normal as an int) runs through that,
as its wrapper called it, on the cases it takes (not K4's counts past 4
taps or 16 candidates, not K6's phi_normal other than a power of two or
its steps past 126).  For every case the builds run in turns
(`chip_smoke.timed_rounds`: rounds of 20 calls each, the order reversed
every round) after their outputs are held against this checkout's bit for
bit (but for the sign of a zero); a build that differs fails the run, but
on K2's in-plane probe rays, where an earlier build's box cull is known to
drop hits: there the count of differing values is reported and that
build is not timed.  The medians go to stdout and, with
every round, to kernel_ab.json in chip_smoke's log directory; nvcc's
register / spill report of each build to kernel_ab_ptxas.log there.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
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


def differing(a, b) -> int:
    """The count of output values that differ in a bit, but for the sign
    of a zero (older builds of K1 wrote +0 for the normal of a ray with a
    zero direction component, where the plain version has −0)."""
    import torch
    n = 0
    for x, y in zip(a, b):
        if x is None:
            continue
        same = x == y
        if x.dtype == torch.float32:
            same = (x.view(torch.int32) == y.view(torch.int32)) | (
                (x == 0) & (y == 0))
        n += int((~same).sum())
    return n


# K2's case on which an earlier build may differ (its box cull's fault)
IN_PLANE = "in-plane probe rays"


class NotComparable(Exception):
    """The other build's entry point does not take this case."""


class Earlier:
    """An earlier C entry point standing in for a kernel handle: `convert`
    turns the handle's launch arguments into the earlier ones (or raises
    NotComparable)."""

    def __init__(self, symbol, argtypes, convert, library):
        from rtvb_tpu_torch import kernels as K
        self.kernel = K.CudaKernel(f"earlier {symbol}", symbol, argtypes)
        self.kernel.use(library)
        self.convert = convert

    def launch(self, device, *args):
        self.kernel.launch(device, *self.convert(args))


@contextlib.contextmanager
def swapped(module, attr, stand_in):
    """module.attr replaced by stand_in meanwhile."""
    prev = getattr(module, attr)
    setattr(module, attr, stand_in)
    try:
        yield
    finally:
        setattr(module, attr, prev)


# the planar atlas of each interleaved copy K3's cases read, for the
# earlier K3 entry point: {lo4's data pointer: (lo, hi)}
PLANAR = {}
# the frame index of each K4 case, read once (before the case is timed),
# for the earlier K4 entry points: {data pointer: (tensor, low 32 bits)}
FRAMES = {}


def host_frame(t) -> int:
    """The host value of a K4 case's device frame index (cached)."""
    held = FRAMES.get(t.data_ptr())
    if held is None or held[0] is not t:
        held = FRAMES[t.data_ptr()] = (t, int(t.item()) & 0xFFFFFFFF)
    return held[1]


def earlier_entry(kernel, library):
    """(symbol, argtypes, convert) of the earlier entry point of `kernel`
    (a kernels.CudaKernel name)."""
    from rtvb_tpu_torch import kernels as K
    from rtvb_tpu_torch.ops.denoise import atrous_kernel as A
    P, I, F = K.P, K.I, K.F
    if kernel == "texture":
        # (tid, u, v, lvl, lo4, hi4, H, W, t, out): the planar lo, hi for
        # the interleaved lo4, hi4
        return ("rtvb_texture", [P] * 6 + [I] * 3 + [P],
                lambda a: a[:4] + PLANAR[a[4].data_ptr()] + a[6:])
    if kernel == "shade":
        # the frame index (argument 13) as a host value, not in device
        # memory: rtvb_shade_tab; before it, rtvb_shade, with no pointer
        # table (the last argument) either
        from rtvb_tpu_torch.render import ris_kernel as RK
        tab = hasattr(library.get(), "rtvb_shade_tab")
        types = list(RK.SHADE.argtypes[:-1])       # less the stream
        types[13] = ctypes.c_uint32

        def shade(a):
            n_local, n_taps = a[15], a[16]
            if not tab and (n_taps > 4 or n_local > 16):
                raise NotComparable
            a = a[:13] + (host_frame(a[13]),) + a[14:]
            return a if tab else a[:-1]
        return (("rtvb_shade_tab", types, shade) if tab
                else ("rtvb_shade", types[:-1], shade))
    if kernel == "atrous":
        # (..., phi_lum, phi_depth, phi_normal, mode, n_sq, out, out_var)
        # → (..., phi_lum, phi_depth, 2^n_sq, out, out_var)
        def atrous(a):
            step, mode, n_sq = a[6], a[10], a[11]
            if mode != A.POW_SQUARE or step > 126:
                raise NotComparable
            return a[:9] + (1 << n_sq,) + a[12:]
        return ("rtvb_atrous", [P] * 4 + [I] * 3 + [F] * 2 + [I] + [P] * 2,
                atrous)
    return None


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="LABEL=DIR")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--kernels", default="trace,tri,texture,shade,atrous,easu",
                    help="comma-separated subset of trace,tri,texture,"
                    "shade,atrous,easu")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from rtvb_tpu_torch import kernels as K
    from rtvb_tpu_torch.assets import image_textures as it
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.ops import dda, triangles
    from rtvb_tpu_torch.ops import easu_kernel as EK
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
        traces, atrous, tris, _ = S.capture_frame_calls(eng)
        tables, tp = eng._tables, eng._tp
        # the module attribute each wrapper launches its kernel through
        handles = {"trace": (dda, "TRACE"), "tri": (triangles, "TRI"),
                   "texture": (it, "TEXTURE"), "shade": (RK, "SHADE"),
                   "atrous": (atrous_kernel, "ATROUS"), "easu": (EK, "EASU")}

        def on(label, kernel, run):
            """`run` on the build `label` ("current": this checkout),
            through the entry point of `kernel` that build exports."""
            if label == "current":
                return run
            module, attr = handles[kernel]
            handle, lib = getattr(module, attr), builds[label]
            if hasattr(lib.get(), handle.symbol):
                def run_other():
                    with using(handle, lib):
                        return run()
                return run_other
            entry = earlier_entry(kernel, lib)
            if entry is None:
                raise RuntimeError(f"{label} exports no entry point of "
                                   f"{kernel}")
            stand_in = Earlier(*entry, lib)

            def run_earlier():
                with swapped(module, attr, stand_in):
                    return run()
            return run_earlier

        cases = []       # (kernel, case, run on this checkout's build)
        if "trace" in kernels:
            cases += [("trace", k, lambda a=v: dda.trace_cuda(
                a[0], a[1], tables, tp, a[2], a[3]))
                for k, v in S.trace_inputs(eng, traces).items()]
        if "tri" in kernels:
            cases += [("tri", k,
                       lambda a=v: triangles.intersect_packed_cuda(*a))
                      for k, v in S.tri_inputs(eng, tris).items()]
            soup, po, pd = S.in_plane_inputs(eng.device)
            cases.append(("tri", IN_PLANE + f" {po[0].numel()}",
                          lambda: triangles.intersect_packed_cuda(
                              po, pd, soup)))
        if "texture" in kernels:
            atlas, t_count, tid, u, v, lvl = S.texture_inputs(eng)
            PLANAR[atlas.lo4.data_ptr()] = (atlas.lo, atlas.hi)
            cases.append((
                "texture", f"{t_count} textures, {fw}x{fh} lod field",
                lambda: it._sample_cuda(atlas, t_count, tid, u, v, lvl)))
        if "shade" in kernels:
            cases += [("shade", k, lambda a=v: RK.flatten_out(
                RK.fused_shade_cuda(*a[0], **a[1])))
                for k, v in S.shade_cases(eng).items()]
        if "atrous" in kernels:
            cases += [("atrous", k,
                       lambda a=v: atrous_kernel._atrous_cuda(*a[:5], *a[5]))
                      for k, v in S.atrous_inputs(eng, atrous).items()]
        if "easu" in kernels:
            cases += [("easu", f"{k}: {img.shape[1]}x{img.shape[0]} -> "
                       f"{ow}x{oh}",
                       lambda a=(img, oh, ow): (EK._easu_cuda(*a),))
                      for k, (img, oh, ow) in S.easu_inputs(eng).items()]
        del traces, atrous, tris
        results = {}
        for kernel, case, run in cases:
            fns = {"current": run}
            for label in builds:
                fn = on(label, kernel, run)
                try:
                    fn()
                except NotComparable:
                    S.log(f"{kernel:7s} {case}: {label} does not take it")
                    continue
                fns[label] = fn
            ref = run()
            differ = {}
            for label, fn in list(fns.items()):
                if label == "current":
                    continue
                n = differing(ref, fn())
                if n:
                    differ[label] = n
                    S.log(f"{kernel:7s} {case}: {label}: {n} output values "
                          f"differ from this checkout's")
                    S.check(case.startswith(IN_PLANE),
                            f"{kernel} {case} {label}: outputs differ")
                    del fns[label]
            t = S.timed_rounds(fns, args.rounds, args.runs)
            med = {k: statistics.median(v) for k, v in t.items()}
            results[f"{kernel} | {case}"] = dict(rounds=t, median_ms=med,
                                                 values_differ=differ)
            S.log(f"{kernel:7s} {case:45s} " + "  ".join(
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
            elif kernel in ("trace", "tri", "atrous"):
                frame = [r["median_ms"] for k, r in results.items()
                         if k.startswith(f"{kernel} | frame")]
            else:
                continue
            labels = set.intersection(*(set(m) for m in frame))
            sums[kernel] = {label: sum(m[label] for m in frame)
                            for label in sorted(labels)}
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
