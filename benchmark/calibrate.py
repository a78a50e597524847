"""The readings the output check's limits are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 3] [--json PATH]

One set-up of the cell on the card, then for each seed: a window of
`--seconds` of that seed's traffic at the cell's own load, then the
check's frames on the program against the reference (the lower
readings).  For each control seed also the control, the reference with
its stages' float32 planes stored in bfloat16 put in the program's place
(the upper readings), and for the first control seed the reference with
TF32 products (`tf32`).  Prints a JSON line per reading.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2 --fresh
        [--seconds 1]

The states handed over, worked out again: for each seed a set-up of its
own and a window of `--seconds`, then the check's frames on the program
against the reference from its own first state, which renders every
frame of the run (set-up and window) before them.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--fresh", action="store_true")
    a = ap.parse_args(argv)
    from rtvbbench import check as C
    from rtvbbench.cli import cache_dirs
    from rtvbbench.session import Session
    from rtvbbench.spec import Benchmark
    from rtvbbench.traffic import Traffic
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from rtvb_tpu_torch import kernels as K
    K.LIBRARY.get()
    b = Benchmark()
    cell = b.cell(a.workload)
    spec = b.traffic(cell["traffic"])
    seeds = [int(s) for s in a.seeds.split(",")]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    if a.fresh:
        return fresh(b, cell, spec, seeds, a)
    sess = Session(b.config(cell["config"]), spec, seeds[0])
    sess.build()
    sess.warm()
    clicking = spec.get("clicks") is not None
    character = spec.get("character") is not None
    out = []
    for seed in seeds:
        sess.traffic = Traffic(spec, seed)
        sess.start()
        sess.run_window(a.seconds)
        prog = C.program_side(sess, free=False)
        t0 = time.perf_counter()
        ref = C.reference_side(sess, prog)
        ref_s = time.perf_counter() - t0
        rows = [("program", C.compare(prog, ref, clicking, character),
                 ref_s)]
        kinds = (["bf16", "tf32"] if seed == controls[0] else ["bf16"]) \
            if seed in controls else []
        for kind in kinds:
            t0 = time.perf_counter()
            ctrl = C.reference_side(sess, prog, kind)
            rows.append((kind, C.compare(
                ctrl, dict(ref, picks_diff=ctrl["picks_diff"]), clicking,
                character), time.perf_counter() - t0))
        for who, numbers, secs in rows:
            line = dict(cell=a.workload, seed=seed, who=who,
                        numbers=numbers, reference_s=secs,
                        frames=len(sess.window_frames()))
            out.append(line)
            print(json.dumps(line), flush=True)
        del prog, ref
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def fresh(b, cell, spec, seeds, a) -> int:
    """The reference from its own first state over every frame of a short
    run, one set-up a seed."""
    import gc
    from rtvbbench import check as C
    from rtvbbench.session import Session
    out = []
    for seed in seeds:
        sess = Session(b.config(cell["config"]), spec, seed)
        sess.build()
        sess.warm()
        sess.start()
        sess.run_window(a.seconds)
        prog = C.program_side(sess)
        t0 = time.perf_counter()
        ref = C.reference_side(sess, prog, fresh=True)
        line = dict(cell=a.workload, seed=seed, who="fresh",
                    numbers=C.compare(prog, ref, spec.get("clicks")
                                      is not None,
                                      spec.get("character") is not None),
                    reference_s=time.perf_counter() - t0,
                    frames=len(sess.frames),
                    clicks=len(sess.clicks))
        out.append(line)
        print(json.dumps(line), flush=True)
        del sess, prog, ref
        gc.collect()
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
