"""The blessed goldens of data/canonical/ rendered by both packages on the
CPU, each against the golden and against the other.

    JAX_PLATFORMS=cpu python tests/torch_goldens.py [--cases a,b,...]
        [--jax-root DIR] [--out FILE]

Each case renders exactly as the JAX package's golden tests and
tools/bless_goldens.py render it: the 128² canonical (8 accumulated
frames of `Engine.render_accumulated`), the three scripted edit sequences
at 96² (`offline.main --test-sequence` 12 frames, `--test-remove20` and
`--test-remove-circle` 44), the 512² canonical (64 frames; slow on the
CPU, only when named) and the flythrough's realtime frame 16 at 96².
For the scripted runs it also says whether both packages picked the
same blocks, and how many pixels differ by more than 2/255.  The
port runs on the CPU (`--device cpu`); the JAX package is this checkout's
`rtvb_tpu` or, with --jax-root, the one in DIR (an unpacked older commit),
under the JAX tests' configuration (the CPU platform, 8 host devices).
Prints one line a case and writes the numbers as JSON to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANON = os.path.join(ROOT, "data", "canonical")
SCRIPTED = [("sequence", "--test-sequence", 12),
            ("remove20", "--test-remove20", 44),
            ("remove_circle", "--test-remove-circle", 44)]
CASES = ("canonical_128", "sequence", "remove20", "remove_circle",
         "flythrough", "canonical_512")
DEFAULT_CASES = CASES[:5]


def _setup_jax(jax_root: str | None):
    """Import the JAX package under the golden tests' configuration."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    if jax_root:
        sys.path.insert(0, os.path.abspath(jax_root))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(ROOT, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    import rtvb_tpu
    return os.path.dirname(os.path.dirname(os.path.abspath(
        rtvb_tpu.__file__)))


def _accumulated(Engine, Settings, size: int, frames: int, **kw):
    eng = Engine(settings=Settings(), width=size, height=size, **kw)
    out = None
    for _ in range(frames):
        out = eng.render_accumulated()
    return out


def _flythrough(Engine, Settings, apply_flythrough, **kw):
    eng = Engine(settings=Settings(), width=96, height=96, **kw)
    pos0 = yaw0 = None
    out = None
    for i in range(17):
        pos0, yaw0 = apply_flythrough(eng, i, 24, pos0, yaw0)
        out = eng.render_realtime()
    return out


def _recording_picks(module, picks: list):
    """Replace `module.Engine` by a subclass that appends each pick's
    result to `picks` (once a module)."""
    base = module.Engine
    if getattr(base, "records_picks", False):
        return

    class PickRecorder(base):
        records_picks = True

        def pick_block(self, *a, **kw):
            got = super().pick_block(*a, **kw)
            picks.append(got)
            return got

    module.Engine = PickRecorder


def _scripted(offline_main, read_png, flag: str, frames: int, extra=()):
    with tempfile.TemporaryDirectory() as td:
        rc = offline_main(["--width", "96", "--height", "96", "--frames",
                           str(frames), "--out-dir", td, flag, *extra])
        assert rc == 0, (flag, rc)
        return read_png(os.path.join(td, f"frame_{frames:04d}.png"))


PICKS = {"port": [], "jax": []}


def render_port(case: str):
    from rtvb_tpu_torch.apps import offline
    from rtvb_tpu_torch.core.config import Settings
    from rtvb_tpu_torch.render.renderer import Engine
    from rtvb_tpu_torch.utils.flypath import apply_flythrough
    from rtvb_tpu_torch.utils.image import read_png
    if case == "canonical_128":
        return _accumulated(Engine, Settings, 128, 8, device="cpu")
    if case == "canonical_512":
        return _accumulated(Engine, Settings, 512, 64, device="cpu")
    if case == "flythrough":
        return _flythrough(Engine, Settings, apply_flythrough, device="cpu")
    flag, frames = next((f, n) for c, f, n in SCRIPTED if c == case)
    _recording_picks(offline, PICKS["port"])
    return _scripted(offline.main, read_png, flag, frames,
                     extra=("--device", "cpu"))


def render_jax(case: str):
    from rtvb_tpu.apps import offline
    from rtvb_tpu.core.config import Settings
    from rtvb_tpu.render.renderer import Engine
    from rtvb_tpu.utils.flypath import apply_flythrough
    from rtvb_tpu.utils.image import read_png
    if case == "canonical_128":
        return _accumulated(Engine, Settings, 128, 8)
    if case == "canonical_512":
        return _accumulated(Engine, Settings, 512, 64)
    if case == "flythrough":
        return _flythrough(Engine, Settings, apply_flythrough)
    flag, frames = next((f, n) for c, f, n in SCRIPTED if c == case)
    _recording_picks(offline, PICKS["jax"])
    return _scripted(offline.main, read_png, flag, frames)


def golden_path(case: str) -> str:
    if case == "canonical_128":
        return os.path.join(CANON, "canonical_render.png")
    if case == "canonical_512":
        return os.path.join(CANON, "canonical_512.png")
    if case == "flythrough":
        return os.path.join(CANON, "scripted", "flythrough_f16.png")
    return os.path.join(CANON, "scripted", f"{case}_final.png")


def as_u8(img):
    """A render as u8 (scripted renders come back as u8 PNGs already)."""
    import numpy as np
    from rtvb_tpu_torch.utils.image import to_u8
    img = np.asarray(img)
    return img if img.dtype == np.uint8 else to_u8(img)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(DEFAULT_CASES),
                    help=f"comma-separated, of {', '.join(CASES)}")
    ap.add_argument("--jax-root", default=None,
                    help="directory holding the rtvb_tpu package to render "
                         "with (default: this checkout's)")
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    jax_pkg = _setup_jax(args.jax_root)
    from rtvb_tpu_torch.utils import image_diff
    from rtvb_tpu_torch.utils.image import read_png

    def diff(a, b):
        r = image_diff.compare(a, b)
        return dict(verdict=r.verdict, rmse=r.rmse, ssim=r.ssim,
                    diff_fraction=r.diff_pixel_fraction)

    results = dict(jax_package=jax_pkg, cases={})
    for case in args.cases.split(","):
        golden = read_png(golden_path(case))
        row = {}
        t0 = time.perf_counter()
        jax_u8 = as_u8(render_jax(case))
        row["jax_s"] = time.perf_counter() - t0
        row["jax_vs_golden"] = diff(jax_u8, golden)
        t0 = time.perf_counter()
        port_u8 = as_u8(render_port(case))
        row["port_s"] = time.perf_counter() - t0
        row["port_vs_golden"] = diff(port_u8, golden)
        row["port_vs_jax"] = diff(port_u8, jax_u8)
        row["pixels_off_by_3"] = int((abs(port_u8.astype(int)
                                          - jax_u8.astype(int))
                                      .max(-1) > 2).sum())
        if PICKS["jax"] or PICKS["port"]:
            row["picks"] = len(PICKS["jax"])
            row["picks_equal"] = PICKS["jax"] == PICKS["port"]
        for picks in PICKS.values():
            picks.clear()
        results["cases"][case] = row
        print(case, json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
