"""Offline headless renderer CLI (port of rtvb_tpu/apps/offline.py, the
same flags, frames and exit codes).

An N-frame accumulation loop (`Engine.render_accumulated`) or, with
--realtime, the 1-spp denoised frame, saving frames {1, 4, 16, 64} and the
last; a canonical-image diff with its verdict (exit 0 when "close" or
better, 1 when not, 2 without a canonical image); scripted edit sequences
that drive the dynamic geometry and light path deterministically
(--test-sequence, --test-remove20, --test-remove-circle); an opt-in
stage-timing report.  The engine runs on "cuda" unless given
--device cpu.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..assets import blocks as B
from ..core.config import Settings
from ..core.scene import SceneConfig
from ..render.renderer import Engine
from ..utils import image, image_diff
from ..utils.perf import PerformanceTracker

SAVE_FRAMES = (1, 4, 16, 64)
DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def build_argparser():
    ap = argparse.ArgumentParser("rtvb-offline", description=__doc__)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--scene", type=str, default=None, help="scene YAML path")
    ap.add_argument("--settings", type=str, default=None, help="settings YAML path")
    ap.add_argument("--out-dir", type=str, default=os.path.join(DATA_DIR, "frames"))
    ap.add_argument("--canonical", type=str,
                    default=os.path.join(DATA_DIR, "canonical", "canonical_render.png"))
    ap.add_argument("--test-canonical", action="store_true",
                    help="compare final frame against the canonical image")
    ap.add_argument("--update-canonical", action="store_true",
                    help="re-bless the canonical image from this run")
    ap.add_argument("--test-sequence", action="store_true",
                    help="scripted: place light frame 2, remove frame 5, place frame 8")
    ap.add_argument("--test-remove20", action="store_true",
                    help="scripted: 20 block deletions across the run")
    ap.add_argument("--test-remove-circle", action="store_true",
                    help="scripted: 8 camera directions x 5 deletions")
    ap.add_argument("--authored", action="store_true",
                    help="render with authored PBR textures (the default; "
                         "kept as an explicit no-op for older scripts)")
    ap.add_argument("--procedural", action="store_true",
                    help="render with the procedural texture stack "
                         "(rendering.authored_textures=False; pair with "
                         "--canonical data/canonical/canonical_procedural.png)")
    ap.add_argument("--realtime", action="store_true",
                    help="use the 1spp+denoiser path instead of accumulation")
    ap.add_argument("--save-all", action="store_true", help="save every frame")
    ap.add_argument("--perf-report", type=str, default=None,
                    help="append the run's stage rows to this report file "
                         "(opt-in, so that ad-hoc runs do not write to the "
                         "committed data/perf/performance_report.txt)")
    ap.add_argument("--label", type=str, default="offline run")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=("cuda", "cpu"),
                    help="the engine's device (default: the card)")
    return ap


def scripted_edits(engine: Engine, frame: int, args) -> bool:
    """Returns True if the world changed this frame (resets accumulation).
    Column tops come from the engine's host grid (nothing read back from
    the card)."""
    changed = False
    if args.test_sequence:
        # place light / remove / place
        spot = (34, 10, 40)
        if frame == 2:
            engine.set_block(*spot, B.LANTERN)
            changed = True
        elif frame == 5:
            engine.delete_block(*spot)
            changed = True
        elif frame == 8:
            engine.set_block(*spot, B.LANTERN)
            changed = True
    if args.test_remove20 and frame in range(2, 42, 2):
        k = (frame - 2) // 2
        x = 20 + (k % 10) * 2
        z = 30 + (k // 10) * 3
        column = engine.host_world.blocks[x, :, z]
        h = int(np.asarray(column != 0).nonzero()[0].max())
        engine.delete_block(x, h, z)
        changed = True
    if args.test_remove_circle and frame in range(2, 42, 1):
        k = frame - 2
        direction = k // 5
        yaw = direction * (2 * np.pi / 8)
        engine.set_camera(yaw=yaw, pitch=-0.5)
        hit, (x, y, z), _ = engine.pick_block(max_dist=20.0)
        if hit:
            engine.delete_block(x, y, z)
        changed = True
    return changed


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    settings = Settings.load(args.settings) if args.settings else Settings()
    rend = {"render_width": args.width, "render_height": args.height}
    if args.authored:
        rend["authored_textures"] = True
    if args.procedural:
        rend["authored_textures"] = False
    settings = settings.replace(rendering=rend)
    scene = SceneConfig.load(args.scene) if args.scene else SceneConfig()

    engine = Engine(settings=settings, scene=scene,
                    width=args.width, height=args.height, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    perf = PerformanceTracker()
    final = None
    batch_paths, batch_frames = [], []
    for frame in range(1, args.frames + 1):
        perf.begin_frame()
        with perf.segment("scenePrep"):
            if scripted_edits(engine, frame, args) and not args.realtime:
                engine.reset_accumulation()
        if args.realtime:
            # a u8 frame on the engine's device; timed waits for the card
            out = perf.timed("pathTracing", engine.render_realtime_device)
        else:
            # f32 display values on the host: complete on return
            out = perf.timed("pathTracing", engine.render_accumulated)
        perf.end_frame()
        final = out
        if args.save_all or frame in SAVE_FRAMES or frame == args.frames:
            # kept in host memory, encoded together at the end
            path = os.path.join(args.out_dir, f"frame_{frame:04d}.png")
            batch_paths.append(path)
            batch_frames.append(image.host(out))
            print(f"[offline] frame {frame}/{args.frames} -> {path}")
        else:
            print(f"[offline] frame {frame}/{args.frames}")
    image.write_pngs(batch_paths, batch_frames)
    final = image.host(final)

    if args.perf_report:
        perf.save_report(args.perf_report,
                         f"{args.label} {args.width}x{args.height}")
    print("[offline]", perf.summary_row(args.label))

    if args.update_canonical:
        os.makedirs(os.path.dirname(args.canonical), exist_ok=True)
        image.write_png(args.canonical, final)
        print(f"[offline] canonical updated: {args.canonical}")
    if args.test_canonical:
        if not os.path.exists(args.canonical):
            print("[offline] NO CANONICAL IMAGE — run --update-canonical first")
            return 2
        golden = image.read_png(args.canonical)
        res = image_diff.compare(final, golden)
        print("[offline] canonical test:", res)
        diff_img = image_diff.amplified_diff(image.to_u8(final), golden)
        image.write_png(os.path.join(args.out_dir, "canonical_diff.png"), diff_img)
        return 0 if res.verdict in ("identical", "veryClose", "close") else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
