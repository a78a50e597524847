"""A configuration, a traffic mix and a metric added as new files and
BENCHMARK.json entries are found by name, with no existing file edited."""
import hashlib
import json
import os
import shutil

import benchpaths
from rtvbbench.spec import Benchmark
from rtvbbench.traffic import Traffic


def tree_hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_add_by_files(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(benchpaths.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(benchpaths.ROOT, "BENCHMARK.json"), root)
    before = tree_hashes(bench)
    (bench / "configs" / "native_720p.json").write_text(json.dumps(
        {"window": [1280, 720], "settings": {"rendering": {
            "render_scale": 1.0}}, "scene": {"world_seed": 124}}))
    (bench / "traffic" / "still.json").write_text(json.dumps(
        {"camera": {"pos": [32.0, 18.0, 8.0], "yaw": 1.1,
                    "pitch": -0.35}}))
    (bench / "metrics" / "frame_count.py").write_text(
        "def read(run):\n    return float(len(run.sess.window_frames()))\n")
    (bench / "limits" / "native720.still.json").write_text(
        json.dumps({"frame_off3": 0.01}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name="native_720p", source="https://example.org/720p",
        file="benchmark/configs/native_720p.json", reduced=[], why="x"))
    spec["workloads"].append(dict(name="native720.still",
                                  config="native_720p", traffic="still",
                                  chips=1, why="x"))
    for m in spec["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("native720.still")
    spec["per_layer"].append(dict(
        name="frame_count", unit="count", better="higher",
        source="host_clock", layer="Engine, render/renderer.py",
        moves="frame_ms", workloads=["native720.still"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    b = Benchmark(root=str(root), bench_dir=str(bench))
    cell = b.cell("native720.still")
    assert b.config(cell["config"])["window"] == [1280, 720]
    tr = Traffic(b.traffic(cell["traffic"]), 5)
    assert tr.pose(3.0) == ((32.0, 18.0, 8.0), 1.1, -0.35)
    assert [m["name"] for m in b.metrics("native720.still", True)][-1] \
        == "frame_count"
    assert "frame_count" not in [m["name"] for m in
                                 b.metrics("native.fly", True)]
    mod = b.reader("frame_count")

    class Run:
        class sess:
            @staticmethod
            def window_frames():
                return [1, 2, 3]
    assert mod.read(Run) == 3.0
    assert b.limits("native720.still") == {"frame_off3": 0.01}
    after = tree_hashes(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_kernel_roles_found_by_file(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(benchpaths.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "kernels" / "newk.py").write_text(
        'PATTERN = r"\\bnew_kernel\\b"\nHOOK = ("x", "y")\n'
        "def work(args, kwargs):\n    return 0, 0\n")
    b = Benchmark(root=benchpaths.ROOT, bench_dir=str(bench))
    roles = b.kernel_roles()
    assert set(roles) == {"trace", "tri", "texture", "shade", "warp",
                          "atrous", "easu", "newk"}


def test_split_quantity_read_by_its_base_reader():
    """`<base>.<group>` without a file of its own is read by
    metrics/<base>.py; a file of its own comes first."""
    b = Benchmark()
    assert b.reader("frame_ms.half").__doc__ == b.reader("frame_ms").__doc__
    assert b.reader("device.idle_share.half").__doc__ == \
        b.reader("device.idle_share").__doc__
    every = b.spec["end_to_end"] + b.spec["per_layer"]
    for m in every:
        assert b.reader(m["name"]).read is not None
    assert os.path.exists(os.path.join(benchpaths.BENCH, "metrics",
                                       "hand_kernels_half_roofline.py"))
