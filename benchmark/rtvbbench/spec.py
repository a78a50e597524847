"""BENCHMARK.json and the benchmark's own files, found by name.

A cell (`workloads` in BENCHMARK.json) names a configuration and a
traffic mix: `configs/<config>.json` and `traffic/<traffic>.json` hold
them; `cells/<cell>.json`, where there is one, how the cell runs
(`settle_s`).  Every metric is a reader `metrics/<name>.py`, every hand
kernel's role (its device name and its work) `kernels/<name>.py`, and
the limits of a cell's output check `limits/<cell>.json`.  Adding one
of these is adding a file and an entry, never editing an existing file.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(RuntimeError):
    pass


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        raise SpecError(f"missing file: {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"rtvbbench_{tag}_" + os.path.basename(path)[:-3].replace(".", "_")
        .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """BENCHMARK.json and the files it names, under `bench_dir`."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root = root
        self.dir = bench_dir
        self.spec = _read_json(os.path.join(root, "BENCHMARK.json"))
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                            f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = self.configs[name]
        return _read_json(os.path.join(self.root, entry["file"]))

    def traffic(self, name: str) -> dict:
        return _read_json(os.path.join(self.dir, "traffic", name + ".json"))

    def settle_s(self, cell: str) -> float:
        """The seconds of the cell's settle phase before its window
        (`cells/<cell>.json`; 0 without one)."""
        path = os.path.join(self.dir, "cells", cell + ".json")
        if not os.path.exists(path):
            return 0.0
        return float(_read_json(path)["settle_s"])

    def limits(self, cell: str) -> dict:
        return _read_json(os.path.join(self.dir, "limits", cell + ".json"))

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of `cell` reports: its end-to-end metrics
        (trace off) or its per-layer metrics (trace on), each entry of
        BENCHMARK.json that applies to the cell."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """The reader module of a metric: `metrics/<name>.py` with
        read(run) → a number, or None where the run has nothing to
        read.  A metric `<base>.<group>` without a file of its own, one
        quantity split by the end-to-end metric its cells report (as
        `frame_ms.half` beside `frame_ms`), is read by
        `metrics/<base>.py`."""
        path = os.path.join(self.dir, "metrics", metric + ".py")
        if not os.path.exists(path) and "." in metric:
            base = os.path.join(self.dir, "metrics",
                                metric.rsplit(".", 1)[0] + ".py")
            if os.path.exists(base):
                path = base
        return _load_module(path, "metric")

    def kernel_roles(self) -> dict:
        """{name: module} of every `kernels/<name>.py`: a hand kernel's
        device name (PATTERN), the port function whose calls launch it
        (HOOK) and its work (work(args, kwargs) → (bytes, operations))."""
        out = {}
        for path in sorted(glob.glob(os.path.join(self.dir, "kernels",
                                                  "*.py"))):
            name = os.path.basename(path)[:-3]
            out[name] = _load_module(path, "kernel")
        return out
