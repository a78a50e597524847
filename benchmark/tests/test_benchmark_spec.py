"""BENCHMARK.json against the benchmark's contract, and the files it
names."""
import json
import os
import re

import benchpaths
from rtvbbench.spec import Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    with open(os.path.join(benchpaths.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(benchpaths.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    s = spec()
    names = [c["name"] for c in s["configs"]] + \
        [w["name"] for w in s["workloads"]] + \
        [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in s["configs"])) == len(s["configs"])
    assert len(set(w["name"] for w in s["workloads"])) == len(s["workloads"])
    metrics = s["end_to_end"] + s["per_layer"]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(benchpaths.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])


def test_every_cell_reports_what_it_must():
    s = spec()
    b = Benchmark()
    for w in s["workloads"]:
        e2e = [m["name"] for m in b.metrics(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert b.metrics(w["name"], True)
        assert os.path.exists(os.path.join(b.dir, "limits",
                                           w["name"] + ".json"))
    moves = {m["name"]: m.get("workloads") for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in moves
        for cell in m["workloads"]:
            assert moves[m["moves"]] is None or cell in moves[m["moves"]]
    layers = {}
    for m in s["per_layer"]:
        layers.setdefault(m["layer"].split(",")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_reader():
    b = Benchmark()
    for m in b.spec["end_to_end"] + b.spec["per_layer"]:
        assert callable(b.reader(m["name"]).read)


def test_result_line_schema():
    """The last line a run prints, from a run of the harness on the CPU."""
    import test_benchmark_check as T
    res = T.cpu_run("native.fly", trace=False)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
