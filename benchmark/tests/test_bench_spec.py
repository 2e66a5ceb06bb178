"""BENCHMARK.json against the contract it is written to, and the harness's
lookup of every cell's files by name."""

import json
import re
import shutil

import pytest

from bench_stub import BENCH, OPEN_CELLS, OPEN_LIMITS, ROOT
from harness.spec import load_spec, metric_reader, readers, resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in names
        assert NAME.match(w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    every = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in every)
    assert len(set(CELLS)) == len(CELLS)
    for text in [c["why"] for c in SPEC["configs"] + SPEC["workloads"]] + [
            m["layer"] for m in SPEC["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = resolve(SPEC, ROOT, cell)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == cell)
    assert c.traffic["mode"] in ("lio", "lio4d", "loam")
    assert c.limits["checks"], "every cell states the numbers that decide correct"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(c.traffic["end_to_end"]) <= e2e
    per = readers(c)
    assert per, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert per[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e


def test_every_metric_file_has_a_reader():
    for m in SPEC["per_layer"]:
        mod = metric_reader(m["name"])
        assert callable(mod.read)


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later cell is a workload entry, a traffic file, a limits file and
    metric files: the harness finds them by name, with no code changed."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "indoor-live-slow", "config": "indoor_vlp16",
                              "traffic": "lio_live_5hz", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "sweeps_fed", "unit": "sweeps", "better": "higher",
                              "source": "program_counter", "layer": "host loop and pipeline entry",
                              "moves": "pose_latency_p95_ms", "workloads": ["indoor-live-slow"]})
    spec["end_to_end"].append({"name": "pose_latency_p95_ms", "unit": "ms", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["indoor-live-slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = dict(OPEN_CELLS["indoor-live"], why="half the sensor's rate")
    (bench / "traffic" / "lio_live_5hz.json").write_text(json.dumps(traffic))
    (bench / "limits" / "indoor-live-slow.json").write_text(json.dumps(OPEN_LIMITS))
    (bench / "metrics" / "sweeps_fed.py").write_text(
        'UNIT = "sweeps"\n\n\ndef read(ctx):\n    return len(ctx["sweeps"])\n')
    cell = resolve(load_spec(tmp_path), tmp_path, "indoor-live-slow", bench_dir=bench)
    assert cell.traffic["why"] == "half the sensor's rate"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "pose_latency_p95_ms"]
    assert "sweeps_fed" in readers(cell, bench)
    assert readers(cell, bench)["sweeps_fed"].read({"sweeps": [1, 2, 3]}) == 3
