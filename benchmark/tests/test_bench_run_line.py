"""A whole run of each cell on the CPU with a stand-in program: the result
line's keys, the checks last, and ``correct`` false for each fault that the
cell's timed path can have."""

import json

import pytest

from bench_stub import OPEN_CELLS, SPEC_CELLS, tiny_cell
from harness.cell import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = SPEC_CELLS + sorted(OPEN_CELLS)


def run(cell_name, trace=False, fault=None, seconds=2.0):
    cell, make, _ = tiny_cell(cell_name, fault)
    return run_cell(cell, 2 ** 31 + 101, seconds, trace, "cpu", make_system=make,
                    log=lambda msg: None)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    out = run(cell)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_line(cell):
    out = run(cell, trace=True)
    assert list(out)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert "setup_s" not in out["metrics"]


@pytest.mark.parametrize("fault", ["frozen", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = run(cell, fault=fault)
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("cell", [c for c in CELLS if "loam" not in c])
def test_a_bootstrap_that_never_ends_is_not_correct(cell):
    out = run(cell, fault="never_inited")
    assert out["correct"] is False
