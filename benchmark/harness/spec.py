"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a file of its own under ``benchmark/``:

* ``configs/<config>.json``: the deployment (profile, sensor, IMU, world,
  trajectory, sequence), as ``configs[].file`` in ``BENCHMARK.json`` says;
* ``traffic/<traffic>.json``: how the cell drives the program (mode,
  arrival, set-up sweeps, read-ahead);
* ``limits/<cell>.json``: the numbers that decide ``correct`` and their
  limits, with the readings each was set from;
* ``metrics/<metric>.py``: one reader per per-layer metric.

A later cell, mix or metric is added by adding files and entries; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent   # benchmark/


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` with its files read."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(root / confs[w["config"]]["file"])
    traffic = _read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits_path = bench_dir / "limits" / f"{name}.json"
    limits = _read_json(limits_path) if limits_path.exists() else {"checks": {}}
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def metric_reader(name: str, bench_dir: Path = HERE):
    """The module of ``metrics/<name>.py``: ``read(ctx)`` returns the
    metric's value, or None where the run holds nothing to read."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def readers(cell: Cell, bench_dir: Path = HERE) -> Dict[str, object]:
    return {m["name"]: metric_reader(m["name"], bench_dir) for m in cell.per_layer}
