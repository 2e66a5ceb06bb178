"""What the benchmark's processes load: no JAX and no JAX package in a run,
nothing of the program in the reference; and a run with no card prints no
result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_stub import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "lio_mapping_tpu"}


def loaded_top_names(code: str) -> set:
    """The top-level names (before the first dot) of every module a fresh
    interpreter holds after running ``code``."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=f"{BENCH}{os.pathsep}{ROOT}"), timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = loaded_top_names(
        "import run, lio_mapping_tpu_torch\n"
        "from harness import cell, drive, reference, roofline, scan_to_map, spec, trace, world\n"
        "from lio_mapping_tpu_torch.models import pipeline, map_builder\n"
        "from harness.spec import load_spec, resolve, readers\n"
        "from pathlib import Path\n"
        "s = load_spec(Path('.'))\n"
        "[readers(resolve(s, Path('.'), w['name'])) for w in s['workloads']]")
    assert "lio_mapping_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_top_names("from harness import reference, roofline, scan_to_map, world")
    assert not names & (FORBIDDEN | {"lio_mapping_tpu_torch"})


def test_the_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    monkeypatch.setitem(sys.modules, "lio_mapping_tpu_torch.models", sys.modules[__name__])
    assert "lio_mapping_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lio_mapping_tpu.models", sys.modules[__name__])
    assert run.forbidden_modules() == ["lio_mapping_tpu"]


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")


def test_no_card_no_result(no_card):
    out = _run(ROOT, "--workload", "indoor-4d-replay", "--seed", str(2 ** 31 + 3), "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    own files the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "indoor-4d-replay", "--seed", "5", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
