"""On the card (``-m cuda``): a short run of each cell through the program,
the control and the planted faults at the cells' own sizes. Each skips
without a card."""

import json
import subprocess
import sys

import pytest

from bench_stub import ROOT, SPEC_CELLS

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def run(cell, seed, *extra, seconds=6):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", str(seconds), "--trace", "0", *extra],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("cell", SPEC_CELLS)
def test_a_short_run_is_correct_and_captures_nothing_in_its_window(card, cell):
    result, err = run(cell, 2 ** 31 + 211)
    assert result["correct"] is True, err[-2000:]
    assert "graph captures 0;" in err


@pytest.mark.parametrize("fault", ["frozen", "altered"])
def test_a_planted_fault_is_not_correct(card, fault):
    result, err = run("indoor-4d-replay", 2 ** 31 + 212, "--fault", fault)
    assert result["correct"] is False, err[-2000:]


def test_the_tf32_control_is_not_correct(card):
    """The precision control (TF32 matrix products, the step below the
    float32 the configuration states) fails the check: its checked builder
    steps' rotations lie further from the float64 reference's than the
    program's own do, step for step (the median step)."""
    result, err = run("indoor-4d-replay", 2 ** 31 + 213, "--control", "tf32",
                      "--check-every", "5", seconds=12)
    assert result["correct"] is False, err[-2000:]
    gap = result["checks"]["4d_step_gap_deg_median"]
    assert gap["value"] > gap["limit"]
