"""Scan-to-map GN iterations a 4D builder step runs: the conditional
bodies ``map.<k>`` of the builder's CUDA graph that ran (each leaves a
start and an end stamp; a body the device skips leaves none), mean over
the untraced part's builder steps (``harness/program.py``). Moves
``sweeps_per_s``."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.program import records  # noqa: E402

UNIT = "iters"


def read(ctx):
    w = records(ctx)
    if w is None or not w["builder_bodies"]:
        return None
    return float(np.mean(w["builder_bodies"]))
