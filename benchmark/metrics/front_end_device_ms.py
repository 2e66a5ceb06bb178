"""Device milliseconds of a consumed INITED sweep's front end (ring,
features, voxel filters: ``models/point_processor.py``, ``ops/ring``,
``ops/features``, ``ops/voxel``), mean over the untraced part's consumed
sweeps: the program's stamps from the start of the sweep's CUDA graph to
its ``front`` boundary (``harness/program.py``). Moves ``sweeps_per_s``."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.program import records  # noqa: E402

UNIT = "ms"


def read(ctx):
    w = records(ctx)
    if w is None or not w["front_ms"]:
        return None
    return float(np.mean(w["front_ms"]))
