"""Device milliseconds of a consumed INITED sweep's estimator step
(``estimator.step_program`` after the front end: window push, local map,
associations, mini-GN, marginalisation, window LM), mean over the untraced
part's consumed sweeps: the program's stamps from the ``front`` boundary
to the end of the sweep's CUDA graph (``harness/program.py``). With
``front_end_device_ms`` it makes up the consumed graph. Moves
``sweeps_per_s``."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.program import records  # noqa: E402

UNIT = "ms"


def read(ctx):
    w = records(ctx)
    if w is None or not w["step_ms"]:
        return None
    return float(np.mean(w["step_ms"]))
