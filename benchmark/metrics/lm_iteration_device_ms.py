"""Device milliseconds of one window-LM iteration: each conditional body
``lm.<k>`` of the consumed sweeps' graphs that ran (the iterations after
the first), from its start stamp to its end stamp, mean over the untraced
part (``harness/program.py``). Read beside ``lm_iterations_per_consumed``:
the step's time is about its iterations times this. Moves
``sweeps_per_s``."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.program import records  # noqa: E402

UNIT = "ms"


def read(ctx):
    w = records(ctx)
    if w is None or not w["lm_body_ms"]:
        return None
    return float(np.mean(w["lm_body_ms"]))
