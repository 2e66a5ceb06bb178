"""Device milliseconds of one scan-to-map GN iteration of the 4D builder
(its body ``map.<k>``: the corner 5-NN on the plain search, the surf
5-NN on the KNN kernel, the line and plane fits and the step), from its
start stamp to its end stamp, mean over the untraced part's builder steps
(``harness/program.py``). Times ``builder_gn_iterations`` it is most of
``builder_step_device_ms``. Moves ``sweeps_per_s``."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.program import records  # noqa: E402

UNIT = "ms"


def read(ctx):
    w = records(ctx)
    if w is None or not w["builder_body_ms"]:
        return None
    return float(np.mean(w["builder_body_ms"]))
