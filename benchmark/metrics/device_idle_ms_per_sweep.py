"""Milliseconds a sweep in which the card does no work of the program:
over the untraced part of the window, from the first sweep's call to the
last stamp, the time outside the union of the calls' device intervals
(from each ``process`` and ``builder`` call's host-launched stamp to its
last stamp), over the sweeps; the run log names the ten longest gaps by
the program span the host was in (``harness/program.py``). Untraced, so
the profiler's host cost is not in it. Moves ``sweeps_per_s``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from harness.program import records  # noqa: E402

UNIT = "ms"


def read(ctx):
    w = records(ctx)
    if w is None:
        return None
    return w["idle_ms_per_sweep"]
