"""Device milliseconds of a consumed INITED sweep in a replay cell: every
device activity launched from the sweep's ``process`` call (its CUDA
graph: front end and ``estimator.step_program``, and the cloud's copy),
mean over the traced part's consumed sweeps, from the profiler's trace.
Moves ``sweeps_per_s``; read it beside ``lm_iterations_per_consumed``."""

UNIT = "ms"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.empty or ctx["arrival"] != "replay":
        return None
    ms = [m for m in tr.span_device_ms("sweep.consumed") if m > 0]
    return sum(ms) / len(ms) if ms else None
