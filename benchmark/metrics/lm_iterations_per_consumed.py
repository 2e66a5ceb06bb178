"""LM iterations of the window solve a consumed INITED sweep runs, mean
over the window's consumed sweeps: the estimator's own device counter
(``solver_iterations``), read back once the window has closed. The LM
stops between 2 and 10 iterations on float32 rounding, and a consumed
sweep's device time follows it, so a change in device time without a
change here is the program's doing. Moves the end-to-end metric of the
cell it is listed for (``sweeps_per_s``)."""

UNIT = "iters"


def read(ctx):
    lm = ctx["counters"]["lm"]
    if len(lm) == 0:
        return None
    return float(lm.mean())
