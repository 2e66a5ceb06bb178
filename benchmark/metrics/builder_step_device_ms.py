"""Device milliseconds of one 4D builder step (``MapBuilder.step``: its
CUDA graph, the scan-to-map GN led by the corner 5-NN on the plain
search), mean over the window's steps, from the profiler's trace. Moves
``sweeps_per_s``."""

UNIT = "ms"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.empty:
        return None
    ms = [m for m in tr.span_device_ms("builder.step") if m > 0]
    return sum(ms) / len(ms) if ms else None
