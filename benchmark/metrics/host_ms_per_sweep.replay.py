"""Host milliseconds a sweep of a LIO replay spends in the harness's calls
into the program (``LioPipeline.process``, and ``MapBuilder.step`` where the
mix runs the builder), mean over the untraced part of the window, by the
host clock. Where it nears the device's milliseconds a sweep, the host
sets the replay's pace. Moves ``sweeps_per_s``."""

UNIT = "ms"


def read(ctx):
    recs = ctx["sweeps"]
    if ctx["arrival"] != "replay" or ctx["mode"] == "loam" or not recs:
        return None
    return 1e3 * sum(r.host_s for r in recs) / len(recs)
