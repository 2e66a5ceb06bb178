"""What a ``--trace 1`` run reads from the program's own tracer
(``lio_mapping_tpu_torch/utils/timing.py``, switched on by
``harness/__init__.py``), kept in memory and never written out.

The tracer records host spans (``process`` around each call of
``LioPipeline.process``, ``builder`` around each ``MapBuilder.step``, and
inside them ``stage``, ``replay``, ``capture``, ``init``, ``outputs``) and
device stamps: one launched from the host before each such call's device
work (the call's device interval runs from it to the call's last stamp),
and inside each CUDA graph its start and end, each stretch's start, the
pipeline's ``front`` boundary (the front end's end) and the start and end
of each conditional body that ran. Device times are on the host's clock
(the tracer's calibration).

:func:`records` collects the tracer once a run (``ctx["program"]``) and
keeps the untraced part of the window: the last ``len(ctx["sweeps"])``
``process`` spans made outside the profiler, and the ``builder`` spans of
their sweeps. From it:

* ``front_ms`` / ``step_ms``: each consumed sweep's graph, from its start
  to the ``front`` stamp, and from there to its end;
* ``lm_body_ms``: each window-LM body (``lm.<k>``) that ran, start to end;
* ``builder_bodies`` / ``builder_body_ms``: each builder step's GN bodies
  (``map.<k>``) that ran, and each one's start to end;
* ``idle_ms_per_sweep``: the window (the first sweep's call to the last
  stamp) less the union of the calls' device intervals, over the sweeps;
  and the ten longest idle gaps, each named by the program span the host
  spent most of it in, or ``outside_program``.

Returns None where the program has no tracer, or the run made no such
spans (a ``--trace 0`` run, a program that predates the tracer).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

BODY = re.compile(r"^(\w+)\.(\d+)$")


def records(ctx) -> Optional[dict]:
    """The window's part of the tracer's records (see the module
    docstring), collected at the first call of a run."""
    if "program" not in ctx:
        ctx["program"] = _collect(ctx)
    return ctx["program"]


def _collect(ctx) -> Optional[dict]:
    try:
        from lio_mapping_tpu_torch.utils import timing
    except ImportError:
        return None
    tr = getattr(timing, "TRACER", None)
    if tr is None or not hasattr(tr, "collect"):
        return None
    rec = tr.collect()
    out = window(rec, len(ctx["sweeps"]))
    if out is not None:
        for line in summary(rec, out, ctx.get("trace")):
            ctx["log"](line)
    return out


def _overlap(a0, a1, b0, b1):
    return np.clip(np.minimum(a1, b1) - np.maximum(a0, b0), 0, None)


def window(rec: dict, n: int) -> Optional[dict]:
    """The records of the last ``n`` unprofiled ``process`` calls and the
    builder steps of their sweeps (see the module docstring)."""
    sp = rec["spans"]
    name, prof = sp["name"], sp["profiled"]
    proc = np.flatnonzero((name == "process") & ~prof)
    if n <= 0 or len(proc) < n:
        return None
    win = proc[-n:]
    sweeps = sp["sweep"][win]
    build = np.flatnonzero((name == "builder") & ~prof & (sp["parent"] == -1)
                           & np.isin(sp["sweep"], sweeps))
    calls = np.union1d(win, build)
    consumed = set(win[sp["note"][win] == "consumed"].tolist())
    builders = set(build.tolist())

    # the graphs that ran inside the window's calls
    tg, st = rec["tags"], rec["stamps"]
    keep = np.isin(st["span"], calls)
    out = {"sweeps": n, "calls": len(calls), "front_ms": [], "step_ms": [], "lm_body_ms": [],
           "builder_bodies": [], "builder_body_ms": [], "builder_parts": [], "graphs": 0}
    cur = None
    for t, ns, span in zip(st["tag"][keep].tolist(), st["ns"][keep].tolist(),
                           st["span"][keep].tolist()):
        g, stage, edge = tg["graph"][t], tg["stage"][t], tg["edge"][t]
        if stage == "graph" and edge == "start":
            cur = {"graph": g, "span": span, "start": ns, "marks": []}
        elif cur is not None and cur["graph"] == g and cur["span"] == span:
            if stage == "graph":
                out["graphs"] += 1
                _graph(out, cur, ns, span in consumed, span in builders)
                cur = None
            else:
                cur["marks"].append((stage, edge, ns))

    # the device's idle time over the window
    t0 = int(sp["start_ns"][win[0]])
    d0, d1 = sp["dev_start_ns"][calls], sp["dev_end_ns"][calls]
    ok = (d0 >= 0) & (d1 >= d0)
    if not ok.any():
        return None
    t1 = int(max(d1[ok].max(), sp["end_ns"][calls].max()))
    merged = []
    for a, b in sorted(zip(np.maximum(d0[ok], t0).tolist(), d1[ok].tolist())):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)[:10]
    out["window_ms"] = (t1 - t0) / 1e6
    out["busy_ms"] = busy / 1e6
    out["idle_ms_per_sweep"] = (t1 - t0 - busy) / 1e6 / n
    out["idle_gaps"] = [[_host_in(sp, a, a + g), g / 1e6] for g, a in gaps]
    return out


def _graph(out: dict, g: dict, end: int, consumed: bool, builder: bool):
    """One graph run's stamps into the window's lists."""
    marks = g["marks"]
    bodies, open_ = [], {}
    for stage, edge, ns in marks:
        if BODY.match(stage) and edge in ("start", "end"):
            if edge == "start":
                open_[stage] = ns
            elif stage in open_:
                bodies.append((stage, open_.pop(stage), ns))
    if consumed and g["graph"].startswith("step."):
        front = [ns for stage, edge, ns in marks if stage == "front"]
        if front:
            out["front_ms"].append((front[0] - g["start"]) / 1e6)
            out["step_ms"].append((end - front[0]) / 1e6)
        out["lm_body_ms"] += [(b - a) / 1e6 for s, a, b in bodies if s.startswith("lm.")]
    if builder and g["graph"] == "map_builder":
        gn = [(a, b) for s, a, b in bodies if s.startswith("map.")]
        out["builder_bodies"].append(len(gn))
        out["builder_body_ms"] += [(b - a) / 1e6 for a, b in gn]
        tail = [ns for stage, edge, ns in marks if stage == "map.tail"]
        first = gn[0][0] if gn else (tail[0] if tail else end)
        out["builder_parts"].append({
            "graph": (end - g["start"]) / 1e6, "head": (first - g["start"]) / 1e6,
            "tail": (end - tail[0]) / 1e6 if tail else 0.0,
            "bodies": sum(b - a for a, b in gn) / 1e6})


def _host_in(sp: dict, a: int, b: int) -> str:
    """The program span the host spent most of [a, b] in (the innermost of
    equals), or ``outside_program`` where it spent most of it outside every
    span."""
    s0, s1 = sp["start_ns"], sp["end_ns"]
    ov = _overlap(s0, s1, a, b)
    top = sp["parent"] == -1
    outside = (b - a) - int(ov[top].sum())
    i = int(np.lexsort((s1 - s0, -ov))[0]) if len(ov) else -1
    if i < 0 or ov[i] <= 0 or outside >= ov[i]:
        return "outside_program"
    note = sp["note"][i]
    return f"{sp['name'][i]}:{note}" if note else str(sp["name"][i])


def _mean(xs) -> float:
    return float(np.mean(xs)) if len(xs) else float("nan")


def summary(rec: dict, w: dict, trace=None) -> list:
    """The run log's lines of the tracer: the clock, the window's numbers,
    the builder's parts against its bodies, the ten longest idle gaps, and
    in the traced part the stamped graphs against the profiler's device
    time of the same sweeps."""
    clock = rec["clock"]
    cal = clock["calibrations"]
    lines = [f"program tracer: {len(cal)} calibrations, drift {clock['drift_ppm']:.4f} ppm "
             f"between the first and the last, brackets {cal[:, 2].tolist()} ns, "
             f"stamps lost {clock['lost']}"]
    lines.append(
        f"program window: {w['sweeps']} sweeps, {w['calls']} calls, {w['graphs']} graphs; "
        f"window {w['window_ms']:.4f} ms, busy {w['busy_ms']:.4f} ms, idle "
        f"{w['idle_ms_per_sweep']:.4f} ms a sweep; front {_mean(w['front_ms']):.4f} ms, step "
        f"{_mean(w['step_ms']):.4f} ms ({len(w['front_ms'])} consumed); lm bodies "
        f"{len(w['lm_body_ms'])}, {_mean(w['lm_body_ms']):.4f} ms each")
    parts = w["builder_parts"]
    if parts:
        b = rec["bodies"]
        runs = b["runs"][b["graph"] == "map_builder"]
        replays = rec["graphs"]["replays"][rec["graphs"]["key"] == "map_builder"]
        lines.append(
            "program builder: graph {:.4f} ms = head {:.4f} + bodies {:.4f} ({:.4f} x {:.4f} ms)"
            " + tail {:.4f} + the rest; device counters over the run: {} bodies in {} "
            "replays".format(_mean([p["graph"] for p in parts]),
                             _mean([p["head"] for p in parts]),
                             _mean([p["bodies"] for p in parts]),
                             _mean(w["builder_bodies"]), _mean(w["builder_body_ms"]),
                             _mean([p["tail"] for p in parts]), int(runs.sum()),
                             int(replays.sum()) if len(replays) else 0))
    lines.append("program idle gaps: " + "; ".join(
        f"{name} {ms:.4f} ms" for name, ms in w["idle_gaps"]))
    if trace is not None and not getattr(trace, "empty", True):
        sp = rec["spans"]
        cons = np.flatnonzero((sp["name"] == "process") & sp["profiled"]
                              & (sp["note"] == "consumed"))
        build = np.flatnonzero((sp["name"] == "builder") & sp["profiled"])
        step, builder = _graph_ms(rec, cons, "step."), _graph_ms(rec, build, "map_builder")
        kernels = [m for m in trace.span_device_ms("sweep.consumed") if m > 0]
        b_kernels = [m for m in trace.span_device_ms("builder.step") if m > 0]
        lines.append(f"program traced part: consumed graph stamped {_mean(step):.4f} ms "
                     f"({len(step)}), the profiler's consumed sweep {_mean(kernels):.4f} ms "
                     f"({len(kernels)}); builder graph stamped {_mean(builder):.4f} ms "
                     f"({len(builder)}), the profiler's {_mean(b_kernels):.4f} ms "
                     f"({len(b_kernels)})")
    return lines


def _graph_ms(rec: dict, calls, prefix: str) -> list:
    """Start to end of each graph whose name starts with ``prefix`` run
    in ``calls``, in ms."""
    tg, st = rec["tags"], rec["stamps"]
    keep = np.isin(st["span"], calls)
    out, start = [], None
    for t, ns in zip(st["tag"][keep].tolist(), st["ns"][keep].tolist()):
        if tg["stage"][t] == "graph" and tg["graph"][t].startswith(prefix):
            if tg["edge"][t] == "start":
                start = ns
            elif start is not None:
                out.append((ns - start) / 1e6)
                start = None
    return out
