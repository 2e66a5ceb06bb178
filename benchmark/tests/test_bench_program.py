"""The readers of the program's own tracer (``harness/program.py`` and the
six ``metrics/`` files that use it) on the CPU: their values on records
made to measure, on records of the program's real tracer, None where the
run has no tracer, and a ``--trace 0`` run that builds none."""

import numpy as np
import pytest

from bench_stub import tiny_cell
from harness import program as PG
from harness import traced
from harness.cell import run_cell
from harness.spec import metric_reader

MS = 1_000_000  # ns
READERS = ["front_end_device_ms", "step_device_ms", "lm_iteration_device_ms",
           "builder_gn_iterations", "builder_gn_iteration_device_ms",
           "device_idle_ms_per_sweep"]


class Records:
    """Records in the tracer's layout, made sweep by sweep."""

    def __init__(self):
        self.spans = {k: [] for k in ("name", "note", "start_ns", "end_ns", "parent", "sweep",
                                      "bytes", "profiled", "dev_start_ns", "dev_end_ns")}
        self.stamps = {"tag": [], "ns": [], "span": []}
        self.table = [("", "calibration", "at")]

    def tag(self, graph, stage, edge="at"):
        if (graph, stage, edge) not in self.table:
            self.table.append((graph, stage, edge))
        return self.table.index((graph, stage, edge))

    def span(self, name, note, t0, t1, dev, sweep, profiled, parent=-1):
        i = len(self.spans["name"])
        for k, v in zip(self.spans, (name, note, t0, t1, parent, sweep, 0, profiled,
                                     dev[0] if dev else -1, dev[1] if dev else -1)):
            self.spans[k].append(v)
        return i

    def graph(self, span, key, marks):
        for stage, edge, ns in marks:
            self.stamps["tag"].append(self.tag(key, stage, edge))
            self.stamps["ns"].append(ns)
            self.stamps["span"].append(span)

    def build(self) -> dict:
        sp = {k: np.asarray(v, dtype=object if k in ("name", "note") else
                            bool if k == "profiled" else np.int64)
              for k, v in self.spans.items()}
        st = {k: np.asarray(v, np.int64) for k, v in self.stamps.items()}
        return {"spans": sp, "stamps": st,
                "tags": {k: np.asarray([t[j] for t in self.table], dtype=object)
                         for j, k in enumerate(("graph", "stage", "edge"))},
                "graphs": {"key": np.asarray(["map_builder"], dtype=object),
                           "captures": np.asarray([1]), "replays": np.asarray([9]),
                           "capture_s": np.asarray([0.5])},
                "bodies": {"graph": np.asarray(["map_builder"] * 2, dtype=object),
                           "body": np.asarray(["map.0", "map.1"], dtype=object),
                           "runs": np.asarray([10, 8])},
                "clock": {"calibrations": np.asarray([[0, 0, 9000], [1, 1, 8000]]),
                          "drift_ppm": 0.5, "lost": 0, "on_card": True}}


def made(n_setup=3, n_window=6, n_traced=2):
    """Sweeps 25 ms apart; an odd sweep consumed: its graph (front 2 ms,
    step 6 ms, two LM bodies of 1 ms) and a builder step (two GN bodies of
    3 ms); an even one skipped (1 ms). Returns (records, the window's
    busy device ms)."""
    r = Records()
    busy = 0.0
    for k in range(n_setup + n_window + n_traced):
        t = 100 * MS + 25 * MS * k
        sweep, prof, win = k + 1, k >= n_setup + n_window, n_setup <= k < n_setup + n_window
        if sweep % 2:
            p = r.span("process", "consumed", t, t + MS, (t + MS // 2, t + 8_700_000), sweep, prof)
            r.span("replay", "step.9216.4", t + MS // 4, t + MS // 2, None, sweep, prof, p)
            r.graph(p, "step.9216.4", [
                ("graph", "start", t + 600_000), ("head", "at", t + 600_100),
                ("front", "at", t + 2_600_000), ("lm.0", "at", t + 4_000_000),
                ("lm.1", "start", t + 5 * MS), ("lm.1", "end", t + 6 * MS),
                ("lm.2", "start", t + 6_100_000), ("lm.2", "end", t + 7_100_000),
                ("tail", "at", t + 7_200_000), ("graph", "end", t + 8_600_000)])
            b = r.span("builder", "", t + 1_100_000, t + 1_500_000,
                       (t + 8_800_000, t + 20_800_000), sweep, prof)
            r.graph(b, "map_builder", [
                ("graph", "start", t + 8_900_000), ("map.head", "at", t + 8_950_000),
                ("map.0", "start", t + 9 * MS), ("map.0", "end", t + 12 * MS),
                ("map.1", "start", t + 12 * MS), ("map.1", "end", t + 15 * MS),
                ("map.tail", "at", t + 15_100_000), ("graph", "end", t + 20_700_000)])
            busy += 8.2 + 12.0 if win else 0.0
        else:
            p = r.span("process", "skipped", t, t + MS, (t + MS // 2, t + 1_500_000), sweep,
                       prof)
            r.graph(p, "predict", [("graph", "start", t + 600_000),
                                   ("graph", "end", t + 1_400_000)])
            busy += 1.0 if win else 0.0
    return r.build(), busy


def ctx_for(rec=None, n=6, trace=None):
    logged = []
    ctx = {"sweeps": [None] * n, "log": logged.append, "trace": trace}
    if rec is not None:
        ctx["program"] = PG.window(rec, n)
    return ctx, logged


def test_window_reads_the_made_records():
    rec, busy = made()
    w = PG.window(rec, 6)
    assert w["sweeps"] == 6 and w["calls"] == 9 and w["graphs"] == 9
    np.testing.assert_allclose(w["front_ms"], [2.0] * 3)
    np.testing.assert_allclose(w["step_ms"], [6.0] * 3)
    np.testing.assert_allclose(w["lm_body_ms"], [1.0] * 6)
    assert w["builder_bodies"] == [2, 2, 2]
    np.testing.assert_allclose(w["builder_body_ms"], [3.0] * 6)
    # from the first window sweep's call (sweep 4, skipped) to the last
    # stamp (sweep 9's builder): 5 x 25 ms + 20.8 ms
    np.testing.assert_allclose(w["window_ms"], 5 * 25 + 20.8)
    np.testing.assert_allclose(w["busy_ms"], busy)
    np.testing.assert_allclose(w["idle_ms_per_sweep"], (5 * 25 + 20.8 - busy) / 6)
    assert len(w["idle_gaps"]) == 9
    # the longest gap (skipped sweep 4's device end to sweep 5's start) is
    # outside every span; the host was in sweep 5's call for its last part
    assert w["idle_gaps"][0][0] == "outside_program"
    assert w["idle_gaps"][0][1] == pytest.approx(25 - 1.5 + 0.5)


@pytest.mark.parametrize("name,value", [
    ("front_end_device_ms", 2.0), ("step_device_ms", 6.0), ("lm_iteration_device_ms", 1.0),
    ("builder_gn_iterations", 2.0), ("builder_gn_iteration_device_ms", 3.0)])
def test_each_reader_gives_its_value(name, value):
    rec, _ = made()
    ctx, _ = ctx_for(rec)
    assert metric_reader(name).read(ctx) == pytest.approx(value)


def test_idle_reader_gives_its_value():
    rec, busy = made()
    ctx, _ = ctx_for(rec)
    got = metric_reader("device_idle_ms_per_sweep").read(ctx)
    assert got == pytest.approx((5 * 25 + 20.8 - busy) / 6)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_none_without_the_program(name):
    from lio_mapping_tpu_torch.utils import timing as TM

    assert TM.TRACER is None
    ctx, _ = ctx_for()
    assert metric_reader(name).read(ctx) is None
    assert ctx["program"] is None


def test_too_few_sweeps_read_nothing():
    rec, _ = made(n_setup=0, n_window=2, n_traced=0)
    assert PG.window(rec, 3) is None and PG.window(rec, 0) is None


def test_the_summary_lines():
    rec, _ = made()
    w = PG.window(rec, 6)
    lines = PG.summary(rec, w)
    assert lines[0].startswith("program tracer: 2 calibrations, drift 0.5000 ppm")
    assert "front 2.0000 ms, step 6.0000 ms (3 consumed)" in lines[1]
    assert "head 0.1000 + bodies 6.0000 (2.0000 x 3.0000 ms) + tail 5.6000" in lines[2]
    assert "18 bodies in 9 replays" in lines[2]
    assert lines[3].startswith("program idle gaps: outside_program")
    assert len(lines) == 4


def test_the_traced_part_line():
    """With a trace, the traced part's stamped graphs beside the
    profiler's device time of the same sweeps."""
    class Trace:
        empty = False

        @staticmethod
        def span_device_ms(kind):
            return {"sweep.consumed": [7.5, 0.0], "builder.step": [11.0]}[kind]

    rec, _ = made()
    lines = PG.summary(rec, PG.window(rec, 6), Trace())
    assert lines[4] == ("program traced part: consumed graph stamped 8.0000 ms (1), the "
                        "profiler's consumed sweep 7.5000 ms (1); builder graph stamped "
                        "11.8000 ms (1), the profiler's 11.0000 ms (1)")


def test_the_program_tracer_records_read_alike():
    """The program's own tracer on the CPU (stamps on the host clock) in
    the layout ``window`` reads."""
    from lio_mapping_tpu_torch.utils import timing as TM

    tr = TM.enable("cpu")
    try:
        for sweep in (1, 2, 3):
            with tr.span("process", "consumed", sweep=sweep, device=True):
                for stage, edge in (("graph", "start"), ("head", "at"), ("front", "at"),
                                    ("lm.1", "start"), ("lm.1", "end"), ("graph", "end")):
                    tr.stamp(TM.tag("step.64.4", stage, edge))
            with tr.span("builder", device=True):
                for stage, edge in (("graph", "start"), ("map.head", "at"), ("map.0", "start"),
                                    ("map.0", "end"), ("map.tail", "at"), ("graph", "end")):
                    tr.stamp(TM.tag("map_builder", stage, edge))
        ctx = {"sweeps": [None] * 2, "log": lambda line: None, "trace": None}
        w = PG.records(ctx)
    finally:
        TM.disable()
    assert w is ctx["program"] and w["sweeps"] == 2 and w["calls"] == 4
    assert len(w["front_ms"]) == len(w["step_ms"]) == len(w["lm_body_ms"]) == 2
    assert w["builder_bodies"] == [1, 1] and w["idle_ms_per_sweep"] >= 0
    for name in READERS:
        assert metric_reader(name).read(ctx) is not None


@pytest.mark.parametrize("trace", [False, True])
def test_a_stub_run_builds_no_tracer(trace):
    from lio_mapping_tpu_torch.utils import timing as TM

    cell, make, _ = tiny_cell("indoor-4d-replay")
    out = run_cell(cell, 2 ** 31 + 7, 2.0, trace, "cpu", make_system=make, log=lambda m: None)
    assert TM.TRACER is None
    assert not set(READERS) & set(out["metrics"])


@pytest.mark.parametrize("argv,on", [
    (["--workload", "c", "--seed", "1", "--seconds", "5", "--trace", "1"], True),
    (["--workload", "c", "--trace=1"], True), (["--trace", "0"], False),
    (["--workload", "c"], False), (["--trace"], False)])
def test_the_switch_reads_the_trace_flag(argv, on):
    assert traced(argv) is on
