"""The program's tracer (``utils/timing.py``) on the CPU, where a stamp takes
the host clock, so that the whole bookkeeping runs under the tests.

(a) A LIO cold start through the step-graph runner (``StepGraphs("cpu")``)
    to two consumed INITED sweeps and a skipped one, a 4D builder step on
    each consumed INITED sweep, and four LOAM sweeps, with the tracer on:
    every span kind appears where it belongs, every span of a sweep shares
    its id, the calls' device stamps bracket their graphs, the consumed
    key has its ``front`` boundary, the LM bodies stamped in a consumed
    sweep are its ``solver_iterations`` - 1, the builder's ``map`` bodies
    are the iterations its GN ran, and captures and replays per key add
    up to ``stats``.
(b) The tracer alone: spans, stamps, the clock's line, tags, the
    ``lio.`` ranges of ``cli run --trace-dir``'s trace, ``StageTimer``,
    ``LIO_TRACE``; and with the tracer off nothing is built.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lio_mapping_tpu_torch.io import synthetic as TSYN
from lio_mapping_tpu_torch.models import estimator as TE
from lio_mapping_tpu_torch.models import map_builder as TMB
from lio_mapping_tpu_torch.models import pipeline as TPL
from lio_mapping_tpu_torch.models import step_graph as SG
from lio_mapping_tpu_torch.utils import timing as TM

from tests.test_torch_bootstrap_graphs import _boot_cfg, _runner, _sweep
from tests.test_torch_mapping import loam_cfg
from tests.test_torch_pipeline import port_cfg

F64 = torch.float64
N_CONSUMED = 2  # consumed INITED sweeps (each with a builder step)
N_LOAM = 4
SPAN_NAMES = ("process", "stage", "replay", "capture", "init", "outputs", "builder")
#: the span kinds each kind may lie in (-1: none)
PARENTS = {"process": {None}, "builder": {None}, "stage": {None, "process", "init"},
           "replay": {"process", "builder"}, "capture": {"process", "builder"},
           "init": {"process"}, "outputs": {"process", "builder"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CountingRun(TE.EagerRun):
    """The eager runner, counting the conditional bodies that ran."""

    def __init__(self):
        super().__init__()
        self.bodies = 0

    def when(self, v, stop, key, fn):
        if stop not in self._stopped and not bool(v[stop]):
            self.bodies += 1
        super().when(v, stop, key, fn)


def _builder_cfg(cfg):
    return dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, map_cloud_cap=4096, stack_cap=1024, max_iterations=4))


@pytest.fixture(scope="module")
def traced():
    """The runs of (a) under one tracer; returns (records, LIO outputs,
    pipelines and builders, the eager builder's body counts and poses,
    the traced builder's poses)."""
    assert TM.TRACER is None
    tr = TM.enable("cpu")
    try:
        cfg = _boot_cfg()
        traj = TSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
        pipe = _runner(TPL.LioPipeline(cfg, device="cpu", dtype=F64))
        bcfg = _builder_cfg(cfg)
        builder = _runner(TMB.MapBuilder(bcfg, "cpu", F64))
        state_e = TMB.init_state(bcfg, F64, torch.device("cpu"))
        outs, counts, poses_e, poses_g = [], [], [], []
        for i in range(40):
            xyz, mask, imu = _sweep(traj, i, cfg)
            samples = pipe.make_samples(*imu)
            if pipe.stage == "INITED" and pipe.will_consume():
                out = pipe.process(pipe.prefetch_cloud(xyz, mask), None, samples)
            else:
                out = pipe.process(xyz, mask, samples)
            outs.append(out)
            if out["stage"] == "INITED" and "corner_cloud" in out and not out.get("predicted"):
                poses_g.append(builder.step(out["corner_cloud"], out["surf_cloud"],
                                            out["laser_pose"])["pose"])
                run = CountingRun()
                v = {"map": state_e, "corner_cloud": out["corner_cloud"],
                     "surf_cloud": out["surf_cloud"], "odom_pose": out["laser_pose"]}
                state_e, o = TMB.map_builder_program(run, v, bcfg)
                counts.append(run.bodies)
                poses_e.append(o["pose"])
            consumed = [o for o in outs if "solver_iterations" in o and o["stage"] == "INITED"]
            if len(consumed) >= N_CONSUMED and outs[-1].get("predicted"):
                break
        loam = _runner(TPL.LoamPipeline(port_cfg(loam_cfg()), device="cpu", dtype=F64))
        ltraj = TSYN.Trajectory()
        for i in range(N_LOAM):
            loam.process(*TSYN.simulate_sweep(ltraj, 0.1 * i, n_azimuth=360))
        rec = tr.collect()
    finally:
        TM.disable()
    return rec, outs, {"pipe": pipe, "builder": builder, "loam": loam}, counts, poses_e, poses_g


def _spans(rec, name=None):
    sp = rec["spans"]
    idx = np.arange(len(sp["name"]))
    return idx if name is None else idx[sp["name"] == name]


def _top(rec, i):
    parent = rec["spans"]["parent"]
    while parent[i] >= 0:
        i = parent[i]
    return i


def _consumed_graphs(rec):
    """The graph runs of the consumed sweeps' step, in order."""
    return [g for g in TM.graph_instances(rec) if g["graph"].startswith("step.")]


# ---------------------------------------------------------------------------
# (a) the pipelines under the tracer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SPAN_NAMES)
def test_each_span_kind_appears_where_it_belongs(traced, name):
    rec = traced[0]
    sp = rec["spans"]
    idx = _spans(rec, name)
    assert len(idx) > 0, name
    for i in idx:
        p = sp["parent"][i]
        assert (None if p < 0 else sp["name"][p]) in PARENTS[name], (name, i)
        assert sp["start_ns"][i] <= sp["end_ns"][i]
        if p >= 0:
            assert sp["start_ns"][p] <= sp["start_ns"][i] <= sp["end_ns"][i] <= sp["end_ns"][p]


def test_process_kinds_and_sweep_ids(traced):
    rec = traced[0]
    sp = rec["spans"]
    proc = _spans(rec, "process")
    assert set(sp["note"][proc]) == {"boot", "consumed", "skipped", "loam"}
    lio = [i for i in proc if sp["note"][i] != "loam"]
    assert sp["sweep"][lio].tolist() == list(range(1, len(lio) + 1))
    # every span of a sweep shares its id: a nested span its call's, a
    # builder step the id of the sweep whose outputs it refined
    for i in _spans(rec):
        assert sp["sweep"][i] == sp["sweep"][_top(rec, i)]
    for b in _spans(rec, "builder"):
        before = [i for i in proc if sp["start_ns"][i] < sp["start_ns"][b]][-1]
        # (the sweep that reaches INITED is a bootstrap sweep with outputs)
        assert sp["note"][before] in ("boot", "consumed") and sp["sweep"][b] == sp["sweep"][before]


def test_every_call_brackets_its_device_work(traced):
    rec = traced[0]
    sp, st = rec["spans"], rec["stamps"]
    calls = np.concatenate([_spans(rec, "process"), _spans(rec, "builder")])
    for i in calls:
        assert sp["start_ns"][i] <= sp["dev_start_ns"][i] <= sp["dev_end_ns"][i] <= \
            sp["end_ns"][i]
        mine = st["ns"][st["span"] == i]
        assert ((mine >= sp["dev_start_ns"][i]) & (mine <= sp["dev_end_ns"][i])).all()
    # every graph stamp lies in a call, and each call holds one graph
    assert (st["span"] >= 0).all()
    runs = TM.graph_instances(rec)
    assert len(runs) == len(_spans(rec, "replay")) + len(_spans(rec, "capture"))
    assert sorted(g["span"] for g in runs) == sorted(calls.tolist())
    for g in runs:
        assert g["start"] <= g["end"]
        assert all(g["start"] <= ns <= g["end"] for _, _, ns in g["marks"])


def test_the_consumed_key_has_its_front_boundary(traced):
    rec = traced[0]
    tags = rec["tags"]
    keys = {g for g, s, e in zip(tags["graph"], tags["stage"], tags["edge"])
            if s == "front" and e == "at"}
    rows = next(k[1] for k in traced[2]["pipe"]._step_graphs._seen if k[0] == "step")
    assert f"step.{rows}.4" in keys
    parts = TM.device_parts(rec)[f"step.{rows}.4"]
    assert {"head->front", "front->gn.0", "lm.<body>", "lm.0->lm.<body>"} <= set(parts)


def test_lm_bodies_equal_solver_iterations_less_one(traced):
    rec, outs = traced[0], traced[1]
    sp = rec["spans"]
    iters = [int(o["solver_iterations"]) for o in outs if "solver_iterations" in o]
    graphs = _consumed_graphs(rec)
    assert len(graphs) == len(iters) >= N_CONSUMED
    for g, n in zip(graphs, iters):
        assert sp["note"][g["span"]] == "consumed"
        starts = [s for s, e, _ in g["marks"] if s.startswith("lm.") and e == "start"]
        ends = [s for s, e, _ in g["marks"] if s.startswith("lm.") and e == "end"]
        assert starts == ends == [f"lm.{k}" for k in range(1, n)]


def test_builder_bodies_equal_its_gn_iterations(traced):
    rec, _, _, counts, poses_e, poses_g = traced
    runs = [g for g in TM.graph_instances(rec) if g["graph"] == "map_builder"]
    assert len(runs) == len(counts) >= N_CONSUMED
    stamped = [sum(1 for s, e, _ in g["marks"] if s.startswith("map.") and e == "start"
                   and s != "map.head") for g in runs]
    assert stamped == counts and max(counts) > 0
    # the traced runner's steps are the untraced eager program's, bit for bit
    for a, b in zip(poses_g, poses_e):
        assert torch.equal(a.q, b.q) and torch.equal(a.t, b.t)


@pytest.mark.parametrize("runner", ["pipe", "builder", "loam"])
def test_captures_and_replays_per_key_add_up_to_stats(traced, runner):
    rec, runners = traced[0], traced[2]
    stats = runners[runner]._step_graphs.stats
    by_key = stats["by_key"]
    assert sum(c["captures"] for c in by_key.values()) == stats["captures"] > 0
    assert sum(c["replays"] for c in by_key.values()) == stats["replays"]
    assert stats["captures"] + stats["replays"] == stats["stretches"]
    assert all(c["capture_s"] > 0 for c in by_key.values())
    g = rec["graphs"]
    sp = rec["spans"]
    for key, c in by_key.items():
        row = list(g["key"]).index(key)
        assert g["captures"][row] >= c["captures"] and g["replays"][row] >= c["replays"]
        for what in ("capture", "replay"):
            n = int(np.sum((sp["name"] == what) & (sp["note"] == key)))
            assert n == g[what + "s"][row], (key, what)


def test_staged_bytes(traced):
    rec, _, runners = traced[0], traced[1], traced[2]
    sp = rec["spans"]
    stage = _spans(rec, "stage")
    m = runners["pipe"].cfg.estimator.imu.max_imu_per_frame
    imu = [int(sp["bytes"][i]) for i in stage if sp["note"][i] == "imu"]
    assert imu and set(imu) == {(m + 1) * 7 * 4}
    cloud = [int(sp["bytes"][i]) for i in stage if sp["note"][i] == "cloud"]
    assert min(cloud) == 0 < max(cloud)  # a prefetched cloud copies on the device
    prefetch = [i for i in stage if sp["parent"][i] < 0]
    assert prefetch and all(sp["bytes"][i] > 0 for i in prefetch)


def test_loam_graphs_carry_odometry_and_mapping_stamps(traced):
    rec = traced[0]
    parts = TM.device_parts(rec)
    mapped = next(k for k in parts if k.startswith("loam_map."))
    assoc = next(k for k in parts if k.startswith("loam_assoc."))
    assert {"odo.head->front", "odo.<body>", "map.<body>"} <= set(parts[mapped])
    assert "odo.<body>" in parts[assoc] and not any("map." in p for p in parts[assoc])


def test_report_reads_every_key(traced):
    rec = traced[0]
    text = TM.report(rec)
    for key in rec["graphs"]["key"]:
        assert key in text
    for line in ("host span", "process:consumed", "device (stamped)", "captures",
                 "staged to the device", "clock: 2 calibrations"):
        assert line in text


# ---------------------------------------------------------------------------
# (b) the tracer alone
# ---------------------------------------------------------------------------


@pytest.fixture
def tracer():
    tr = TM.enable("cpu")
    yield tr
    TM.disable()


def test_off_builds_nothing():
    assert TM.TRACER is None
    assert TM.span("stage", "cloud", 10) is TM.span("outputs")
    g = SG.StepGraphs("cpu")
    v = {"x": torch.ones(3)}
    g.stretch(("k",), lambda v: {"y": v["x"] + 1}, v)
    assert g.stats["by_key"] == {"k": {"captures": 1, "replays": 0,
                                       "capture_s": g.stats["by_key"]["k"]["capture_s"]}}
    assert TM.TRACER is None


def test_spans_nest_and_calls_take_their_stamps(tracer):
    with tracer.span("process", "consumed", sweep=7, device=True):
        with TM.span("stage", "imu", 28):
            pass
        tracer.stamp(TM.tag("g", "graph", "start"))
        tracer.stamp(TM.tag("g", "head"))
        tracer.stamp(TM.tag("g", "graph", "end"))
    with tracer.span("builder", device=True, nbytes=5):
        pass
    rec = tracer.collect()
    sp = rec["spans"]
    assert sp["name"].tolist() == ["process", "stage", "builder"]
    assert sp["parent"].tolist() == [-1, 0, -1]
    assert sp["sweep"].tolist() == [7, 7, 7]
    assert sp["bytes"].tolist() == [0, 28, 5]
    assert (sp["dev_start_ns"][[0, 2]] >= 0).all() and sp["dev_start_ns"][1] == -1
    assert rec["stamps"]["span"].tolist() == [0, 0, 0]
    (g,) = TM.graph_instances(rec)
    assert g["graph"] == "g" and [m[0] for m in g["marks"]] == ["head"]


def test_tags_are_fixed_per_name():
    a = TM.tag("graph.k", "lm.3", "start")
    assert TM.tag("graph.k", "lm.3", "start") == a
    assert TM.tag("graph.k", "lm.3", "end") != a != TM.tag("graph.k2", "lm.3", "start")
    assert TM.tag("", "calibration") == TM.CAL_TAG == 0


def test_the_clock_line(tracer):
    tracer._cal = [(1_000_000, 500_000, 10), (3_000_000, 2_500_000, 10)]
    np.testing.assert_array_equal(tracer.to_host_ns(np.array([500_000, 1_500_000])),
                                  [1_000_000, 2_000_000])
    assert tracer.drift_ppm() == 0.0
    tracer._cal[-1] = (3_002_000, 2_500_000, 10)
    assert tracer.drift_ppm() == pytest.approx(1000.0)
    assert tracer.to_host_ns(np.array([2_500_000]))[0] == 3_002_000


def test_spans_are_record_functions_in_the_cli_trace_only(tracer, tmp_path):
    """Inside ``device_trace`` (``cli run --trace-dir``) a span is a
    ``lio.<name>`` range of the Chrome trace; under another profiler it
    only notes that it was profiled."""
    import json

    from torch.profiler import ProfilerActivity, profile

    with TM.device_trace(str(tmp_path)):
        with TM.span("stage", "cloud"):
            torch.ones(4).sum()
    with open(tmp_path / "trace.json") as f:
        assert "lio.stage" in {e.get("name") for e in json.load(f)["traceEvents"]}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TM.span("replay", "k"):
            torch.ones(4).sum()
    with TM.span("outputs"):
        pass
    assert not any(e.name().startswith("lio.") for e in prof.profiler.kineto_results.events())
    assert tracer.collect()["spans"]["profiled"].tolist() == [True, True, False]


def test_stage_timer_is_a_span_when_on(tracer):
    timer = TM.StageTimer()
    with timer.stage("pipeline"):
        with TM.span("stage", "imu"):
            pass
    rec = tracer.collect()
    assert rec["spans"]["name"].tolist() == ["pipeline", "stage"]
    assert rec["spans"]["parent"].tolist() == [-1, 0]
    assert timer.summary()["pipeline"]["count"] == 1


@pytest.mark.parametrize("value,on", [("1", True), ("0", False), (None, False)])
def test_lio_trace_switches_the_tracer_on_when_the_program_is_built(value, on):
    env = {k: v for k, v in os.environ.items() if k != "LIO_TRACE"}
    if value is not None:
        env["LIO_TRACE"] = value
    code = ("from lio_mapping_tpu_torch.config import LioConfig\n"
            "from lio_mapping_tpu_torch.models.pipeline import LioPipeline\n"
            "from lio_mapping_tpu_torch.utils import timing as TM\n"
            "assert TM.TRACER is None\n"
            "LioPipeline(LioConfig.indoor(), device='cpu')\n"
            "print(TM.TRACER is not None and not TM.TRACER.on_card)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(env, CUDA_VISIBLE_DEVICES=""), timeout=300,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(on)
