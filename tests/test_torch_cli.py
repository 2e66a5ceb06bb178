"""The port's CLI (``python -m lio_mapping_tpu_torch.cli``) against the
reference's (``lio_mapping_tpu.cli``), on the CPU.

* ``simulate`` writes the same ``.liol`` and ground-truth TUM, byte for byte;
  ``evaluate`` prints the same lines.
* The host loop of ``run`` (measurement queue, 4096-row padding, boundary
  interpolation, prefetch gating) hands the pipeline the same sweeps, masks
  and packed IMU buffers, bit for bit, and with ``--enable-4d`` the 4D map
  builder the same clouds and poses on the same sweeps: recording stubs
  stand in for each package's pipeline and builder step, so no JAX
  program runs.
* ``run --device cpu`` over a short log with the reference's small YAML
  profile (``tests/test_cli_e2e.SMALL_PROFILE``, plus the every-sweep
  cadence and the narrow feature capacities of
  ``tests/test_torch_pipeline.cold_cfg`` to keep it to seconds) reaches
  INITED, and ``--two-phase`` reproduces it under the reference's own
  thresholds (``tests/test_cli_e2e.py:225-246``), with and without
  ``--self-filter``: the latter holds the fix of the init-sweep backfill.
* ``run --mesh 2 --device cpu`` (2 spawned ranks over gloo, plain and with
  ``--map-shard --ingest-shard``) ends in the same stage as the single
  process, with ATE within 0.05 m of it (a closed loop is compared by ATE:
  the sums over the ranks move float64 near-ties), bit-identical states on
  both ranks and the collectives counted in ``--stats-json``;
  ``--two-phase`` hands ``--mesh``, ``--map-shard`` and ``--ingest-shard``
  to both phases; ``check_caps`` refuses a mesh with the reference's error.
* A resumed run (``--skip-pairs``) copies none of the skipped pairs' clouds
  to the device (the fourth item of ``ADVICE.md``, fixed in the port only).
* Flag validation, and no silent fall back to the CPU.
"""

import copy
import json
import os
import re

import numpy as np
import pytest
import torch
import yaml

from lio_mapping_tpu import cli as JCLI
from lio_mapping_tpu_torch import cli as TCLI
from lio_mapping_tpu_torch.io.evaluation import load_tum

from tests.test_cli_e2e import SMALL_PROFILE

N_SWEEPS = 14  # INITED on the twelfth pair at this profile with --self-filter
N_SHORT = 10   # INITED on the sixth pair without it: the plain runs take the shorter log


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The runs here are thousands of small ops, which gain nothing from
    intra-op threads: one thread each, in this process and in the
    ``--two-phase`` subprocesses, keeps them from oversubscribing the cores
    when the suite runs on several workers."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _profile_yaml(path):
    prof = copy.deepcopy(SMALL_PROFILE)
    prof["estimator"]["odom_io"] = 1
    prof["feature"] = {"corner_sharp_cap": 128, "corner_less_sharp_cap": 1024,
                       "surf_flat_cap": 256, "surf_less_flat_cap": 2048}
    with open(path, "w") as f:
        yaml.safe_dump(prof, f)
    return str(path)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    log, short, gt = str(d / "seq.liol"), str(d / "short.liol"), str(d / "gt.tum")
    assert TCLI.main(["simulate", "--out", log, "--sweeps", str(N_SWEEPS), "--azimuth", "300",
                      "--gt-out", gt]) == 0
    assert TCLI.main(["simulate", "--out", short, "--sweeps", str(N_SHORT),
                      "--azimuth", "300"]) == 0
    return {"dir": d, "log": log, "short": short, "gt": gt,
            "cfg": _profile_yaml(d / "small.yaml")}


def test_simulate_writes_the_reference_files(tmp_path, capsys):
    args = ["--sweeps", "4", "--azimuth", "300"]
    assert TCLI.main(["simulate", "--out", str(tmp_path / "p.liol"),
                      "--gt-out", str(tmp_path / "p.tum")] + args) == 0
    assert JCLI.main(["simulate", "--out", str(tmp_path / "r.liol"),
                      "--gt-out", str(tmp_path / "r.tum")] + args) == 0
    assert (tmp_path / "p.liol").read_bytes() == (tmp_path / "r.liol").read_bytes()
    assert (tmp_path / "p.tum").read_bytes() == (tmp_path / "r.tum").read_bytes()


def test_evaluate_prints_the_reference_lines(seq, tmp_path, capsys):
    t, q, p = load_tum(seq["gt"])
    rng = np.random.default_rng(0)
    est = str(tmp_path / "est.tum")
    from lio_mapping_tpu_torch.io.evaluation import save_tum

    save_tum(est, t[2:] + 1e-3, q[2:], p[2:] + rng.normal(0, 0.05, p[2:].shape))
    assert TCLI.main(["evaluate", "--est", est, "--gt", seq["gt"]]) == 0
    port = capsys.readouterr().out
    assert JCLI.main(["evaluate", "--est", est, "--gt", seq["gt"]]) == 0
    assert port == capsys.readouterr().out
    assert "ATE RMSE" in port


class _Pose:
    def __init__(self, i):
        self.q = np.array([1.0, 0.0, 0.0, 0.0])
        self.t = np.array([0.01 * i, 0.0, 0.0])


def _stub(real, record):
    """Records what the host loop hands the pipeline; keeps the real
    ``make_samples``, ``will_consume`` and cadence. Goes INITED on the 4th
    sweep so that the prefetch gating skips sweeps after it."""

    class Stub:
        make_samples = real.make_samples
        will_consume = real.will_consume
        _is_compact = real._is_compact

        def __init__(self, cfg, *args, **kwargs):
            self.cfg = cfg
            self.stage = "NOT_INITED"
            self.frame_count = 0
            self._io_ratio = max(1, cfg.estimator.odom_io)

        def prefetch_cloud(self, xyz, mask, ring=None):
            return ("prefetched", np.array(xyz), np.array(mask))

        def process(self, xyz, mask, samples=None, ring_ids=None):
            pf = isinstance(xyz, tuple)
            if pf:
                _, xyz, mask = xyz
            record.append((pf, np.array(xyz), np.array(mask),
                           None if samples is None else np.array(samples)))
            self.frame_count += 1
            if self.frame_count == 4:
                self.stage = "INITED"
            out = {"stage": self.stage, "laser_pose": _Pose(self.frame_count),
                   "corner_cloud": ("corner", self.frame_count),
                   "surf_cloud": ("surf", self.frame_count)}
            if self.stage == "INITED" and not self._is_compact(self.frame_count):
                out["predicted"] = True
            return out

    return Stub


def _builder_stub(record):
    """Records what the host loop hands the 4D builder step; returns the
    odometry pose moved by 1 cm as the refined one."""
    def step(state, corner_cloud, surf_cloud, odom_pose, cfg):
        record.append((corner_cloud, surf_cloud, np.array(odom_pose.t)))
        refined = _Pose(0)
        refined.t = np.array(odom_pose.t) + 0.01
        return state, {"pose": refined}
    return step


@pytest.mark.parametrize("mode,self_filter,four_d",
                         [("lio", False, False), ("loam", False, False), ("lio", True, False),
                          ("lio", False, True)],
                         ids=["lio", "loam", "lio-self-filter", "lio-4d"])
def test_run_host_loop_feeds_the_same_inputs(seq, tmp_path, monkeypatch, capsys, mode,
                                             self_filter, four_d):
    from lio_mapping_tpu.models import map_builder as JMB
    from lio_mapping_tpu.models import pipeline as JPL
    from lio_mapping_tpu_torch.models import map_builder as TMB
    from lio_mapping_tpu_torch.models import pipeline as TPL

    rec_j, rec_t = [], []
    mb_j, mb_t = [], []
    name = "LioPipeline" if mode == "lio" else "LoamPipeline"
    monkeypatch.setattr(JPL, name, _stub(JPL.LioPipeline, rec_j))
    monkeypatch.setattr(TPL, name, _stub(TPL.LioPipeline, rec_t))
    monkeypatch.setattr(JMB, "map_builder_step", _builder_stub(mb_j))
    monkeypatch.setattr(TMB, "map_builder_step", _builder_stub(mb_t))
    common = ["run", "--log", seq["log"], "--profile", "indoor", "--mode", mode]
    if self_filter:
        common.append("--self-filter")
    extra_j = extra_t = []
    if four_d:
        extra_j = ["--enable-4d", "--out-4d", str(tmp_path / "r4.tum")]
        extra_t = ["--enable-4d", "--out-4d", str(tmp_path / "p4.tum")]
    assert JCLI.main(common + ["--out", str(tmp_path / "r.tum")] + extra_j) == 0
    ref_out = capsys.readouterr().out
    assert TCLI.main(common + ["--out", str(tmp_path / "p.tum"), "--device", "cpu"]
                     + extra_t) == 0
    port_out = capsys.readouterr().out
    assert (tmp_path / "r.tum").read_bytes() == (tmp_path / "p.tum").read_bytes()
    if four_d:
        # the builder runs on the INITED sweeps the estimator consumed, with
        # their clouds and newest laser pose, and its poses are written
        assert len(mb_t) == len(mb_j)
        assert [(c, s) for c, s, _ in mb_t] == [(c, s) for c, s, _ in mb_j]
        for (_, _, a), (_, _, b) in zip(mb_t, mb_j):
            np.testing.assert_array_equal(a, b)
        assert [c[1] for c, _, _ in mb_t] == [5, 7, 9, 11, 13]
        assert (tmp_path / "r4.tum").read_bytes() == (tmp_path / "p4.tum").read_bytes()
        assert "wrote 5 4D-refined poses" in port_out and "wrote 5 4D-refined poses" in ref_out
    else:
        assert not mb_t and not mb_j

    assert len(rec_t) == len(rec_j) == N_SWEEPS - 1
    for i, (a, b) in enumerate(zip(rec_t, rec_j)):
        assert a[0] == b[0], i  # prefetched alike
        np.testing.assert_array_equal(a[1], b[1])
        assert a[1].dtype == b[1].dtype and len(a[1]) % TCLI.PAD_Q == 0
        np.testing.assert_array_equal(a[2], b[2])
        if mode == "loam":
            assert a[3] is None and b[3] is None
        else:
            assert a[3].dtype == b[3].dtype
            np.testing.assert_array_equal(a[3], b[3])
    if self_filter:
        # the crop edits the mask on the host, so nothing is prefetched, and
        # it removes points of every sweep
        assert not any(r[0] for r in rec_t)
        assert all(r[2].sum() < len(_log_sweep(seq["log"], i)) for i, r in enumerate(rec_t))
    elif mode == "lio":
        # indoor cadence (odom_io 2): some sweeps after INITED go without prefetch
        assert [r[0] for r in rec_t].count(False) >= 2 and rec_t[0][0]


def _log_sweep(path, i):
    from lio_mapping_tpu_torch import native

    return [x for x in native.SequenceLog(path) if x[0] == "sweep"][i][2]


def _run(seq, log, out, *extra):
    return TCLI.main(["run", "--log", seq[log], "--config", seq["cfg"], "--device", "cpu",
                      "--out", str(seq["dir"] / out)] + list(extra))


def _n_voxels(path):
    with open(path, "rb") as f:
        head = f.read(300).decode("ascii", "ignore")
    return int(re.search(r"POINTS (\d+)", head).group(1))


@pytest.fixture(scope="module")
def single(seq):
    """One port run on the CPU: its stdout and outputs, without the
    self-filter on the short log and with it on the long one."""
    out = {}
    for sf in (False, True):
        tag = "sf" if sf else "plain"
        args = ["--map-out", str(seq["dir"] / f"{tag}.pcd"),
                "--stats-json", str(seq["dir"] / f"{tag}.json")]
        if sf:
            args.append("--self-filter")
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert _run(seq, "log" if sf else "short", f"{tag}.tum", *args) == 0
        out[tag] = buf.getvalue()
    return out


def test_run_on_the_cpu_reaches_inited(seq, single):
    out = single["plain"]
    assert "stage: INITED" in out, out
    assert _n_voxels(seq["dir"] / "plain.pcd") > 500
    with open(seq["dir"] / "plain.json") as f:
        st = json.load(f)
    assert st["n_pairs"] == N_SHORT - 1 and st["mode"] == "lio"
    assert st["t_step_s"] <= st["loop_wall_s"] + 1e-6 and st["fps_steady"] > 0
    assert st["dispatch_floor_ms"] > 0
    t, q, p = load_tum(seq["dir"] / "plain.tum")
    tg, qg, pg = load_tum(seq["gt"])
    assert len(t) == N_SHORT - 1
    np.testing.assert_allclose(t, tg[:len(t)], atol=1e-9)
    assert "stage: INITED" in single["sf"]
    assert _n_voxels(seq["dir"] / "sf.pcd") > 500


@pytest.mark.parametrize("self_filter", [False, True])
def test_two_phase_equals_single_process(seq, single, self_filter, capfd):
    tag = "sf" if self_filter else "plain"
    extra = ["--map-out", str(seq["dir"] / f"{tag}_tp.pcd"), "--two-phase"]
    if self_filter:
        extra.append("--self-filter")
    assert _run(seq, "log" if self_filter else "short", f"{tag}_tp.tum", *extra) == 0
    capfd.readouterr()
    t_sp, q_sp, p_sp = load_tum(seq["dir"] / f"{tag}.tum")
    t_tp, q_tp, p_tp = load_tum(seq["dir"] / f"{tag}_tp.tum")
    assert len(t_tp) == len(t_sp)
    np.testing.assert_allclose(t_tp, t_sp, atol=1e-6)
    np.testing.assert_allclose(p_tp, p_sp, atol=1e-4)
    assert np.abs(np.sum(q_tp * q_sp, axis=-1)).min() > 1.0 - 1e-6
    # the init sweep goes back into the map self-filtered like the others
    assert _n_voxels(seq["dir"] / f"{tag}_tp.pcd") == _n_voxels(seq["dir"] / f"{tag}.pcd")


def test_refused_combinations(tmp_path, capsys):
    log = str(tmp_path / "missing.liol")  # never opened: validation first
    base = ["run", "--log", log, "--out", str(tmp_path / "t.tum"), "--device", "cpu"]
    assert TCLI.main(base + ["--stop-at-init", str(tmp_path / "s.json")]) == 2
    assert "--stop-at-init requires --checkpoint-out" in capsys.readouterr().err
    assert TCLI.main(base + ["--two-phase", "--resume", str(tmp_path / "c.npz")]) == 2
    assert "mutually exclusive" in capsys.readouterr().err


def _ate(est, gt):
    from lio_mapping_tpu_torch.io.evaluation import (associate_by_time,
                                                     evaluate_trajectory)

    t_e, q_e, p_e = load_tum(est)
    t_g, q_g, p_g = load_tum(gt)
    ei, gi = associate_by_time(t_e, t_g, max_dt=0.02)
    return evaluate_trajectory(q_e[ei], p_e[ei], q_g[gi], p_g[gi]).ate_rmse


@pytest.mark.parametrize("flags", [[], ["--map-shard", "--ingest-shard"]],
                         ids=["plain", "map-ingest-shard"])
def test_run_mesh_on_the_cpu(seq, single, flags, capfd):
    tag = "mesh" + "".join(f[2] for f in flags)
    rc = _run(seq, "short", f"{tag}.tum", "--mesh", "2", "--stats-json",
              str(seq["dir"] / f"{tag}.json"), *flags)
    out = capfd.readouterr().out
    assert rc == 0
    assert "distributed estimator over 2 ranks on the CPU, backend gloo" in out
    assert ("(map-sharded) (ingest-sharded)" in out) == bool(flags)
    # rank 0 alone prints: one line of each
    assert out.count("wrote 9 poses") == 1 and "stage: INITED" in out
    assert "stage: INITED" in single["plain"]
    ate_mesh = _ate(seq["dir"] / f"{tag}.tum", seq["gt"])
    ate_single = _ate(seq["dir"] / "plain.tum", seq["gt"])
    assert abs(ate_mesh - ate_single) <= 0.05, (ate_mesh, ate_single)
    with open(seq["dir"] / f"{tag}.json") as f:
        mesh = json.load(f)["mesh"]
    assert mesh["ranks"] == 2 and mesh["backend"] == "gloo" and mesh["states_equal"]
    assert [r["device"] for r in mesh["per_rank"]] == ["cpu", "cpu"]
    assert mesh["consumed_sweeps"] > 0 and mesh["collectives_per_consumed_sweep"] > 0
    assert mesh["host_bytes_per_consumed_sweep"] == 0  # gloo takes CPU tensors as they are


def test_two_phase_hands_the_mesh_flags_to_both_phases(tmp_path, monkeypatch):
    import subprocess

    calls = []

    def call(cmd, env=None):
        calls.append(cmd)
        if "--stop-at-init" in cmd:
            with open(cmd[cmd.index("--stop-at-init") + 1], "w") as f:
                json.dump({"inited": True, "pairs": 3, "prev_bound": None}, f)
        return 0

    monkeypatch.setattr(subprocess, "call", call)
    rc = TCLI.main(["run", "--log", str(tmp_path / "seq.liol"), "--out", str(tmp_path / "t.tum"),
                    "--device", "cpu", "--two-phase", "--mesh", "2", "--map-shard",
                    "--ingest-shard"])
    assert rc == 0 and len(calls) == 2
    for cmd in calls:
        assert cmd[cmd.index("--mesh") + 1] == "2"
        assert "--map-shard" in cmd and "--ingest-shard" in cmd
    assert "--stop-at-init" in calls[0] and "--resume" in calls[1]


def test_check_caps_refuses_the_mesh_as_the_reference(tmp_path):
    # indoor: surf_stack_cap 6144 is not a multiple of 5
    args = ["run", "--log", str(tmp_path / "missing.liol"), "--out", str(tmp_path / "t.tum"),
            "--mesh", "5"]
    with pytest.raises(ValueError) as ref:
        JCLI.main(args)
    with pytest.raises(ValueError) as port:
        TCLI.main(args + ["--device", "cpu"])
    assert str(port.value) == str(ref.value) == \
        "surf_stack_cap=6144 not divisible by mesh size 5"


def test_mesh_needs_cuda_unless_told_cpu(seq, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = TCLI.main(["run", "--log", seq["log"], "--out", str(tmp_path / "t.tum"), "--mesh", "2"])
    assert rc != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "t.tum").exists()


def test_resumed_run_prefetches_no_skipped_pair(seq, tmp_path, monkeypatch, capsys):
    """``--skip-pairs 5``: the host loop copies none of the five skipped
    pairs' clouds (each prefetched cloud reaches the pipeline), and past
    them the cadence still gates the copies."""
    from lio_mapping_tpu_torch.models import pipeline as TPL

    rec, prefetched = [], []
    stub = _stub(TPL.LioPipeline, rec)

    class Counting(stub):
        def prefetch_cloud(self, xyz, mask, ring=None):
            prefetched.append(np.array(xyz))
            return super().prefetch_cloud(xyz, mask, ring)

    monkeypatch.setattr(TPL, "LioPipeline", Counting)
    assert TCLI.main(["run", "--log", seq["log"], "--profile", "indoor", "--device", "cpu",
                      "--out", str(tmp_path / "p.tum"), "--skip-pairs", "5"]) == 0
    assert len(rec) == N_SWEEPS - 1 - 5
    from lio_mapping_tpu_torch import native

    raw = [x[2] for x in native.SequenceLog(seq["log"]) if x[0] == "sweep"]

    def sweep_of(xyz):  # the log sweep a padded cloud holds
        return next(i for i, r in enumerate(raw) if np.array_equal(xyz[:len(r)], r)
                    and not xyz[len(r):].any())

    got = [sweep_of(x) for x in prefetched]
    assert got and min(got) >= 5, got  # sweep i is pair i; pairs 0-4 are skipped
    # every prefetched cloud of a pair reaches the pipeline (the log's last
    # sweep never pairs: no IMU after it)
    assert [sweep_of(r[1]) for r in rec if r[0]] == [i for i in got if i < N_SWEEPS - 1]
    assert rec[0][0] and [r[0] for r in rec].count(False) >= 2


def test_run_needs_cuda_unless_told_cpu(seq, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = TCLI.main(["run", "--log", seq["log"], "--out", str(tmp_path / "t.tum")])
    assert rc != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "t.tum").exists()


def _parser_of(main, monkeypatch):
    """The ArgumentParser a CLI's ``main`` builds (caught at parse_args)."""
    import argparse

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught) as got:
        main([])
    monkeypatch.undo()
    return got.value.args[0]


def _actions(parser):
    """{subcommand: {option: (default, choices, type, nargs, required)}}."""
    import argparse

    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.option_strings[0]: (a.default, a.choices, a.type, a.nargs, a.required)
                   for a in p._actions if a.option_strings and a.dest != "help"}
            for name, p in sub.choices.items()}


def test_parser_has_every_reference_subcommand_and_flag(monkeypatch):
    """All nine subcommands of the reference's CLI, each flag with its
    default, choices, type and arity; the port adds ``--device`` to ``run``
    and ``viz-normals`` only."""
    ref = _actions(_parser_of(JCLI.main, monkeypatch))
    port = _actions(_parser_of(TCLI.main, monkeypatch))
    assert sorted(port) == sorted(ref) and len(ref) == 9
    for cmd, flags in ref.items():
        assert port[cmd].keys() - flags.keys() == ({"--device"} if cmd in ("run", "viz-normals")
                                                   else set()), cmd
        for flag, spec in flags.items():
            assert port[cmd][flag] == spec, (cmd, flag)
    assert port["viz-normals"]["--device"][0] == port["run"]["--device"][0] == "cuda"
