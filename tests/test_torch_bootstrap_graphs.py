"""The bootstrap sweep, LOAM's two per-sweep programs and the 4D builder's
step through the step-graph runner (``models/step_graph.StepGraphs``) on
the CPU, where it runs each program eagerly through the static buffers a
CUDA graph uses, under ``HostReadGuard``, reads each conditional body's
flag outside the guard, and holds each graph's inputs to the buffers of its
first call, as a replay on the card holds them.

(a) A cold start from NOT_INITED through INITED and two sweeps after it
    (every 2nd sweep consumed, a sweep with 2% of its points, so that the
    next sweep's odometry has too few features): the pipeline whose
    bootstrap and step run through the runner equals the eager pipeline bit
    for bit: stage and outputs of every sweep, the init window, and the
    final odometry and estimator states.
(b) ``LoamPipeline`` over four sweeps (two mapped, two associated):
    runner against eager, bit for bit, poses and final states (the map
    stores included).
(c) Three ``MapBuilder`` steps: runner against eager, bit for bit.
(d) Every program ran under the guard without a refusal: no decision read
    on the host, every GN iteration met as a conditional body, and the
    graphs each pipeline would capture on the card.
(e) ``LoamPipeline.save`` / ``load`` from the runner's static buffers: the
    reference's npz layout with the eager pipeline's values, and a resumed
    runner pipeline continues as the eager one does.

The slice against the reference package: ``tests/test_torch_pipeline.py``'s
cold start runs the runner pipeline beside the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from lio_mapping_tpu_torch.io import synthetic as TSYN
from lio_mapping_tpu_torch.models import map_builder as TMB
from lio_mapping_tpu_torch.models import pipeline as TPL
from lio_mapping_tpu_torch.models import step_graph as SG
from lio_mapping_tpu_torch.ops import cloud as TC
from lio_mapping_tpu_torch.utils.se3 import Pose
from lio_mapping_tpu_torch.utils.tree import tree_leaves

from tests.test_map_builder import make_world_features
from tests.test_map_builder import small_cfg as builder_cfg
from tests.test_torch_map_builder import _body_cloud, _quat
from tests.test_torch_mapping import loam_cfg
from tests.test_torch_pipeline import cold_cfg, port_cfg

F64 = torch.float64
SPARSE = 1        # the sweep with 2% of its points (not pushed: odom_io 2)
N_AFTER = 2       # sweeps after the one that reaches INITED
N_MAX = 20
N_LOAM = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's CPU pipelines: the test
    workers share the cores, and torch's threads waiting on each other on
    oversubscribed cores made these sweeps ~40x slower (~20 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(p):
    """``p`` with its graphs on the CPU runner."""
    p._step_graphs = SG.StepGraphs("cpu")
    p.graphs = True
    return p


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (x.dtype == y.dtype and torch.equal(x, y)) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def _assert_outs_equal(oe, og):
    for i, (a, b) in enumerate(zip(oe, og)):
        assert sorted(a) == sorted(b), i
        for key in a:
            assert _equal(a[key], b[key]), (i, key)


def _boot_cfg():
    """``cold_cfg`` with every 2nd sweep consumed (pushed and not pushed
    bootstrap sweeps, and a predicted sweep after INITED), at most 4
    mini-GN rounds and 3 LM iterations (CPU steps of a second or two)."""
    cfg = port_cfg(cold_cfg())
    return dataclasses.replace(cfg, estimator=dataclasses.replace(
        cfg.estimator, odom_io=2, newest_refine_iters=4, max_solver_iterations=3))


def _sweep(traj, i, cfg, sparse=False):
    dt = cfg.sensor.scan_period
    t0 = i * dt
    xyz, mask = TSYN.simulate_sweep(traj, t0, n_azimuth=540)
    if sparse:
        mask = mask & (np.random.default_rng(i).uniform(size=len(mask)) < 0.02)
    ts, acc, gyr = TSYN.simulate_imu_interval(traj, t0, t0 + dt, 200.0)
    a0, w0 = traj.imu(t0)
    return xyz, mask, (np.diff(np.concatenate([[t0], ts])), acc, gyr, a0, w0)


@pytest.fixture(scope="module")
def cold():
    """Both pipelines (float64) from a cold start until N_AFTER sweeps past
    INITED; returns (pipes, outputs, the odometry's last clouds' feature
    counts after each sweep)."""
    cfg = _boot_cfg()
    traj = TSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    pipes = {"eager": TPL.LioPipeline(cfg, device="cpu", dtype=F64),
             "runner": _runner(TPL.LioPipeline(cfg, device="cpu", dtype=F64))}
    outs = {name: [] for name in pipes}
    counts = []
    for i in range(N_MAX):
        xyz, mask, imu = _sweep(traj, i, cfg, sparse=i == SPARSE)
        for name, p in pipes.items():
            outs[name].append(p.process(xyz, mask, p.make_samples(*imu)))
        odom = pipes["eager"].odom_state
        counts.append((int(odom.last_corner.count()), int(odom.last_surf.count())))
        stages = [o["stage"] for o in outs["eager"]]
        if "INITED" in stages and len(stages) - stages.index("INITED") > N_AFTER:
            break
    return pipes, outs, counts


def test_cold_start_through_the_runner_is_bit_equal(cold):
    """(a)"""
    pipes, outs, counts = cold
    oe, og = outs["eager"], outs["runner"]
    stages = [o["stage"] for o in oe]
    assert [o["stage"] for o in og] == stages
    first = stages.index("INITED")
    assert stages[0] == "NOT_INITED" and len(stages) == first + N_AFTER + 1, stages
    # the sparse sweep left too few features for the next sweep's GN
    odo = pipes["eager"].cfg.odometry
    assert counts[SPARSE][0] <= odo.min_corner_points or \
        counts[SPARSE][1] <= odo.min_surf_points, counts
    # after INITED: one consumed and one predicted sweep
    assert sorted("body_pose" in o for o in oe[first + 1:]) == [False, True]
    _assert_outs_equal(oe, og)
    pe, pg = pipes["eager"], pipes["runner"]
    assert _equal(pe.odom_state, pg.odom_state)
    assert _equal(pe.est_state, pg.est_state)
    assert _equal(pe._init_odom_poses, pg._init_odom_poses)
    assert _equal(pe._init_stacks, pg._init_stacks)


def test_bootstrap_runs_under_the_guard(cold):
    """(d) for the bootstrap: one graph a sweep (odometry with and without
    the init push, the INITED step, the predict), 25 GN iterations met as
    bodies per odometry sweep, no decision and no host read under the
    guard; the odometry's ``eigh`` ran inside ``eigh_plain`` only."""
    pipes, outs, _ = cold
    p = pipes["runner"]
    g = p._step_graphs
    cfg = p.cfg
    e = cfg.estimator
    n_odo = sum(1 for o in outs["runner"] if "body_pose" not in o and not o.get("predicted"))
    n_step = sum(1 for o in outs["runner"] if "body_pose" in o)
    assert g.stats["stretches"] == len(outs["runner"])
    assert g.stats["decisions"] == 0
    assert g.stats["conditionals"] == n_odo * cfg.odometry.max_iterations + n_step * (
        e.newest_refine_iters - 1 + e.max_solver_iterations - 1)
    assert {"_linalg_eigh", "_linalg_solve_ex"} <= g.guard_ops
    assert "_local_scalar_dense" not in g.guard_ops
    rows = next(k[1] for k in g._seen if k[0] == "step")
    assert {k[:2] for k in g._seen} == {("odometry", True), ("odometry", False), ("step", rows),
                                        ("predict",)}
    # the pipeline's outputs are copies: none lies in a static buffer
    static = {base.untyped_storage().data_ptr() for base, _ in g._static.values()}
    for o in outs["runner"]:
        for t in tree_leaves({k: o[k] for k in ("laser_pose", "surf_cloud") if k in o}):
            assert t.untyped_storage().data_ptr() not in static


@pytest.fixture(scope="module")
def loam():
    """Eager and runner ``LoamPipeline`` (float64) over N_LOAM sweeps."""
    cfg = port_cfg(loam_cfg())
    traj = TSYN.Trajectory()
    pipes = {"eager": TPL.LoamPipeline(cfg, device="cpu", dtype=F64),
             "runner": _runner(TPL.LoamPipeline(cfg, device="cpu", dtype=F64))}
    sweeps = [TSYN.simulate_sweep(traj, 0.1 * i, n_azimuth=360) for i in range(N_LOAM + 2)]
    outs = {name: [p.process(*sweeps[i]) for i in range(N_LOAM)] for name, p in pipes.items()}
    return pipes, outs, sweeps


def test_loam_through_the_runner_is_bit_equal(loam):
    """(b) and (d) for LOAM: two graphs (mapped, associated), the GNs'
    iterations met as bodies, no decision."""
    pipes, outs, _ = loam
    pe, pg = pipes["eager"], pipes["runner"]
    _assert_outs_equal(outs["eager"], outs["runner"])
    assert _equal(pe.map_state, pg.map_state) and _equal(pe.odom_state, pg.odom_state)
    assert bool(pg.map_state.initialized) and int(pg.map_state.surf_map.mask.sum()) > 100
    g = pg._step_graphs
    cfg = pg.cfg
    n_map = N_LOAM // cfg.odometry.io_ratio
    assert {k[0] for k in g._seen} == {"loam_map", "loam_assoc"}
    assert g.stats["stretches"] == N_LOAM and g.stats["decisions"] == 0
    assert g.stats["conditionals"] == N_LOAM * cfg.odometry.max_iterations + \
        n_map * cfg.mapping.max_iterations
    assert "_local_scalar_dense" not in g.guard_ops
    # the refinement moved the mapped pose off the chained one
    moved = [not torch.equal(a["laser_pose"].t, a["odom_pose"].t) for a in outs["runner"]]
    assert any(moved[1:])


def test_loam_checkpoint_round_trip(loam, tmp_path):
    """(e): the runner's save is the eager pipeline's, key by key and bit
    by bit; a runner pipeline resumed from it (its states copied into its
    buffers at the next sweep) and the eager one continue alike."""
    pipes, _, sweeps = loam
    pe, pg = pipes["eager"], pipes["runner"]
    paths = {name: str(tmp_path / f"{name}.npz") for name in pipes}
    for name, p in pipes.items():
        p.save(paths[name])
    with np.load(paths["eager"]) as a, np.load(paths["runner"]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("map.") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    resumed = _runner(TPL.LoamPipeline(pg.cfg, device="cpu", dtype=F64))
    resumed.load(paths["runner"])
    assert resumed.frame_count == N_LOAM
    for xyz, mask in sweeps[N_LOAM:]:
        a, b = pe.process(xyz, mask), resumed.process(xyz, mask)
        assert _equal(a, b)
    assert _equal(pe.map_state, resumed.map_state)


def test_map_builder_through_the_runner_is_bit_equal():
    """(c) and (d) for the builder: three steps (the first maps at the
    prediction, the next two refine), one graph, no decision."""
    base = builder_cfg()
    cfg = port_cfg(dataclasses.replace(
        base, mapping=dataclasses.replace(base.mapping, map_cloud_cap=4096),
        estimator=dataclasses.replace(base.estimator, corner_stack_cap=256,
                                      surf_stack_cap=1024)))
    rng = np.random.default_rng(1)
    surf_w, corner_w = (a.astype(np.float64) for a in make_world_features(rng))
    builders = {"eager": TMB.MapBuilder(cfg, "cpu", F64),
                "runner": _runner(TMB.MapBuilder(cfg, "cpu", F64))}
    outs = {name: [] for name in builders}
    for k in range(3):
        yaw = 0.25 * np.sin(0.15 * k)
        rot = Rotation.from_euler("ZYX", [yaw, 0.05 * np.sin(0.2 * k), 0.04 * np.cos(0.2 * k)])
        p = np.array([1.5 * np.sin(0.1 * k), 1.2 * np.cos(0.1 * k) - 1.2, 1.0])
        clouds = []
        for world, cap in ((corner_w, cfg.estimator.corner_stack_cap),
                           (surf_w, cfg.estimator.surf_stack_cap)):
            xyz, mask = _body_cloud(world, _quat(rot), p, rng, cap)
            clouds.append(TC.Cloud.from_xyz(torch.as_tensor(xyz), mask=torch.as_tensor(mask)))
        drift = Rotation.from_euler("ZYX", [0.004 * k, 0, 0])
        odom = Pose(torch.as_tensor(_quat(drift * rot)),
                    torch.as_tensor(drift.apply(p) + [0.008 * k, 0.0, 0.0]))
        for name, b in builders.items():
            outs[name].append(b.step(*clouds, odom))
    _assert_outs_equal(outs["eager"], outs["runner"])
    be, bg = builders["eager"], builders["runner"]
    assert _equal(be.state, bg.state)
    assert not torch.equal(outs["runner"][2]["pose"].t, outs["runner"][0]["pose"].t)
    g = bg._step_graphs
    assert list(g._seen) == [("map_builder",)]
    assert g.stats["decisions"] == 0
    assert g.stats["conditionals"] == 3 * cfg.mapping.max_iterations
    assert not TMB.MapBuilder(cfg, "cpu").graphs
    with pytest.raises(ValueError, match="graphs"):
        TMB.MapBuilder(cfg, "cpu", graphs=True)
