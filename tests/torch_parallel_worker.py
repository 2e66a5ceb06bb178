"""Rank program of tests/test_torch_parallel.py (not a test module).

``run_checks`` is started once per rank by ``multihost.launch`` on the CPU
(gloo). It imports only the port (no ``jax``, no ``lio_mapping_tpu``: it
records that it did not) and writes this rank's results as
``rank<r>.npz`` in the case directory; the test module holds them against
the JAX package and the port's single-device functions, computed in the
pytest process on the same numpy inputs. The functions here that make the
inputs are shared with the test module.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from lio_mapping_tpu_torch.io import synthetic as SYN
from lio_mapping_tpu_torch.models import estimator as EST
from lio_mapping_tpu_torch.ops import knn as KNN
from lio_mapping_tpu_torch.ops import marginalization as MG
from lio_mapping_tpu_torch.ops import preintegration as PI
from lio_mapping_tpu_torch.ops import solver as SV
from lio_mapping_tpu_torch.ops.cloud import Cloud
from lio_mapping_tpu_torch.parallel import distributed as DIST
from lio_mapping_tpu_torch.parallel import lio_dist
from lio_mapping_tpu_torch.parallel import map_sharded as MS
from lio_mapping_tpu_torch.parallel import multihost as MH
from lio_mapping_tpu_torch.parallel import sharded_ba as SB
from lio_mapping_tpu_torch.utils import quaternion as quat
from lio_mapping_tpu_torch.utils.tree import tree_leaves, tree_map

F64 = torch.float64
N_STEP_SWEEPS = 10  # consumed sweeps of the full-step check (tests/test_lio_dist.py's)
INGEST_ROWS = 1001  # not a multiple of 2: the last rank's slice is padded


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds; the test module builds the same)
# ---------------------------------------------------------------------------


def ring_inputs(case: str, n_dev: int = 2):
    """(queries, q_mask, db, db_mask, k, prune) of ``tests/test_map_sharded``'s
    ring KNN cases: "plain", "gated" (1 m^2) and "invalid_block" (rank 0's
    whole map block masked)."""
    if case == "invalid_block":
        rng = np.random.default_rng(3)
        m_n = 64 * n_dev
        queries = rng.normal(size=(8 * n_dev, 3))
        q_mask = np.ones((8 * n_dev,), bool)
        db = rng.normal(size=(m_n, 3))
        db_mask = np.ones((m_n,), bool)
        db_mask[:64] = False
        return queries, q_mask, db, db_mask, 5, None
    rng = np.random.default_rng(0)
    queries = rng.normal(size=(256, 3)) * 4.0
    q_mask = rng.random(256) > 0.05
    db = rng.normal(size=(2048, 3)) * 4.0
    db_mask = rng.random(2048) > 0.1
    return queries, q_mask, db, db_mask, 5, (1.0 if case == "gated" else None)


def window_step_inputs(cfg, n_dev: int = 2):
    """``tests/test_map_sharded.test_mapsharded_step_matches_replicated``'s
    random draws (seed 5), as numpy: (x0_p, map_xyz, stacks_xyz, rel_t)."""
    s = cfg.estimator.opt_window_size
    rng = np.random.default_rng(5)
    x0_p = rng.normal(0, 0.05, (s + 1, 3))
    map_xyz = rng.uniform(-5, 5, (128 * n_dev, 3))
    stacks_xyz = rng.uniform(-5, 5, (s, 32 * n_dev, 3))
    rel_t = rng.normal(0, 0.05, (s + 1, 3))
    return x0_p, map_xyz, stacks_xyz, rel_t


def window_step_args(cfg, arrays):
    """The port's arguments of ``make_distributed_step*`` from
    ``window_step_inputs`` (identity rotations, identity preintegrations
    with covariance 1e-4 I over 0.1 s, an empty prior)."""
    x0_p, map_xyz, stacks_xyz, rel_t = (torch.as_tensor(a, dtype=F64) for a in arrays)
    s = cfg.estimator.opt_window_size
    eye_q = quat.identity(F64).repeat(s + 1, 1)
    x0 = SV.OptStates(q=eye_q, p=x0_p, sb=torch.zeros((s + 1, 9), dtype=F64),
                      ex_q=quat.identity(F64), ex_p=torch.zeros(3, dtype=F64))
    pre = PI.Preintegration.identity(F64)._replace(
        covariance=torch.eye(15, dtype=F64) * 1e-4, sum_dt=torch.tensor(0.1, dtype=F64))
    pres = tree_map(lambda a: a.expand((s,) + a.shape).clone(), pre)
    g_vec = torch.tensor([0.0, 0.0, -9.805], dtype=F64)
    return (x0, pres, g_vec, map_xyz, torch.ones(map_xyz.shape[0], dtype=torch.bool),
            stacks_xyz, torch.ones(stacks_xyz.shape[:2], dtype=torch.bool), eye_q, rel_t,
            MG.PriorState.empty(s, F64))


def step_inputs(cfg, traj, t0):
    """One sweep and its IMU interval (``tests/test_lio_dist._make_inputs``
    on the port): (surf Cloud, ImuSamples) in float64."""
    dt = cfg.sensor.scan_period
    cap = cfg.feature.surf_less_flat_cap
    xyz, mask = SYN.simulate_sweep(traj, t0, n_azimuth=360)
    n = min(len(xyz), cap)
    x = np.zeros((cap, 3), np.float64)
    mk = np.zeros(cap, bool)
    x[:n] = xyz[:n]
    mk[:n] = mask[:n]
    cloud = Cloud(xyz=torch.as_tensor(x), rel_time=torch.zeros(cap, dtype=F64),
                  ring=torch.zeros(cap, dtype=torch.int32), mask=torch.as_tensor(mk))
    ts, acc, gyr = SYN.simulate_imu_interval(traj, t0, t0 + dt, 200.0)
    a0, w0 = traj.imu(t0)
    dts = np.diff(np.concatenate([[t0], ts]))
    packed = PI.pack_samples_np(dts, acc, gyr, a0, w0, cfg.estimator.imu.max_imu_per_frame)
    return cloud, PI.unpack_samples(torch.as_tensor(packed, dtype=F64))


def run_steps(cfg, step, n_sweeps: int = N_STEP_SWEEPS):
    """``n_sweeps`` consumed sweeps of ``step`` from the synthetic INITED
    state: (laser positions (n, 3), final state)."""
    traj = SYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    state, t_next = SYN.synthetic_estimator_state(cfg, traj, F64, n_azimuth=360)
    dt = cfg.sensor.scan_period
    poses = []
    for i in range(n_sweeps):
        cloud, samples = step_inputs(cfg, traj, t_next + (i - 1) * dt)
        corner = cloud if cfg.estimator.use_corner else None
        state, out = step(state, cloud, samples, corner)
        poses.append(out["laser_pose"].t.numpy())
    return np.stack(poses), state


def ingest_cloud(with_ring: bool):
    rng = np.random.default_rng(11)
    xyz = rng.normal(size=(INGEST_ROWS, 3)).astype(np.float32) * 10
    mask = rng.random(INGEST_ROWS) > 0.2
    ring = rng.integers(0, 16, INGEST_ROWS).astype(np.uint16) if with_ring else None
    return xyz, mask, ring


# ---------------------------------------------------------------------------
# the checks, on every rank
# ---------------------------------------------------------------------------


def _gather(t, mesh):
    return MH.all_gather_rows(t.contiguous(), mesh)


def check_ring(mesh, out):
    for case in ("plain", "gated", "invalid_block"):
        q, qm, db, dbm, k, prune = ring_inputs(case, mesh.size)
        lq, lqm, ldb, ldbm = MH.shard_rows((q, qm, db, dbm), mesh)
        d, i, x = MS.ring_knn(lq, lqm, ldb, ldbm, k=k, axis=mesh, prune_beyond=prune)
        out[f"ring/{case}/d"] = _gather(d, mesh).numpy()
        out[f"ring/{case}/i"] = _gather(i, mesh).numpy()
        out[f"ring/{case}/x"] = _gather(x, mesh).numpy()


def check_force_tiled(mesh, out, cfg):
    """One map-sharded step with use_corner, every ``knn`` call recorded:
    (map rows, force_tiled)."""
    calls = []
    orig = KNN.knn

    def rec(queries, q_mask, db, db_mask, *args, **kwargs):
        calls.append((db.shape[0], bool(kwargs.get("force_tiled", False))))
        return orig(queries, q_mask, db, db_mask, *args, **kwargs)

    KNN.knn = rec
    try:
        run_steps(cfg, lio_dist.make_sharded_lio_step(mesh, cfg, map_shard=True), 1)
    finally:
        KNN.knn = orig
    out["force_tiled/calls"] = np.asarray(calls, np.int64)


def check_solve(mesh, out, cfg_s, problem):
    """``solve_window_sharded`` and ``marginalize_pivot(psum_axis)`` on this
    rank's half of the window problem's plane rows."""
    x0, pres, planes = problem
    x0 = SV.OptStates(*(torch.as_tensor(a) for a in x0))
    pres = PI.Preintegration(*(torch.as_tensor(a) for a in pres))
    planes = SV.PlaneFactors(*(torch.as_tensor(a) for a in planes))
    f = planes.point.shape[1] // mesh.size
    local = tree_map(lambda a: a[:, mesh.rank * f:(mesh.rank + 1) * f].contiguous(), planes)
    prior = MG.PriorState.empty(cfg_s, F64)
    g_vec = torch.tensor([0.0, 0.0, -9.805], dtype=F64)
    no = torch.tensor(False)
    x, cost = SB.solve_window_sharded(x0, pres, g_vec, local, prior, None, s=cfg_s,
                                      max_iterations=6, opt_extrinsic=no, use_marg=no,
                                      axis=mesh)
    new = SV.marginalize_pivot(x, tree_map(lambda a: a[0], pres), g_vec, local, prior,
                               s=cfg_s, psum_axis=mesh)
    for name in ("q", "p", "sb"):
        out[f"solve/{name}"] = getattr(x, name).numpy()
    out["solve/cost"] = cost.numpy()
    out["marg/lin_jac"] = new.lin_jac.numpy()
    out["marg/lin_res"] = new.lin_res.numpy()


def check_window_steps(mesh, out, cfg):
    args = window_step_args(cfg, window_step_inputs(cfg, mesh.size))
    for tag, make in (("rep", DIST.make_distributed_step),
                      ("ms", DIST.make_distributed_step_mapsharded)):
        x, prior, cost = make(mesh, cfg)(*args)
        for name in ("q", "p", "sb"):
            out[f"dstep/{tag}/{name}"] = getattr(x, name).numpy()
        out[f"dstep/{tag}/lin_jac"] = prior.lin_jac.numpy()
        out[f"dstep/{tag}/lin_res"] = prior.lin_res.numpy()
        out[f"dstep/{tag}/cost"] = cost.numpy()


def check_full_steps(mesh, out, cfg):
    for tag, map_shard in (("plain", False), ("map_shard", True)):
        poses, st = run_steps(cfg, lio_dist.make_sharded_lio_step(mesh, cfg, map_shard))
        out[f"full/{tag}/poses"] = poses
        for name in ("qs", "ps", "vs", "bas", "bgs"):
            out[f"full/{tag}/{name}"] = getattr(st, name).numpy()
        out[f"full/{tag}/state_bytes"] = np.frombuffer(b"".join(
            leaf.contiguous().view(torch.uint8).numpy().tobytes()
            for leaf in tree_leaves(st)), np.uint8)


def check_ingest(mesh, out, cfg):
    from lio_mapping_tpu_torch.models.pipeline import LioPipeline, _upload_cloud

    for with_ring in (False, True):
        xyz, mask, ring = ingest_cloud(with_ring)
        pipe = LioPipeline(cfg, dtype=torch.float32, mesh=mesh, ingest_shard=True)
        before = mesh.host_bytes, mesh.collectives
        got = pipe._commit_cloud(xyz, mask, ring)
        pref = pipe.prefetch_cloud(xyz, mask, ring).xyzw
        tag = "ring" if with_ring else "xyzw"
        out[f"ingest/{tag}/sharded"] = got.numpy()
        out[f"ingest/{tag}/prefetched"] = pref.numpy()
        out[f"ingest/{tag}/replicated"] = _upload_cloud(xyz, mask, ring, pipe.device,
                                                        torch.float32).numpy()
        out[f"ingest/{tag}/collectives"] = np.asarray(mesh.collectives - before[1])


def check_multihost(mesh, out):
    n = 2 * mesh.size
    x = MH.shard_rows(np.arange(float(n)), mesh)
    out["mh/psum"] = MH.psum(x, mesh).numpy()
    mine = {"a": np.full((3,), float(mesh.rank + 1)), "b": torch.tensor([mesh.rank == 0])}
    rep = MH.fetch(MH.replicate(mine, mesh))
    out["mh/replicate_a"] = rep["a"]
    out["mh/replicate_b"] = rep["b"]
    out["mh/counters"] = np.asarray([mesh.collectives, mesh.bytes, mesh.host_bytes])
    out["mh/make_mesh"] = np.asarray([lio_dist.make_mesh(device="cpu").size,
                                      lio_dist.make_mesh(mesh.size, "cpu").rank])
    out["mh/is_multiprocess"] = np.asarray(MH.is_multiprocess())


def run_checks(rank, world, address, case_dir, cfgs, problem):
    """Every check on this rank; writes ``rank<r>.npz`` to ``case_dir``."""
    torch.set_num_threads(1)
    mesh = MH.initialize(address, world, rank, device="cpu")
    out = {"backend": np.asarray(mesh.backend), "device": np.asarray(str(mesh.device))}
    try:
        check_multihost(mesh, out)
        check_ring(mesh, out)
        check_solve(mesh, out, cfgs["window"].estimator.opt_window_size, problem)
        check_window_steps(mesh, out, cfgs["window"])
        check_ingest(mesh, out, cfgs["tiny"])
        check_force_tiled(mesh, out, cfgs["corner"])
        check_full_steps(mesh, out, cfgs["tiny"])
    finally:
        MH.shutdown()
    out["imported_jax"] = np.asarray([m for m in ("jax", "lio_mapping_tpu")
                                      if m in sys.modules])
    np.savez(os.path.join(case_dir, f"rank{rank}.npz"), **out)
    return 0


def exit_with(rank, world, address, codes):
    """A rank that exits with ``codes[rank]`` (for the launcher's test)."""
    return codes[rank]


def ring_on_card(rank, world, address, case_dir, q, qm, db, dm, gate):
    """``ring_knn`` of this rank's query rows against its block of the map,
    on the card (gloo, ranks sharing it); writes the gathered results, the
    kernel's launches and the host-staged bytes to ``card<r>.npz``."""
    from lio_mapping_tpu_torch.ops import knn_kernel

    mesh = MH.initialize(address, world, rank, device="cuda")
    try:
        lq, lqm, ldb, ldm = MH.shard_rows((q, qm, db, dm), mesh)
        before = knn_kernel.launches()
        d, i, _ = MS.ring_knn(lq, lqm, ldb, ldm, k=5, axis=mesh, prune_beyond=gate)
        torch.cuda.synchronize()
        out = {"d": _gather(d, mesh).cpu().numpy(), "i": _gather(i, mesh).cpu().numpy(),
               "launches": np.asarray(knn_kernel.launches() - before),
               "host_bytes": np.asarray(mesh.host_bytes), "backend": np.asarray(mesh.backend)}
    finally:
        MH.shutdown()
    np.savez(os.path.join(case_dir, f"card{rank}.npz"), **out)
    return 0
