"""The plain reference that a run's poses are judged against.

The sequence is made by ``harness/world.py`` from an analytic trajectory,
so the exact answer to "where was the sensor at the end of sweep k" is the
trajectory itself: :func:`gt_poses` evaluates it in float64 on the CPU.
The error arithmetic is a frozen copy of ``align_se3`` and
``evaluate_trajectory`` of ``lio_mapping_tpu_torch/io/evaluation.py``
(Umeyama without scale, then per-pose position error and the relative
pose error between neighbours), with per-pose errors kept so that every
answer is judged, not only their mean.

Imports numpy, scipy and torch only: nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from .world import rig_of, sensor_poses


def gt_poses(conf: dict, sweeps: Sequence[int]):
    """The laser's pose at the end stamp of each run sweep in ``sweeps``:
    (q wxyz (N, 4), p (N, 3)) float64."""
    dt = float(conf["sensor"]["scan_period"])
    period = int(conf["sequence"]["loop_sweeps"])
    k = np.asarray(sweeps, np.int64) % period
    t = torch.as_tensor((k + 1) * dt, dtype=torch.float64)
    rot, p = sensor_poses(conf["trajectory"], rig_of(conf), t)
    q_xyzw = Rotation.from_matrix(rot.numpy()).as_quat()
    return np.roll(q_xyzw, 1, axis=-1), p.numpy()


def gt_velocity_world(conf: dict, sweeps: Sequence[int]) -> np.ndarray:
    """The body's world velocity at the end stamp of each sweep (N, 3)."""
    from .world import trajectory_state

    dt = float(conf["sensor"]["scan_period"])
    period = int(conf["sequence"]["loop_sweeps"])
    k = np.asarray(sweeps, np.int64) % period
    t = torch.as_tensor((k + 1) * dt, dtype=torch.float64)
    return trajectory_state(conf["trajectory"], t)[2].numpy()


def align_se3(est_t: np.ndarray, gt_t: np.ndarray):
    """Least-squares SE(3) alignment (Umeyama without scale): (R, t) with
    R @ est + t ~= gt."""
    mu_e = est_t.mean(axis=0)
    mu_g = gt_t.mean(axis=0)
    h = (est_t - mu_e).T @ (gt_t - mu_g)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return r, mu_g - r @ mu_e


def pose_errors(est_q, est_t, gt_q, gt_t) -> Dict[str, np.ndarray]:
    """Per-pose errors of an estimated trajectory against the truth, after
    one SE(3) alignment of the positions: ``pos`` (N,) m; ``rot`` (N,) deg
    (the aligned estimate's attitude against the truth); ``rpe`` (N - 1,)
    m, the position error of each step between neighbours in the earlier
    pose's frame; ``rpe_rot`` (N - 1,) deg, the error of each step's
    rotation."""
    est_t = np.asarray(est_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    r, t = align_se3(est_t, gt_t)
    pos = np.linalg.norm(est_t @ r.T + t - gt_t, axis=-1)
    re = Rotation.from_quat(np.roll(np.asarray(est_q, np.float64), -1, axis=-1))
    rg = Rotation.from_quat(np.roll(np.asarray(gt_q, np.float64), -1, axis=-1))
    de = re[:-1].inv().apply(est_t[1:] - est_t[:-1])
    dg = rg[:-1].inv().apply(gt_t[1:] - gt_t[:-1])
    step_e = re[:-1].inv() * re[1:]
    step_g = rg[:-1].inv() * rg[1:]
    rpe_rot = np.rad2deg((step_e.inv() * step_g).magnitude())
    return {"pos": pos, "rpe": np.linalg.norm(de - dg, axis=-1), "rpe_rot": rpe_rot}


def summarize(err: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers a run's check can compare, from :func:`pose_errors`."""
    pos, rpe, rot = err["pos"], err["rpe"], err["rpe_rot"]
    one = len(rpe) > 0
    return {
        "ate_rmse_m": float(np.sqrt(np.mean(pos ** 2))),
        "ate_max_m": float(pos.max()),
        "rpe_rmse_m": float(np.sqrt(np.mean(rpe ** 2))) if one else 0.0,
        "rpe_max_m": float(rpe.max()) if one else 0.0,
        "rpe_rot_max_deg": float(rot.max()) if one else 0.0,
    }


def state_errors(conf: dict, sweeps, poses: dict) -> Dict[str, float]:
    """The consumed sweeps' velocity (against the truth, in the frame the
    positions align into), bias and laser-to-IMU extrinsic estimates (the
    simulated IMU has no bias; the rig is the configuration's)."""
    from .world import rig_of

    est_t, gt_t = poses["t"], gt_poses(conf, poses["k"])[1]
    r, _ = align_se3(est_t, gt_t)
    v_gt = gt_velocity_world(conf, sweeps)
    v_err = np.linalg.norm(poses["velocity"] @ r.T - v_gt, axis=-1)
    rig = rig_of(conf)
    r_lb_true = rig.r_bl.numpy().T
    t_lb_true = -r_lb_true @ rig.t_bl.numpy()
    q = poses["ex_q"]
    r_lb = Rotation.from_quat(np.roll(q, -1, axis=-1))
    ex_rot = np.rad2deg((r_lb.inv() * Rotation.from_matrix(r_lb_true)).magnitude())
    ex_t = np.linalg.norm(poses["ex_p"] - t_lb_true, axis=-1)
    return {"vel_err_max_mps": float(v_err.max()),
            "vel_err_rmse_mps": float(np.sqrt(np.mean(v_err ** 2))),
            "ba_max": float(np.linalg.norm(poses["ba"], axis=-1).max()),
            "bg_max": float(np.linalg.norm(poses["bg"], axis=-1).max()),
            "ex_rot_max_deg": float(ex_rot.max()), "ex_t_max_m": float(ex_t.max())}
