"""Trajectory evaluation: ATE / RPE (copy of lio_mapping_tpu.io.evaluation).

The reference evaluates trajectories externally (scripts/transform_monitor.py
republishing euler angles into rqt_plot, SURVEY §4); here evaluation is a
first-class library: Umeyama/SE(3) alignment + absolute trajectory error and
relative pose error, matching the TUM evaluation conventions used by the
ICRA'19 paper's ATE tables.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


class TrajMetrics(NamedTuple):
    ate_rmse: float
    ate_mean: float
    ate_median: float
    ate_max: float
    rpe_trans_rmse: float
    rpe_rot_rmse_deg: float
    n_poses: int


def align_se3(est_t: np.ndarray, gt_t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares SE(3) alignment (Umeyama without scale): returns (R, t)
    such that R @ est + t ~= gt."""
    mu_e = est_t.mean(axis=0)
    mu_g = gt_t.mean(axis=0)
    e = est_t - mu_e
    g = gt_t - mu_g
    h = e.T @ g
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    s = np.diag([1.0, 1.0, d])
    r = vt.T @ s @ u.T
    t = mu_g - r @ mu_e
    return r, t


def evaluate_trajectory(
    est_q: np.ndarray, est_t: np.ndarray,
    gt_q: np.ndarray, gt_t: np.ndarray,
    rpe_delta: int = 1,
) -> TrajMetrics:
    """ATE (after SE(3) alignment) + RPE over ``rpe_delta``-frame intervals.

    Quaternions in [w,x,y,z]; positions (N, 3).
    """
    est_t = np.asarray(est_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    r, t = align_se3(est_t, gt_t)
    est_aligned = (r @ est_t.T).T + t
    err = np.linalg.norm(est_aligned - gt_t, axis=-1)

    def rot(q):
        return Rotation.from_quat(np.roll(np.asarray(q, np.float64), -1, axis=-1))

    re = rot(est_q)
    rg = rot(gt_q)
    d = rpe_delta
    rpe_t, rpe_r = [], []
    for i in range(len(est_t) - d):
        de_t = re[i].inv().apply(est_t[i + d] - est_t[i])
        dg_t = rg[i].inv().apply(gt_t[i + d] - gt_t[i])
        rpe_t.append(np.linalg.norm(de_t - dg_t))
        de_r = re[i].inv() * re[i + d]
        dg_r = rg[i].inv() * rg[i + d]
        rpe_r.append(np.rad2deg((de_r.inv() * dg_r).magnitude()))

    return TrajMetrics(
        ate_rmse=float(np.sqrt(np.mean(err**2))),
        ate_mean=float(err.mean()),
        ate_median=float(np.median(err)),
        ate_max=float(err.max()),
        rpe_trans_rmse=float(np.sqrt(np.mean(np.square(rpe_t)))) if rpe_t else 0.0,
        rpe_rot_rmse_deg=float(np.sqrt(np.mean(np.square(rpe_r)))) if rpe_r else 0.0,
        n_poses=len(est_t),
    )


def associate_by_time(
    t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02,
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp pairing of two trajectories (the TUM association
    convention): for each estimate stamp, the closest ground-truth stamp
    within ``max_dt``; each ground-truth pose is used at most once.

    Returns (est_idx, gt_idx) index arrays of equal length. Robust to
    dropped/extra frames (e.g. LIO init frames missing from the estimate)
    where index-truncation pairing would silently misalign every
    subsequent pose.
    """
    t_est = np.asarray(t_est, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    order = np.argsort(t_gt)
    t_gt_sorted = t_gt[order]
    pos = np.searchsorted(t_gt_sorted, t_est)
    lo = np.clip(pos - 1, 0, len(t_gt_sorted) - 1)
    hi = np.clip(pos, 0, len(t_gt_sorted) - 1)
    pick = np.where(
        np.abs(t_gt_sorted[hi] - t_est) < np.abs(t_gt_sorted[lo] - t_est),
        hi, lo)
    dt = np.abs(t_gt_sorted[pick] - t_est)
    est_idx, gt_idx, used = [], [], set()
    for i in np.argsort(dt):  # greedily keep the best matches
        if dt[i] > max_dt:
            break
        g = int(order[pick[i]])
        if g in used:
            continue
        used.add(g)
        est_idx.append(int(i))
        gt_idx.append(g)
    sel = np.argsort(est_idx)
    return (np.asarray(est_idx, np.int64)[sel],
            np.asarray(gt_idx, np.int64)[sel])


def save_tum(path: str, times: Sequence[float], qs: np.ndarray, ts: np.ndarray):
    """Write a TUM-format trajectory file (t x y z qx qy qz qw).

    9 decimal digits: enough that a write -> read -> write round trip is
    value-preserving for f32-derived poses (the two-phase CLI prepends
    phase A's file via --traj-prefix, so prefix poses quantize TWICE; at
    6 digits that showed up as ~1e-6 quaternion error against the
    single-process trajectory)."""
    with open(path, "w") as f:
        for t, q, p in zip(times, qs, ts):
            f.write(f"{t:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


def load_tum(path: str):
    data = np.loadtxt(path)
    times = data[:, 0]
    ts = data[:, 1:4]
    qs = np.roll(data[:, 4:8], 1, axis=-1)  # xyzw -> wxyz
    return times, qs, ts
