"""LIO bootstrap: extrinsic rotation, gyro bias, gravity + velocities
(port of lio_mapping_tpu.models.initializer; reference ImuInitializer.cc).

Host-side numpy solves on a filled window; the quaternion algebra goes
through the port's ``utils.quaternion`` on float64 CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.preintegration import O_BG, O_R
from ..utils import quaternion as quat


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64))


def tangent_basis(g0: np.ndarray) -> np.ndarray:
    """(3,2) basis of the tangent plane at direction g0 (ImuInitializer.cc:35-47)."""
    a = g0 / np.linalg.norm(g0)
    tmp = np.array([0.0, 0.0, 1.0])
    if np.allclose(a, tmp):
        tmp = np.array([1.0, 0.0, 0.0])
    b = tmp - a * (a @ tmp)
    b /= np.linalg.norm(b)
    return np.stack([b, np.cross(a, b)], axis=1)


def estimate_extrinsic_rotation(laser_q: np.ndarray, imu_dq: np.ndarray, q_lb0: np.ndarray):
    """Hand-eye rotation calibration (ImuInitializer.cc:353-419).
    Returns (q_lb wxyz, success)."""
    rot_bl = quat.conjugate(_t(q_lb0))
    rows = []
    for i in range(len(imu_dq)):
        q_ij_laser = quat.qmul(quat.conjugate(_t(laser_q[i])), _t(laser_q[i + 1]))
        q_ij_imu = _t(imu_dq[i])
        q_laser_from_imu = quat.qmul(quat.conjugate(rot_bl), quat.qmul(q_ij_imu, rot_bl))
        ang = float(np.rad2deg(quat.angular_distance(q_ij_laser, q_laser_from_imu).item()))
        huber = 5.0 / ang if ang > 5.0 else 1.0
        rows.append(huber * (quat.left_matrix(q_ij_laser).numpy()
                             - quat.right_matrix(q_ij_imu).numpy()))
    _, s, vt = np.linalg.svd(np.concatenate(rows, axis=0), full_matrices=True)
    x = vt[3]  # coeffs [x, y, z, w] (Eigen coefficient order)
    q_lb = np.array([x[3], x[0], x[1], x[2]])
    q_lb /= np.linalg.norm(q_lb)
    return q_lb, bool(s[-3] > 0.25)  # 2nd-smallest singular value


def estimate_gyro_bias(laser_q: np.ndarray, pres_jacobian, pres_delta_q):
    """Gyro-bias correction delta (ImuInitializer.cc:49-90)."""
    a = np.zeros((3, 3))
    b = np.zeros(3)
    for i in range(len(pres_delta_q)):
        q_ij = quat.qmul(quat.conjugate(_t(laser_q[i])), _t(laser_q[i + 1]))
        tmp_a = np.asarray(pres_jacobian[i], np.float64)[O_R:O_R + 3, O_BG:O_BG + 3]
        tmp_b = 2.0 * quat.qmul(quat.conjugate(_t(pres_delta_q[i])), q_ij).numpy()[1:4]
        a += tmp_a.T @ tmp_a
        b += tmp_a.T @ tmp_b
    return np.linalg.solve(a, b)


def _rots(laser_q):
    return [quat.to_matrix(_t(q)).numpy() for q in laser_q]


def approximate_gravity(laser_p, laser_q, q_lb, t_lb, sum_dts, delta_ps, delta_vs,
                        g_norm: float):
    """Initial gravity in the laser world frame (ImuInitializer.cc:92-172)."""
    w = len(sum_dts)
    if w < 5:
        return None, False
    a = np.zeros((3, 3))
    b = np.zeros(3)
    eye = np.eye(3)
    rots = _rots(laser_q)
    rlb = quat.to_matrix(_t(q_lb)).numpy()
    for i in range(w - 1):
        dt12 = float(sum_dts[i])
        dt23 = float(sum_dts[i + 1])
        dp12, dp23 = delta_ps[i], delta_ps[i + 1]
        dv12 = delta_vs[i]
        pl1, pl2, pl3 = laser_p[i], laser_p[i + 1], laser_p[i + 2]
        rl1, rl2, rl3 = rots[i], rots[i + 1], rots[i + 2]
        tmp_a = 0.5 * eye * (dt12 * dt12 * dt23 + dt23 * dt23 * dt12)
        tmp_b = (
            (pl2 - pl1) * dt23 - (pl3 - pl2) * dt12
            + (rl2 - rl1) @ t_lb * dt23 - (rl3 - rl2) @ t_lb * dt12
            + rl2 @ rlb @ dp23 * dt12 + rl1 @ rlb @ dv12 * dt12 * dt23
            - rl1 @ rlb @ dp12 * dt23
        )
        a += tmp_a.T @ tmp_a
        b -= tmp_a.T @ tmp_b
    g = np.linalg.solve(a * 1e4, b * 1e4)
    return g, bool(abs(np.linalg.norm(g) - g_norm) <= 1.0)


def refine_gravity_acc_bias(laser_p, laser_q, q_lb, t_lb, sum_dts, delta_ps, delta_vs,
                            g_approx, g_norm: float):
    """Velocity + gravity refinement (ImuInitializer.cc:174-308).
    Returns (velocities (W+1, 3), g_refined (3,), R_WI (3,3))."""
    n_frames = len(laser_p)
    num_states = n_frames * 3 + 2
    g = g_approx / np.linalg.norm(g_approx) * g_norm
    rots = _rots(laser_q)
    rlb = quat.to_matrix(_t(q_lb)).numpy()
    eye = np.eye(3)
    x = np.zeros(num_states)
    for _ in range(5):
        lxly = tangent_basis(g)
        a = np.zeros((num_states, num_states))
        b = np.zeros(num_states)
        for i in range(n_frames - 1):
            dt12 = float(sum_dts[i])
            dp12, dv12 = delta_ps[i], delta_vs[i]
            pl1, pl2 = laser_p[i], laser_p[i + 1]
            rl1, rl2 = rots[i], rots[i + 1]
            tmp_a = np.zeros((6, 8))
            tmp_b = np.zeros(6)
            tmp_a[0:3, 0:3] = dt12 * eye
            tmp_a[0:3, 6:8] = 0.5 * lxly * dt12 * dt12
            tmp_b[0:3] = pl2 - pl1 - rl1 @ rlb @ dp12 - (rl1 - rl2) @ t_lb - 0.5 * g * dt12 * dt12
            tmp_a[3:6, 0:3] = eye
            tmp_a[3:6, 3:6] = -eye
            tmp_a[3:6, 6:8] = lxly * dt12
            tmp_b[3:6] = -rl1 @ rlb @ dv12 - g * dt12
            r_a = tmp_a.T @ tmp_a
            r_b = tmp_a.T @ tmp_b
            a[i * 3:i * 3 + 6, i * 3:i * 3 + 6] += r_a[0:6, 0:6]
            b[i * 3:i * 3 + 6] += r_b[0:6]
            a[-2:, -2:] += r_a[6:8, 6:8]
            b[-2:] += r_b[6:8]
            a[i * 3:i * 3 + 6, -2:] += r_a[0:6, 6:8]
            a[-2:, i * 3:i * 3 + 6] += r_a[6:8, 0:6]
        x = np.linalg.solve(a * 1000.0, b * 1000.0)
        g = g + lxly @ x[-2:]
        g = g / np.linalg.norm(g) * g_norm

    # R_WI: rotation taking gI = (0,0,-1) to the refined gravity direction
    gi = np.array([0.0, 0.0, -1.0])
    gw = g / np.linalg.norm(g)
    v = np.cross(gi, gw)
    v_norm = np.linalg.norm(v)
    ang = np.arctan2(v_norm, gi @ gw)
    if v_norm < 1e-12:
        r_wi = np.eye(3)
    else:
        from scipy.spatial.transform import Rotation
        r_wi = Rotation.from_rotvec(ang * v / v_norm).as_matrix()
    return x[: n_frames * 3].reshape(n_frames, 3), g, r_wi


def check_imu_observibility(delta_vs: np.ndarray, sum_dts: np.ndarray) -> bool:
    """IMU excitation variance gate (Estimator.cc:860-894): std(g_est) > 0.25."""
    gs = np.stack([delta_vs[i] / float(sum_dts[i]) for i in range(len(sum_dts))])
    var = np.sqrt(np.mean(np.sum((gs - gs.mean(axis=0)) ** 2, axis=-1)))
    return bool(var > 0.25)
