"""IMU midpoint preintegration (port of lio_mapping_tpu.ops.preintegration).

Reference: IntegrationBase.h:127-209 (VINS-Mono midpoint integration with
lio-mapping's exact discrete F (15x15) and V (15x18), including its -0.1667
third-order term and the 0.5 position-noise entries). State order
[p, theta, v, ba, bg]; 18-dim noise. Samples are fixed-capacity buffers
with dt=0 padding (a dt=0 step is an exact no-op).

``integrate`` is the batched form: the quaternion chain and the F products
are log-depth prefix scans (Hillis-Steele over the sample axis), the
velocity/position deltas cumulative sums, the covariance one suffix-
transported einsum; it equals the sequential recursion up to rounding.
The Euler scheme is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import quaternion as quat

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class ImuSamples(NamedTuple):
    """Fixed-capacity per-frame IMU buffer (dt=0 rows are padding)."""

    acc0: torch.Tensor  # (3,)
    gyr0: torch.Tensor  # (3,)
    dt: torch.Tensor    # (M,)
    acc: torch.Tensor   # (M, 3)
    gyr: torch.Tensor   # (M, 3)

    @staticmethod
    def empty(capacity: int, dtype=torch.float32, device=None) -> "ImuSamples":
        z = dict(dtype=dtype, device=device)
        return ImuSamples(torch.zeros(3, **z), torch.zeros(3, **z), torch.zeros(capacity, **z),
                          torch.zeros((capacity, 3), **z), torch.zeros((capacity, 3), **z))


def pack_samples_np(dts, accs, gyrs, acc0, gyr0, capacity: int):
    """One frame's IMU batch as ONE (M+1, 7) f32 host array: row 0 =
    [0, acc0, gyr0]; rows 1..M = [dt, acc, gyr] (dt=0 padding)."""
    n = len(dts)
    if n > capacity:
        raise ValueError(f"too many IMU samples per frame: {n} > {capacity}")
    out = np.zeros((capacity + 1, 7), np.float32)
    out[0, 1:4] = acc0
    out[0, 4:7] = gyr0
    out[1:n + 1, 0] = dts
    out[1:n + 1, 1:4] = accs
    out[1:n + 1, 4:7] = gyrs
    return out


def merge_packed_np(buffers, capacity: int):
    """Merge consecutive packed (M+1, 7) buffers into one: row 0 from the
    first buffer, dt>0 rows concatenated in order (the skipped sweeps' IMU
    joins the next consumed interval, PointOdometry.cc:725-729)."""
    buffers = [np.asarray(b, np.float32) for b in buffers]
    out = np.zeros((capacity + 1, 7), np.float32)
    out[0] = buffers[0][0]
    n = 0
    for b in buffers:
        rows = b[1:][b[1:, 0] > 0]
        if n + len(rows) > capacity:
            raise ValueError(f"merged IMU samples exceed capacity: {n + len(rows)} > {capacity}")
        out[1 + n:1 + n + len(rows)] = rows
        n += len(rows)
    return out


def unpack_samples(packed: torch.Tensor) -> ImuSamples:
    """Inverse of :func:`pack_samples_np` on a (M+1, 7) tensor."""
    return ImuSamples(acc0=packed[0, 1:4], gyr0=packed[0, 4:7],
                      dt=packed[1:, 0], acc=packed[1:, 1:4], gyr=packed[1:, 4:7])


class Preintegration(NamedTuple):
    delta_p: torch.Tensor       # (3,)
    delta_q: torch.Tensor       # (4,) wxyz
    delta_v: torch.Tensor       # (3,)
    jacobian: torch.Tensor      # (15, 15)
    covariance: torch.Tensor    # (15, 15)
    sum_dt: torch.Tensor        # ()
    linearized_ba: torch.Tensor  # (3,)
    linearized_bg: torch.Tensor  # (3,)

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Preintegration":
        z = dict(dtype=dtype, device=device)
        return Preintegration(
            delta_p=torch.zeros(3, **z), delta_q=quat.identity(dtype, device),
            delta_v=torch.zeros(3, **z), jacobian=torch.eye(15, **z),
            covariance=torch.zeros((15, 15), **z), sum_dt=torch.zeros((), **z),
            linearized_ba=torch.zeros(3, **z), linearized_bg=torch.zeros(3, **z))


class PrefixStates(NamedTuple):
    """Per-sample prefix deltas from :func:`integrate`."""

    delta_q: torch.Tensor  # (M, 4)
    delta_p: torch.Tensor  # (M, 3)
    delta_v: torch.Tensor  # (M, 3)
    cum_dt: torch.Tensor   # (M,)


def noise_matrix(acc_n: float, gyr_n: float, acc_w: float, gyr_w: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """18x18 continuous noise diag (IntegrationBase.h:94-100)."""
    d = [acc_n**2] * 3 + [gyr_n**2] * 3 + [acc_n**2] * 3 + [gyr_n**2] * 3 \
        + [acc_w**2] * 3 + [gyr_w**2] * 3
    return torch.diag(torch.tensor(d, dtype=dtype, device=device))


def _scan(x: torch.Tensor, combine, reverse: bool = False) -> torch.Tensor:
    """Inclusive log-depth scan over axis 0. ``combine(earlier, later)``
    composes two adjacent ranges; with ``reverse`` each element covers
    itself and everything after it."""
    n = x.shape[0]
    s = 1
    while s < n:
        if reverse:
            x = torch.cat([combine(x[:-s], x[s:]), x[n - s:]], dim=0)
        else:
            x = torch.cat([x[:s], combine(x[:-s], x[s:])], dim=0)
        s *= 2
    return x


def _prev_samples(samples: ImuSamples):
    """Previous sample per step, forward-filling the last valid one (pads
    keep the previous sample, as the sequential scan's carry)."""
    m = samples.dt.shape[0]
    idx = torch.arange(m, device=samples.dt.device)
    last_valid = torch.where(samples.dt != 0, idx, -1)
    prev_idx = torch.cat([torch.full((1,), -1, device=idx.device, dtype=idx.dtype),
                          torch.cummax(last_valid, dim=0).values[:-1]])
    acc_all = torch.cat([samples.acc0[None, :], samples.acc], dim=0)
    gyr_all = torch.cat([samples.gyr0[None, :], samples.gyr], dim=0)
    return acc_all[prev_idx + 1], gyr_all[prev_idx + 1]


def _mean_terms(samples: ImuSamples, ba, bg):
    dt = samples.dt
    dtype, dev = dt.dtype, dt.device
    acc_prev, gyr_prev = _prev_samples(samples)
    un_gyr = 0.5 * (gyr_prev + samples.gyr) - bg[None, :]
    dqs = quat.delta_q(un_gyr * dt[:, None])
    cum_q = quat.normalize(_scan(dqs, quat.qmul))
    q_entry = torch.cat([quat.identity(dtype, dev)[None, :], cum_q[:-1]], dim=0)
    a0 = acc_prev - ba[None, :]
    a1 = samples.acc - ba[None, :]
    # un_acc_1 is rotated by the PRE-normalization product q_entry (x) dq,
    # as the reference's midpoint step does
    un_acc = 0.5 * (quat.rotate(q_entry, a0) + quat.rotate(quat.qmul(q_entry, dqs), a1))
    dv_steps = un_acc * dt[:, None]
    dv_incl = torch.cumsum(dv_steps, dim=0)
    v_entry = dv_incl - dv_steps
    dp_steps = v_entry * dt[:, None] + 0.5 * un_acc * (dt * dt)[:, None]
    return un_gyr, cum_q, q_entry, a0, a1, dv_incl, dp_steps


def _step_matrices(dt, rot0, rot1, un_gyr, a0, a1, noise18):
    """Batched discrete F (M,15,15) and injected noise V N V^T (M,15,15)
    (IntegrationBase.h:150-200 layout)."""
    m = dt.shape[0]
    dtype, dev = dt.dtype, dt.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    r_w_x = quat.skew(un_gyr)
    r_a_0_x = quat.skew(a0)
    r_a_1_x = quat.skew(a1)
    d = dt[:, None, None]
    rot1_a1 = rot1 @ r_a_1_x

    f = torch.zeros((m, 15, 15), dtype=dtype, device=dev)
    f[:, O_P:O_P + 3, O_P:O_P + 3] = eye3
    f[:, O_P:O_P + 3, O_R:O_R + 3] = (
        -0.25 * rot0 @ r_a_0_x * d * d
        + -0.25 * rot1 @ r_a_1_x @ (eye3 - r_w_x * d) * d * d)
    f[:, O_P:O_P + 3, O_V:O_V + 3] = eye3 * d
    f[:, O_P:O_P + 3, O_BA:O_BA + 3] = -0.25 * (rot0 + rot1) * d * d
    # NOTE: reference uses -0.1667 (third-order), not -0.25 (IntegrationBase.h:173)
    f[:, O_P:O_P + 3, O_BG:O_BG + 3] = -0.1667 * rot1 @ r_a_1_x * d * d * -d
    f[:, O_R:O_R + 3, O_R:O_R + 3] = eye3 - r_w_x * d
    f[:, O_R:O_R + 3, O_BG:O_BG + 3] = -eye3 * d
    f[:, O_V:O_V + 3, O_R:O_R + 3] = (
        -0.5 * rot0 @ r_a_0_x * d
        + -0.5 * rot1 @ r_a_1_x @ (eye3 - r_w_x * d) * d)
    f[:, O_V:O_V + 3, O_V:O_V + 3] = eye3
    f[:, O_V:O_V + 3, O_BA:O_BA + 3] = -0.5 * (rot0 + rot1) * d
    f[:, O_V:O_V + 3, O_BG:O_BG + 3] = -0.5 * rot1 @ r_a_1_x * d * -d
    f[:, O_BA:O_BA + 3, O_BA:O_BA + 3] = eye3
    f[:, O_BG:O_BG + 3, O_BG:O_BG + 3] = eye3

    v = torch.zeros((m, 15, 18), dtype=dtype, device=dev)
    v[:, O_P:O_P + 3, 0:3] = 0.5 * rot0 * d * d
    v[:, O_P:O_P + 3, 3:6] = 0.25 * -rot1_a1 * d * d * 0.5 * d
    v[:, O_P:O_P + 3, 6:9] = 0.5 * rot1 * d * d
    v[:, O_P:O_P + 3, 9:12] = 0.25 * -rot1_a1 * d * d * 0.5 * d
    v[:, O_R:O_R + 3, 3:6] = 0.5 * eye3 * d
    v[:, O_R:O_R + 3, 9:12] = 0.5 * eye3 * d
    v[:, O_V:O_V + 3, 0:3] = 0.5 * rot0 * d
    v[:, O_V:O_V + 3, 3:6] = 0.5 * -rot1_a1 * d * 0.5 * d
    v[:, O_V:O_V + 3, 6:9] = 0.5 * rot1 * d
    v[:, O_V:O_V + 3, 9:12] = 0.5 * -rot1_a1 * d * 0.5 * d
    v[:, O_BA:O_BA + 3, 12:15] = eye3 * d
    v[:, O_BG:O_BG + 3, 15:18] = eye3 * d
    g = v @ noise18 @ v.transpose(1, 2)
    return f, g


def integrate(samples: ImuSamples, ba, bg, noise18, with_prefixes: bool = False):
    """Batched integration of a full buffer (Propagate/Repropagate);
    with ``with_prefixes`` also the per-sample :class:`PrefixStates`."""
    dt = samples.dt
    dtype, dev = dt.dtype, dt.device
    un_gyr, cum_q, q_entry, a0, a1, dv_incl, dp_steps = _mean_terms(samples, ba, bg)
    dp_incl = torch.cumsum(dp_steps, dim=0)

    rot0 = quat.to_matrix(q_entry)
    rot1 = quat.to_matrix(cum_q)
    fs, gs = _step_matrices(dt, rot0, rot1, un_gyr, a0, a1, noise18)
    # bias Jacobian F_{M-1} ... F_0; suffix[k] = F_{M-1} ... F_k
    prefix = _scan(fs, lambda a, b: b @ a)
    suffix = _scan(fs, lambda a, b: b @ a, reverse=True)
    phi = torch.cat([suffix[1:], torch.eye(15, dtype=dtype, device=dev)[None]], dim=0)
    covariance = torch.einsum("kij,kjl,kml->im", phi, gs, phi)

    pre = Preintegration(
        delta_p=dp_incl[-1], delta_q=cum_q[-1], delta_v=dv_incl[-1],
        jacobian=prefix[-1], covariance=covariance, sum_dt=torch.sum(dt),
        linearized_ba=ba, linearized_bg=bg)
    if not with_prefixes:
        return pre
    return pre, PrefixStates(delta_q=cum_q, delta_p=dp_incl, delta_v=dv_incl,
                             cum_dt=torch.cumsum(dt, dim=0))


def integrate_mean(samples: ImuSamples, ba, bg) -> Preintegration:
    """Mean-only integration (delta_q/p/v); ``jacobian`` is identity and
    ``covariance`` zeros and must not be consumed (the skipped-sweep IMU
    prediction reads only the means)."""
    dtype, dev = samples.dt.dtype, samples.dt.device
    _, cum_q, _, _, _, dv_incl, dp_steps = _mean_terms(samples, ba, bg)
    return Preintegration(
        delta_p=torch.sum(dp_steps, dim=0), delta_q=cum_q[-1], delta_v=dv_incl[-1],
        jacobian=torch.eye(15, dtype=dtype, device=dev),
        covariance=torch.zeros((15, 15), dtype=dtype, device=dev),
        sum_dt=torch.sum(samples.dt), linearized_ba=ba, linearized_bg=bg)


def integrate_euler(samples: ImuSamples, ba, bg, noise12) -> Preintegration:
    """The first-order Euler scheme (reference preintegration.py:475-553):
    not ported yet."""
    raise NotImplementedError("the Euler preintegration scheme is not ported yet")


def state_at_offset(prefixes: PrefixStates, t_offset, q0, p0, v0, g_vec):
    """World state at the first sample time >= ``t_offset`` into the
    interval (reference Estimator.cc:628-640 stamped-transform lookup)."""
    dtype, dev = p0.dtype, p0.device
    t_offset = torch.as_tensor(t_offset, dtype=dtype, device=dev)
    k = torch.argmax((prefixes.cum_dt >= t_offset).to(torch.uint8))
    at_start = t_offset <= 0
    t = torch.where(at_start, torch.zeros((), dtype=dtype, device=dev), prefixes.cum_dt[k])
    dq = torch.where(at_start, quat.identity(dtype, dev), prefixes.delta_q[k])
    dp = torch.where(at_start, torch.zeros(3, dtype=dtype, device=dev), prefixes.delta_p[k])
    dv = torch.where(at_start, torch.zeros(3, dtype=dtype, device=dev), prefixes.delta_v[k])
    q = quat.normalize(quat.qmul(q0, dq))
    v = v0 + g_vec * t + quat.rotate(q0, dv)
    p = p0 + v0 * t + 0.5 * g_vec * t * t + quat.rotate(q0, dp)
    return q, p, v


def apply_deltas(pre: Preintegration, q0, p0, v0, g_vec):
    """World-state propagation from the preintegrated deltas
    (Estimator.cc:387-394)."""
    t = pre.sum_dt
    q = quat.normalize(quat.qmul(q0, pre.delta_q))
    v = v0 + g_vec * t + quat.rotate(q0, pre.delta_v)
    p = p0 + v0 * t + 0.5 * g_vec * t * t + quat.rotate(q0, pre.delta_p)
    return q, p, v


def evaluate(pre: Preintegration, g_vec, p_i, q_i, v_i, ba_i, bg_i,
             p_j, q_j, v_j, ba_j, bg_j) -> torch.Tensor:
    """15-dim preintegration residual (IntegrationBase.h:309-357)."""
    jac = pre.jacobian
    dp_dba = jac[..., O_P:O_P + 3, O_BA:O_BA + 3]
    dp_dbg = jac[..., O_P:O_P + 3, O_BG:O_BG + 3]
    dq_dbg = jac[..., O_R:O_R + 3, O_BG:O_BG + 3]
    dv_dba = jac[..., O_V:O_V + 3, O_BA:O_BA + 3]
    dv_dbg = jac[..., O_V:O_V + 3, O_BG:O_BG + 3]

    def mv(m, x):
        return (m @ x[..., None])[..., 0]

    dba = ba_i - pre.linearized_ba
    dbg = bg_i - pre.linearized_bg
    corrected_delta_q = quat.qmul(pre.delta_q, quat.delta_q(mv(dq_dbg, dbg)))
    corrected_delta_v = pre.delta_v + mv(dv_dba, dba) + mv(dv_dbg, dbg)
    corrected_delta_p = pre.delta_p + mv(dp_dba, dba) + mv(dp_dbg, dbg)

    qi_inv = quat.conjugate(quat.normalize(q_i))
    sum_dt = pre.sum_dt[..., None]
    r_p = quat.rotate(qi_inv, -0.5 * g_vec * sum_dt * sum_dt + p_j - p_i - v_i * sum_dt) \
        - corrected_delta_p
    r_q = 2.0 * quat.qmul(quat.conjugate(quat.normalize(corrected_delta_q)),
                          quat.qmul(qi_inv, quat.normalize(q_j)))[..., 1:4]
    r_v = quat.rotate(qi_inv, -g_vec * sum_dt + v_j - v_i) - corrected_delta_v
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)
