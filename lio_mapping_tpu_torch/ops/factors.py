"""Factor library: residuals + analytic local-frame Jacobians
(port of the factors of lio_mapping_tpu.ops.factors that the window solver
uses). Jacobians are w.r.t. local coordinates: 6 per pose [dp, dtheta],
9 per speed-bias, with the reference's ``q * DeltaQ(dtheta)`` update.

Every factor broadcasts over leading batch dimensions (the reference vmaps
them), so the solver evaluates all frames and features in one call.

* ``imu_factor``               -> include/factor/ImuFactor.h:44-175
* ``pivot_point_plane_factor`` -> src/factor/PivotPointPlaneFactor.cc:43-137
* ``prior_factor``             -> src/factor/PriorFactor.cc:35-67
* ``cauchy_scaling``           -> Ceres CauchyLoss(1.0), Triggs correction
"""

from __future__ import annotations

import torch

from ..utils import quaternion as quat
from . import preintegration as PI
from .preintegration import O_BA, O_BG, O_P, O_R, O_V, Preintegration


def chol_unrolled(a: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky-Crout of small SPD matrices (..., n, n), with the
    reference's 1e-30 pivot floor."""
    n = a.shape[-1]
    l = torch.zeros_like(a)
    rows = torch.arange(n, device=a.device)
    for j in range(n):
        v = a[..., :, j] - (l @ l[..., j, :, None])[..., 0]
        d = torch.sqrt(torch.clamp_min(v[..., j:j + 1], 1e-30))
        l[..., :, j] = torch.where(rows >= j, v / d, torch.zeros_like(v))
    return l


def tri_lower_inverse(l: torch.Tensor) -> torch.Tensor:
    """Unrolled forward substitution: inverse of lower-triangular (..., n, n)."""
    n = l.shape[-1]
    w = torch.zeros_like(l)
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    for i in range(n):
        w[..., i, :] = (eye[i] - (l[..., i, None, :] @ w)[..., 0, :]) / l[..., i, i, None]
    return w


def sqrt_info_from_covariance(cov: torch.Tensor) -> torch.Tensor:
    """Whitening W with W^T W = cov^-1: W = chol(cov)^-1 (ImuFactor.h:74-75
    up to a left-orthogonal factor, which leaves every cost unchanged)."""
    return tri_lower_inverse(chol_unrolled(0.5 * (cov + cov.transpose(-1, -2))))


def _mv(m, x):
    return (m @ x[..., None])[..., 0]


def _vm(x, m):
    return (x[..., None, :] @ m)[..., 0, :]


def _t(m):
    return m.transpose(-1, -2)


def _bmat(rows):
    """Assemble a block matrix from a list of rows of (..., 3, 3) blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def imu_residual(pre: Preintegration, g_vec, p_i, q_i, v_i, ba_i, bg_i,
                 p_j, q_j, v_j, ba_j, bg_j, sqrt_info: torch.Tensor) -> torch.Tensor:
    """Whitened 15-dim IMU residual."""
    res = PI.evaluate(pre, g_vec, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j)
    return _mv(sqrt_info, res)


def imu_factor(pre: Preintegration, g_vec, p_i, q_i, v_i, ba_i, bg_i,
               p_j, q_j, v_j, ba_j, bg_j, sqrt_info: torch.Tensor | None = None):
    """Whitened IMU residual (..., 15) + Jacobians (J_pose_i (...,15,6),
    J_sb_i (...,15,9), J_pose_j (...,15,6), J_sb_j (...,15,9))."""
    if sqrt_info is None:
        sqrt_info = sqrt_info_from_covariance(pre.covariance)
    res_w = imu_residual(pre, g_vec, p_i, q_i, v_i, ba_i, bg_i,
                         p_j, q_j, v_j, ba_j, bg_j, sqrt_info)

    jac = pre.jacobian
    dp_dba = jac[..., O_P:O_P + 3, O_BA:O_BA + 3]
    dp_dbg = jac[..., O_P:O_P + 3, O_BG:O_BG + 3]
    dq_dbg = jac[..., O_R:O_R + 3, O_BG:O_BG + 3]
    dv_dba = jac[..., O_V:O_V + 3, O_BA:O_BA + 3]
    dv_dbg = jac[..., O_V:O_V + 3, O_BG:O_BG + 3]

    qi = quat.normalize(q_i)
    qj = quat.normalize(q_j)
    ri_inv = _t(quat.to_matrix(qi))
    qi_inv = quat.conjugate(qi)
    qj_inv = quat.conjugate(qj)
    cdq = quat.qmul(pre.delta_q, quat.delta_q(_mv(dq_dbg, bg_i - pre.linearized_bg)))
    sdt = pre.sum_dt[..., None]

    z = torch.zeros_like(ri_inv)
    eye = torch.eye(3, dtype=ri_inv.dtype, device=ri_inv.device).expand(ri_inv.shape)
    a_p = quat.skew(quat.rotate(qi_inv, -0.5 * g_vec * sdt * sdt + p_j - p_i - v_i * sdt))
    a_r = -(quat.left_matrix(quat.qmul(qj_inv, qi)) @ quat.right_matrix(cdq))[..., :3, :3]
    a_v = quat.skew(quat.rotate(qi_inv, -g_vec * sdt + v_j - v_i))
    jp_i = _bmat([[-ri_inv, a_p], [z, a_r], [z, a_v], [z, z], [z, z]])

    b_r = -quat.left_matrix(quat.qmul(qj_inv, quat.qmul(qi, cdq)))[..., :3, :3] @ dq_dbg
    jsb_i = _bmat([
        [-ri_inv * sdt[..., None], -dp_dba, -dp_dbg],
        [z, z, b_r],
        [-ri_inv, -dv_dba, -dv_dbg],
        [z, -eye, z],
        [z, z, -eye],
    ])
    c_r = quat.left_matrix(quat.qmul(quat.conjugate(cdq), quat.qmul(qi_inv, qj)))[..., :3, :3]
    jp_j = _bmat([[ri_inv, z], [z, c_r], [z, z], [z, z], [z, z]])
    jsb_j = _bmat([[z, z, z], [z, z, z], [ri_inv, z, z], [z, eye, z], [z, z, eye]])
    return res_w, (sqrt_info @ jp_i, sqrt_info @ jsb_i, sqrt_info @ jp_j, sqrt_info @ jsb_j)


def _pivot_frames(p_pivot, q_pivot, p_i, q_i, t_lb, q_lb):
    q_pivot = quat.normalize(q_pivot)
    q_i = quat.normalize(q_i)
    q_lb = quat.normalize(q_lb)
    q_lp = quat.qmul(q_pivot, quat.conjugate(q_lb))
    p_lp = p_pivot - quat.rotate(q_lp, t_lb)
    q_li = quat.qmul(q_i, quat.conjugate(q_lb))
    p_li = p_i - quat.rotate(q_li, t_lb)
    q_lpi = quat.qmul(quat.conjugate(q_lp), q_li)
    p_lpi = quat.rotate(quat.conjugate(q_lp), p_li - p_lp)
    return q_pivot, q_i, q_lb, q_lpi, p_lpi


def pivot_point_plane_factor(point, coeff, p_pivot, q_pivot, p_i, q_i, t_lb, q_lb):
    """1-dim pivot-frame point-to-plane residual + Jacobians.

    ``point`` (..., F, 3) in frame i's laser coords; ``coeff`` (..., F, 4)
    plane [w, b] in the pivot laser frame; poses (..., 4)/(..., 3) are BODY
    poses (one per leading index, shared by the F rows) and the extrinsic
    (q_lb, t_lb) maps laser -> body. Returns (residual (..., F),
    (J_pivot, J_i, J_ex), each (..., F, 6))."""
    q_pivot, q_i, q_lb, q_lpi, p_lpi = _pivot_frames(p_pivot, q_pivot, p_i, q_i, t_lb, q_lb)
    w = coeff[..., :3]
    moved = quat.rotate(q_lpi[..., None, :], point) + p_lpi[..., None, :]
    residual = torch.sum(w * moved, dim=-1) + coeff[..., 3]

    ri = quat.to_matrix(q_i)
    rp = quat.to_matrix(q_pivot)
    rlb = quat.to_matrix(q_lb)
    rpt = _t(rp)
    m1 = rlb @ rpt                      # (..., 3, 3)
    m1ri = m1 @ ri
    m2 = rpt @ ri @ _t(rlb)
    tb = _mv(_t(rlb), t_lb)             # rlb^T t_lb
    dpp = _mv(rpt, p_i - p_pivot)       # rp^T (p_i - p_pivot)

    def vm(x, m):                       # x (..., F, 3) @ m (..., 3, 3)
        return _vm(x, m[..., None, :, :])

    def mv(m, x):
        return _mv(m[..., None, :, :], x)

    cr = quat.cross
    u = point - t_lb[..., None, :]
    wl = vm(w, rlb)
    m2u = mv(m2, u)
    j_pivot = torch.cat([-vm(w, m1), cr(wl, m2u) + cr(wl, dpp[..., None, :])], dim=-1)
    w3 = vm(w, m1ri)
    j_i = torch.cat([vm(w, m1),
                     -cr(w3, mv(_t(rlb), point)) + cr(w3, tb[..., None, :])], dim=-1)
    j_ex = torch.cat([
        w - vm(w, m1ri @ _t(rlb)),
        -cr(wl, m2u) + cr(vm(wl, rpt @ ri), mv(_t(rlb), u)) - cr(wl, dpp[..., None, :]),
    ], dim=-1)
    return residual, (j_pivot, j_i, j_ex)


def prior_factor(p, q, pos_prior, rot_prior):
    """6-dim extrinsic prior (PriorFactor.cc:35-67): sqrt_info =
    diag(1000 I3, 0.1 I3). Returns (residual (6,), J (6,6))."""
    dtype, dev = p.dtype, p.device
    q = quat.normalize(q)
    dq = quat.qmul(quat.conjugate(rot_prior), q)
    res = torch.cat([p - pos_prior, 2.0 * dq[1:4]])
    sqrt_info = torch.diag(torch.tensor([1000.0] * 3 + [0.1] * 3, dtype=dtype, device=dev))
    jac = torch.eye(6, dtype=dtype, device=dev)
    jac[3:6, 3:6] = quat.left_matrix(dq)[:3, :3]
    return sqrt_info @ res, sqrt_info @ jac


def cauchy_scaling(sq_norm: torch.Tensor, scale: float = 1.0):
    """Ceres CauchyLoss + Triggs correction for 1-dim residuals: Cauchy is
    concave, so both scalings reduce to sqrt(rho') (residual_scale,
    jac_scale)."""
    sqrt_rho1 = torch.sqrt(1.0 / (1.0 + sq_norm / (scale * scale)))
    return sqrt_rho1, sqrt_rho1
