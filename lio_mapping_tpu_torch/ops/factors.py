"""Factor library: residuals + analytic local-frame Jacobians
(port of lio_mapping_tpu.ops.factors). Jacobians are w.r.t. local
coordinates: 6 per pose [dp, dtheta], 9 per speed-bias, with the
reference's ``q * DeltaQ(dtheta)`` update.

The factors the window solver uses broadcast over leading batch dimensions
(the reference vmaps them), so the solver evaluates all frames and
features in one call:

* ``imu_factor``               -> include/factor/ImuFactor.h:44-175
* ``pivot_point_plane_factor`` -> src/factor/PivotPointPlaneFactor.cc:43-137
* ``prior_factor``             -> src/factor/PriorFactor.cc:35-67
* ``cauchy_scaling``           -> Ceres CauchyLoss(1.0), Triggs correction

The reference's unwired alternatives take one factor each, as its own do:
``point_distance_factor``, ``plane_projection_factor``,
``point_normal_covariance`` + ``plane_to_plane_factor`` (GICP),
``imu_gravity_factor`` + ``gravity_boxplus``.
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
    # made by fills, not uploaded from the host (the step runs in CUDA graphs)
    sqrt_info = torch.diag(torch.cat([torch.full((3,), 1000.0, dtype=dtype, device=dev),
                                      torch.full((3,), 0.1, dtype=dtype, device=dev)]))
    jac = torch.eye(6, dtype=dtype, device=dev)
    jac[3:6, 3:6] = quat.left_matrix(dq)[:3, :3]
    return sqrt_info @ res, sqrt_info @ jac


def point_distance_factor(point, coeff, p_i, q_i, t_lb, q_lb, sqrt_info: float = 100.0):
    """1-dim world-frame point-to-plane residual (PointDistanceFactor.cc:35-105):
    ``point`` (3,) in frame i's laser coords, ``coeff`` (4,) a world plane
    [w, b], fixed sqrt_info 100. Returns (residual (), (J_pose (6,), J_ex (6,)))."""
    q_i = quat.normalize(q_i)
    q_lb = quat.normalize(q_lb)
    q_li = quat.qmul(q_i, quat.conjugate(q_lb))
    p_li = p_i - quat.rotate(q_li, t_lb)
    w = coeff[:3]
    residual = w @ (quat.rotate(q_li, point) + p_li) + coeff[3]
    ri = quat.to_matrix(q_i)
    rlb = quat.to_matrix(q_lb)
    skew_pt = quat.skew(rlb.T @ point) - quat.skew(rlb.T @ t_lb)
    j_pose = torch.cat([w, -w @ ri @ skew_pt])
    j_ex = torch.cat([-w @ (ri @ rlb.T), w @ ri @ skew_pt])
    return sqrt_info * residual, (sqrt_info * j_pose, sqrt_info * j_ex)


def plane_projection_factor(coeff_i, coeff_j, score, p_i, q_i, p_j, q_j, t_lb, q_lb):
    """4-dim plane-transport residual (PlaneProjectionFactor.cc:35-148): a
    plane fitted in frame i's laser coords, moved into frame j and
    sign-normalised to b >= 0, against the plane fitted in frame j. The
    Jacobian of the offset w.r.t. P_j is the exact one (the reference's
    uses Rj^T there, :117). Returns (residual (4,),
    (J_i (4,6), J_j (4,6), J_ex (4,6)))."""
    dtype, dev = p_i.dtype, p_i.device
    ri = quat.to_matrix(quat.normalize(q_i))
    rj = quat.to_matrix(quat.normalize(q_j))
    rlb = quat.to_matrix(quat.normalize(q_lb))
    w_i = coeff_i[:3]
    v = p_j - p_i - (rj - ri) @ (rlb.T @ t_lb)
    pi_w = rlb @ rj.T @ ri @ rlb.T @ w_i
    pi_b = v @ (ri @ (rlb.T @ w_i)) + coeff_i[3]
    sign = torch.where(pi_b < 0, -1.0, 1.0).to(dtype)
    residual = score * (sign * torch.cat([pi_w, pi_b[None]]) - coeff_j)

    a = rlb.T @ w_i
    vv = p_j - p_i - rj @ (rlb.T @ t_lb)
    j_i = torch.zeros((4, 6), dtype=dtype, device=dev)
    j_i[3, 0:3] = -w_i @ rlb @ ri.T
    j_i[0:3, 3:6] = -rlb @ rj.T @ ri @ quat.skew(a)
    j_i[3, 3:6] = w_i @ rlb @ quat.skew(ri.T @ vv)
    j_j = torch.zeros((4, 6), dtype=dtype, device=dev)
    j_j[3, 0:3] = w_i @ rlb @ ri.T
    j_j[0:3, 3:6] = rlb @ quat.skew(rj.T @ ri @ a)
    j_j[3, 3:6] = w_i @ rlb @ ri.T @ rj @ quat.skew(rlb.T @ t_lb)
    j_ex = torch.zeros((4, 6), dtype=dtype, device=dev)
    j_ex[3, 0:3] = -w_i @ rlb @ ri.T @ (rj - ri) @ rlb.T
    j_ex[0:3, 3:6] = rlb @ rj.T @ ri @ quat.skew(a) - rlb @ quat.skew(rj.T @ ri @ a)
    j_ex[3, 3:6] = (-w_i @ rlb @ ri.T @ (rj - ri) @ quat.skew(rlb.T @ t_lb)
                    - w_i @ rlb @ quat.skew(ri.T @ v))
    s = score * sign
    return residual, (s * j_i, s * j_j, s * j_ex)


def point_normal_covariance(normal, gicp_epsilon: float = 0.001):
    """GICP covariance diag(eps, 1, 1) rotated so that x lies along the
    normal (FeatureManager.h:49-82, FeatureManager.cc:35-43)."""
    dtype, dev = normal.dtype, normal.device
    n = normal / torch.linalg.norm(normal)
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    vx = quat.skew(quat.cross(e1, n))
    # Rodrigues, the antiparallel case regularised
    r = torch.eye(3, dtype=dtype, device=dev) + vx + vx @ vx / torch.clamp_min(1.0 + e1 @ n, 1e-8)
    diag = torch.diag(torch.tensor([gicp_epsilon, 1.0, 1.0], dtype=dtype, device=dev))
    return r @ diag @ r.T


def plane_to_plane_factor(p_b_local, cov_b, p_a_local, cov_a, p_i, q_i, p_j, q_j, t_lb, q_lb):
    """3-dim GICP plane-to-plane residual (PlaneToPlaneFactor.cc:43-105):
    point b in frame i's laser coords, point a in frame j's, the frame-i
    registration error whitened by chol((R C_a R^T + C_b)^-1)^T, which is
    held constant (Gauss-Newton). Returns (residual (3,),
    (J_i (3,6), J_j (3,6), J_ex (3,6)))."""
    ri = quat.to_matrix(quat.normalize(q_i))
    rj = quat.to_matrix(quat.normalize(q_j))
    rlb = quat.to_matrix(quat.normalize(q_lb))
    r_li = ri @ rlb.T
    p_li = p_i - r_li @ t_lb
    r_lj = rj @ rlb.T
    p_lj = p_j - r_lj @ t_lb
    r_ba = r_li.T @ r_lj
    err = r_ba @ p_a_local + r_li.T @ (p_lj - p_li) - p_b_local

    m = torch.linalg.inv(r_ba @ cov_a @ r_ba.T + cov_b)
    sqrt_info = torch.linalg.cholesky(0.5 * (m + m.T)).T.detach()

    u = ri.T @ (r_lj @ p_a_local + p_lj - p_i)
    pa = quat.skew(rlb.T @ (p_a_local - t_lb))
    j_i = torch.cat([-rlb @ ri.T, rlb @ quat.skew(u)], dim=1)
    j_j = torch.cat([rlb @ ri.T, -rlb @ ri.T @ rj @ pa], dim=1)
    j_ex = torch.cat([torch.eye(3, dtype=p_i.dtype, device=p_i.device) - rlb @ ri.T @ rj @ rlb.T,
                      -rlb @ quat.skew(u) + rlb @ ri.T @ rj @ pa], dim=1)
    return sqrt_info @ err, (sqrt_info @ j_i, sqrt_info @ j_j, sqrt_info @ j_ex)


def imu_gravity_factor(pre: Preintegration, q_g, g_norm: float, p_i, q_i, v_i, ba_i, bg_i,
                       p_j, q_j, v_j, ba_j, bg_j, sqrt_info: torch.Tensor | None = None):
    """The IMU factor with gravity as an S^2 quaternion parameter
    (ImuGravityFactor.h:44-232, unwired in the reference too): g = R(q_g)
    (0, 0, -g_norm); the extra Jacobian is w.r.t. the 2-dim tangent of
    :func:`gravity_boxplus`. Returns (residual (15,), (J_pose_i, J_sb_i,
    J_pose_j, J_sb_j, J_gravity (15, 2)))."""
    dtype, dev = p_i.dtype, p_i.device
    g_i = torch.tensor([0.0, 0.0, -g_norm], dtype=dtype, device=dev)
    q_g = quat.normalize(q_g)
    if sqrt_info is None:
        sqrt_info = sqrt_info_from_covariance(pre.covariance)
    res_w, (jp_i, jsb_i, jp_j, jsb_j) = imu_factor(
        pre, quat.rotate(q_g, g_i), p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j,
        sqrt_info)
    # dg/du of q_g <- q_g DeltaQ([u; 0]): -R_wi [GI]x, its first two columns;
    # the residual carries -g, hence the sign against ImuGravityFactor.h:220-229
    sum_dt = pre.sum_dt
    ri_inv = quat.to_matrix(quat.normalize(q_i)).T
    dg_du = -(quat.to_matrix(q_g) @ quat.skew(g_i))[:, :2]
    j_g = torch.zeros((15, 2), dtype=dtype, device=dev)
    j_g[O_P:O_P + 3, :] = -0.5 * sum_dt * sum_dt * ri_inv @ dg_du
    j_g[O_V:O_V + 3, :] = -sum_dt * ri_inv @ dg_du
    return res_w, (jp_i, jsb_i, jp_j, jsb_j, sqrt_info @ j_g)


def gravity_boxplus(q_g, delta_xy):
    """S^2 retraction of a gravity quaternion, 4 global / 2 local
    (GravityLocalParameterization.cc:35-50): q <- q DeltaQ([dx, dy, 0])."""
    d = torch.cat([delta_xy, torch.zeros(1, dtype=delta_xy.dtype, device=delta_xy.device)])
    return quat.normalize(quat.qmul(q_g, quat.delta_q(d)))


def cauchy_scaling(sq_norm: torch.Tensor, scale: float = 1.0):
    """Ceres CauchyLoss + Triggs correction for 1-dim residuals: Cauchy is
    concave, so both scalings reduce to sqrt(rho') (residual_scale,
    jac_scale)."""
    sqrt_rho1 = torch.sqrt(1.0 / (1.0 + sq_norm / (scale * scale)))
    return sqrt_rho1, sqrt_rho1
