"""Sliding-window Gauss-Newton/LM solver (port of lio_mapping_tpu.ops.solver).

Reference: Estimator::SolveOptimization's Ceres problem (Estimator.cc:
1648-2040) as dense LM on the (15(S+1)+6)-dim system: marginalization
prior, IMU factors, pivot point-plane factors (CauchyLoss 1.0) and the
optional extrinsic prior. State layout (S = opt_window_size):
    [pose_0..pose_S (6 each) | sb_0..sb_S (9 each) | ex (6)]
pose_0 is the pivot.

The LM ``while_loop`` is a Python loop: its exit test reads one device
flag per iteration (one host sync per LM iteration).

``psum_axis`` (a ``parallel.multihost.Mesh``): the plane rows are this
rank's shard; their normal equations (and cost) are summed over the ranks
with one ``all_reduce`` per evaluation, so every rank runs the same LM.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel import multihost as MH
from ..utils import quaternion as quat
from ..utils.tree import tree_map
from . import factors as FA
from . import marginalization as MG
from .preintegration import Preintegration


class OptStates(NamedTuple):
    """Optimization window states (body frame), leading dim S+1."""

    q: torch.Tensor     # (S+1, 4)
    p: torch.Tensor     # (S+1, 3)
    sb: torch.Tensor    # (S+1, 9) [v, ba, bg]
    ex_q: torch.Tensor  # (4,) laser->body rotation
    ex_p: torch.Tensor  # (3,)


class PlaneFactors(NamedTuple):
    """Pivot point-plane features for opt frames 1..S (leading dim S)."""

    point: torch.Tensor  # (S, F, 3)
    coeff: torch.Tensor  # (S, F, 4)
    mask: torch.Tensor   # (S, F)


class SolveDiagnostics(NamedTuple):
    cost_marg: torch.Tensor
    cost_imu: torch.Tensor
    cost_plane: torch.Tensor
    n_plane: torch.Tensor
    iterations: torch.Tensor


class PlaneGroup(NamedTuple):
    """Block-sparse plane rows: each touches (pivot pose, a frame pose,
    extrinsic). Cauchy scaling is applied; ``w`` is the 0/1 validity."""

    jp: torch.Tensor   # (S, F, 6)
    ji: torch.Tensor   # (S, F, 6)
    jex: torch.Tensor  # (S, F, 6)
    r: torch.Tensor    # (S, F)
    w: torch.Tensor    # (S, F)


def _layout(s: int):
    pose_off = 0
    sb_off = 6 * (s + 1)
    ex_off = sb_off + 9 * (s + 1)
    return pose_off, sb_off, ex_off, ex_off + 6


def _plane_group(planes: PlaneFactors, x: OptStates, p_i, q_i, cauchy_scale: float):
    res, (j_piv, j_i, j_ex) = FA.pivot_point_plane_factor(
        planes.point, planes.coeff, x.p[0], x.q[0], p_i, q_i, x.ex_p, x.ex_q)
    r_scale, j_scale = FA.cauchy_scaling(res * res, cauchy_scale)
    js = j_scale[..., None]
    return PlaneGroup(jp=j_piv * js, ji=j_i * js, jex=j_ex * js, r=res * r_scale,
                      w=planes.mask.to(res.dtype))


def _evaluate(x: OptStates, pres: Preintegration, g_vec, planes: PlaneFactors,
              prior: MG.PriorState, ex_prior, cfg_flags: dict, s: int,
              planes_extra: PlaneFactors = None):
    """Residuals + Jacobians for all factor groups: dense groups as
    (J (N, D), r (N,), w (N,)), plane groups as :class:`PlaneGroup`."""
    dtype, dev = x.p.dtype, x.p.device
    pose_off, sb_off, ex_off, dim = _layout(s)
    out = {}

    # marginalization prior
    n = 15 * s + 6
    r_marg = MG.prior_residual(prior, x.q[:s], x.p[:s], x.sb[:s], x.ex_q, x.ex_p)
    lj = prior.lin_jac
    j_marg = torch.cat([lj[:, :6 * s], lj.new_zeros((n, 6)), lj[:, 6 * s:15 * s],
                        lj.new_zeros((n, 9)), lj[:, 15 * s:]], dim=1)
    w_marg = torch.where(prior.valid, torch.ones((n,), dtype=dtype, device=dev),
                         torch.zeros((n,), dtype=dtype, device=dev))
    out["marg"] = (j_marg, r_marg, w_marg)

    # IMU factors between consecutive opt frames (all S at once)
    sqrt_infos = cfg_flags.get("imu_sqrt_infos")
    if sqrt_infos is None:
        sqrt_infos = FA.sqrt_info_from_covariance(pres.covariance)
    sb = x.sb
    res_imu, (jp_i, jsb_i, jp_j, jsb_j) = FA.imu_factor(
        pres, g_vec,
        x.p[:-1], x.q[:-1], sb[:-1, 0:3], sb[:-1, 3:6], sb[:-1, 6:9],
        x.p[1:], x.q[1:], sb[1:, 0:3], sb[1:, 3:6], sb[1:, 6:9],
        sqrt_info=sqrt_infos)
    j_imu = torch.zeros((s, 15, dim), dtype=dtype, device=dev)
    for i in range(s):
        j_imu[i, :, pose_off + 6 * i:pose_off + 6 * i + 6] = jp_i[i]
        j_imu[i, :, sb_off + 9 * i:sb_off + 9 * i + 9] = jsb_i[i]
        j_imu[i, :, pose_off + 6 * (i + 1):pose_off + 6 * (i + 1) + 6] = jp_j[i]
        j_imu[i, :, sb_off + 9 * (i + 1):sb_off + 9 * (i + 1) + 9] = jsb_j[i]
    # skip pre-integrations spanning > 10 s (Estimator.cc:1799)
    w_imu = (pres.sum_dt < 10.0).to(dtype)[:, None].expand(s, 15).reshape(-1)
    out["imu"] = (j_imu.reshape(s * 15, dim), res_imu.reshape(-1), w_imu)

    # pivot point-plane factors (frames 1..S) with Cauchy
    cs = cfg_flags["cauchy_scale"]
    out["plane"] = _plane_group(planes, x, x.p[1:], x.q[1:], cs)
    # keep_features extra rows: all bound to (pivot, newest, ex)
    if planes_extra is not None:
        out["plane_extra"] = _plane_group(planes_extra, x, x.p[s], x.q[s], cs)

    # extrinsic prior (outdoor_64 profile)
    if ex_prior is not None:
        q_lb0, t_lb0 = ex_prior
        r_ex, j_ex6 = FA.prior_factor(x.ex_p, x.ex_q, t_lb0, q_lb0)
        j_exf = torch.zeros((6, dim), dtype=dtype, device=dev)
        j_exf[:, ex_off:ex_off + 6] = j_ex6
        out["ex_prior"] = (j_exf, r_ex, torch.ones((6,), dtype=dtype, device=dev))
    return out


def group_costs(groups):
    """Ceres-style 0.5 * sum r^2 per group (for the convergence gates)."""
    out = {}
    for k, g in groups.items():
        if isinstance(g, PlaneGroup):
            out[k] = 0.5 * torch.sum(g.w * g.r * g.r)
        else:
            _, r, w = g
            out[k] = 0.5 * torch.sum(w * r * r)
    return out


def _scatter_frame_blocks(h, g_vec, hblk, gblk, po, fo, ex, n_f):
    """Add (n_f, 18, 18) [pivot | frame i | ex] blocks into H and g, frame
    poses contiguous at [fo, fo + 6 n_f) (strip / block-diagonal updates,
    as the reference's blockwise scatter)."""
    dtype, dev = h.dtype, h.device
    h[po:po + 6, po:po + 6] += torch.sum(hblk[:, 0:6, 0:6], dim=0)
    h[po:po + 6, fo:fo + 6 * n_f] += hblk[:, 0:6, 6:12].permute(1, 0, 2).reshape(6, 6 * n_f)
    h[fo:fo + 6 * n_f, po:po + 6] += hblk[:, 6:12, 0:6].reshape(6 * n_f, 6)
    bd = torch.zeros((n_f, 6, n_f, 6), dtype=dtype, device=dev)
    ar = torch.arange(n_f, device=dev)
    bd[ar, :, ar, :] = hblk[:, 6:12, 6:12]
    h[fo:fo + 6 * n_f, fo:fo + 6 * n_f] += bd.reshape(6 * n_f, 6 * n_f)
    h[po:po + 6, ex:ex + 6] += torch.sum(hblk[:, 0:6, 12:18], dim=0)
    h[ex:ex + 6, po:po + 6] += torch.sum(hblk[:, 12:18, 0:6], dim=0)
    h[fo:fo + 6 * n_f, ex:ex + 6] += hblk[:, 6:12, 12:18].reshape(6 * n_f, 6)
    h[ex:ex + 6, fo:fo + 6 * n_f] += hblk[:, 12:18, 6:12].permute(1, 0, 2).reshape(6, 6 * n_f)
    h[ex:ex + 6, ex:ex + 6] += torch.sum(hblk[:, 12:18, 12:18], dim=0)
    g_vec[po:po + 6] += torch.sum(gblk[:, 0:6], dim=0)
    g_vec[fo:fo + 6 * n_f] += gblk[:, 6:12].reshape(6 * n_f)
    g_vec[ex:ex + 6] += torch.sum(gblk[:, 12:18], dim=0)


def _scatter_shared_block(h, g_vec, h18, g18, offs):
    """Add one 18x18 block over three 6-wide column blocks ``offs``."""
    for a, o1 in enumerate(offs):
        for b, o2 in enumerate(offs):
            h[o1:o1 + 6, o2:o2 + 6] += h18[6 * a:6 * a + 6, 6 * b:6 * b + 6]
        g_vec[o1:o1 + 6] += g18[6 * a:6 * a + 6]


def _psum_packed(parts, mesh):
    """``MH.psum`` of several tensors in one all_reduce."""
    flat = MH.psum(torch.cat([p.reshape(-1) for p in parts]), mesh)
    out, i = [], 0
    for p in parts:
        out.append(flat[i:i + p.numel()].reshape(p.shape))
        i += p.numel()
    return out


def assemble_normal_equations(groups, s: int, psum_axis: MH.Mesh = None):
    """(H, g, cost, group_costs[marg, imu, plane]) from evaluated groups;
    with ``psum_axis`` the plane rows' terms are summed over the ranks."""
    pose_off, sb_off, ex_off, dim = _layout(s)
    pg = groups["plane"]
    dtype, dev = pg.r.dtype, pg.r.device

    dense = [g for g in groups.values() if not isinstance(g, PlaneGroup)]
    js = torch.cat([g[0] for g in dense], dim=0)
    rs = torch.cat([g[1] for g in dense], dim=0)
    ws = torch.cat([g[2] for g in dense], dim=0)
    jw = js * ws[:, None]
    h_dense = jw.T @ js
    g_dense = jw.T @ rs
    cost_dense = 0.5 * torch.sum(ws * rs * rs)

    h = torch.zeros((dim, dim), dtype=dtype, device=dev)
    g_vec = torch.zeros((dim,), dtype=dtype, device=dev)
    jcat = torch.cat([pg.jp, pg.ji, pg.jex], dim=-1)  # (S, F, 18)
    jcw = jcat * pg.w[..., None]
    hblk = torch.einsum("sfi,sfj->sij", jcw, jcat)
    gblk = torch.einsum("sfi,sf->si", jcw, pg.r)
    cost_plane = 0.5 * torch.sum(pg.w * pg.r * pg.r)
    n_f = pg.r.shape[0]
    _scatter_frame_blocks(h, g_vec, hblk, gblk, pose_off, pose_off + 6, ex_off, n_f)

    pe = groups.get("plane_extra")
    if pe is not None:
        jcat_e = torch.cat([pe.jp, pe.ji, pe.jex], dim=-1)
        jcw_e = jcat_e * pe.w[..., None]
        h18 = torch.einsum("kfi,kfj->ij", jcw_e, jcat_e)
        g18 = torch.einsum("kfi,kf->i", jcw_e, pe.r)
        _scatter_shared_block(h, g_vec, h18, g18, (pose_off, pose_off + 6 * n_f, ex_off))
        cost_plane = cost_plane + 0.5 * torch.sum(pe.w * pe.r * pe.r)

    if psum_axis is not None:
        h, g_vec, cost_plane = _psum_packed((h, g_vec, cost_plane), psum_axis)
    h = h + h_dense
    g_vec = g_vec + g_dense
    cost = cost_dense + cost_plane
    costs = group_costs({k: g for k, g in groups.items() if not isinstance(g, PlaneGroup)})
    zero = torch.zeros((), dtype=dtype, device=dev)
    gc = torch.stack([costs.get("marg", zero), costs["imu"], cost_plane])
    return h, g_vec, cost, gc


def _retract(x: OptStates, dx: torch.Tensor, s: int) -> OptStates:
    """Apply a local step (PoseLocalParameterization: q * DeltaQ(dtheta))."""
    pose_off, sb_off, ex_off, _ = _layout(s)
    dpose = dx[pose_off:pose_off + 6 * (s + 1)].reshape(s + 1, 6)
    dsb = dx[sb_off:sb_off + 9 * (s + 1)].reshape(s + 1, 9)
    dex = dx[ex_off:ex_off + 6]
    return OptStates(
        q=quat.normalize(quat.qmul(x.q, quat.delta_q(dpose[:, 3:6]))),
        p=x.p + dpose[:, 0:3],
        sb=x.sb + dsb,
        ex_q=quat.normalize(quat.qmul(x.ex_q, quat.delta_q(dex[3:6]))),
        ex_p=x.ex_p + dex[0:3],
    )


def solve_window(x0: OptStates, pres: Preintegration, g_vec, planes: PlaneFactors,
                 prior: MG.PriorState, ex_prior, *, s: int, max_iterations: int = 10,
                 cauchy_scale: float = 1.0, opt_extrinsic, use_marg, eval0=None,
                 imu_sqrt_infos=None, planes_extra=None, psum_axis=None,
                 step_abort_deg: float = 0.05, step_abort_cm: float = 0.05,
                 ftol: float = 1e-6):
    """LM over the window. Returns (x_opt, diagnostics).

    ``eval0``: groups from an ``_evaluate`` at ``x0`` (with the marg weights
    already reflecting the effective prior validity), reused as the first
    evaluation. The loop exits when the relative cost drop of an accepted
    step falls below ``ftol`` or the pose step shrinks below the
    reference's GN abort thresholds (see the reference docstring)."""
    dtype, dev = x0.p.dtype, x0.p.device
    pose_off, sb_off, ex_off, dim = _layout(s)
    if imu_sqrt_infos is None:
        imu_sqrt_infos = FA.sqrt_info_from_covariance(pres.covariance)
    flags = {"cauchy_scale": cauchy_scale, "imu_sqrt_infos": imu_sqrt_infos}

    m = torch.ones((dim,), dtype=dtype, device=dev)
    m[ex_off:ex_off + 6] = torch.as_tensor(opt_extrinsic, device=dev).to(dtype)
    prior_used = prior._replace(valid=prior.valid & torch.as_tensor(use_marg, device=dev))

    def eval_all(x):
        return assemble_normal_equations(
            _evaluate(x, pres, g_vec, planes, prior_used, ex_prior, flags, s, planes_extra), s,
            psum_axis)

    if eval0 is not None:
        h, gv, cost, gc = assemble_normal_equations(eval0, s, psum_axis)
    else:
        h, gv, cost, gc = eval_all(x0)
    x = x0
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    eye_free = torch.diag(1.0 - m)
    rad2deg = 180.0 / math.pi
    it = 0
    while it < max_iterations:
        h_m = (h * m[None, :]) * m[:, None] + eye_free
        damped = h_m + lam * torch.diag(torch.clamp_min(torch.diagonal(h_m), 1e-6))
        dx = -torch.linalg.solve(damped, gv * m) * m
        x_new = _retract(x, dx, s)
        h2, g2, new_cost, gc2 = eval_all(x_new)
        accept = new_cost < cost
        x = tree_map(lambda a, b: torch.where(accept, a, b), x_new, x)
        h = torch.where(accept, h2, h)
        gv = torch.where(accept, g2, gv)
        gc = torch.where(accept, gc2, gc)
        dpose = dx[pose_off:pose_off + 6 * (s + 1)].reshape(s + 1, 6)
        dt_cm = torch.max(torch.linalg.norm(dpose[:, 0:3], dim=-1)) * 100.0
        dr_deg = torch.max(torch.linalg.norm(dpose[:, 3:6], dim=-1)) * rad2deg
        small = (dr_deg < step_abort_deg) & (dt_cm < step_abort_cm)
        done = (accept & (cost - new_cost <= ftol * cost)) | small
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8), lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        if bool(done):  # one host sync per LM iteration
            break

    n_plane = torch.sum(planes.mask)
    if planes_extra is not None:
        n_plane = n_plane + torch.sum(planes_extra.mask)
    if psum_axis is not None:
        n_plane = MH.psum(n_plane, psum_axis)
    diag = SolveDiagnostics(cost_marg=gc[0], cost_imu=gc[1], cost_plane=gc[2],
                            n_plane=n_plane, iterations=torch.tensor(it, device=dev))
    return x, diag


def marginalize_pivot(x: OptStates, pre_01: Preintegration, g_vec, planes: PlaneFactors,
                      prior: MG.PriorState, *, s: int, cauchy_scale: float = 1.0,
                      psum_axis: MH.Mesh = None,
                      planes_extra: PlaneFactors = None) -> MG.PriorState:
    """New prior by Schur-eliminating pose_0 + sb_0 (Estimator.cc:2152-2244):
    old prior, IMU factor (0, 1) and all plane factors at the post-solve
    states, in the full layout [pose_0 (6) | sb_0 (9) | keep (15S+6)]; with
    ``psum_axis`` the plane terms are summed over the ranks."""
    dtype, dev = x.p.dtype, x.p.device
    n = 15 * s + 6
    m = 15
    full = m + n

    def pose_col(i):
        return 0 if i == 0 else m + 6 * (i - 1)

    def sb_col(i):
        return 6 if i == 0 else m + 6 * s + 9 * (i - 1)

    ex_col = m + 15 * s

    # old prior with drop set {pose_0, sb_0}: its columns permuted into the
    # [drop | keep] layout
    r_marg = MG.prior_residual(prior, x.q[:s], x.p[:s], x.sb[:s], x.ex_q, x.ex_p)
    perm = []
    for i in range(s):
        perm.extend(range(pose_col(i), pose_col(i) + 6))
    for i in range(s):
        perm.extend(range(sb_col(i), sb_col(i) + 9))
    perm.extend(range(ex_col, ex_col + 6))
    jm_full = torch.zeros((n, full), dtype=dtype, device=dev)
    jm_full[:, torch.tensor(perm, device=dev)] = prior.lin_jac
    w_pr = prior.valid.to(dtype)
    a = w_pr * (jm_full.T @ jm_full)
    b = w_pr * (jm_full.T @ r_marg)

    # IMU factor (0, 1)
    res01, (jp0, jsb0, jp1, jsb1) = FA.imu_factor(
        pre_01, g_vec,
        x.p[0], x.q[0], x.sb[0, 0:3], x.sb[0, 3:6], x.sb[0, 6:9],
        x.p[1], x.q[1], x.sb[1, 0:3], x.sb[1, 3:6], x.sb[1, 6:9])
    w01 = (pre_01.sum_dt < 10.0).to(dtype)
    j01 = torch.zeros((15, full), dtype=dtype, device=dev)
    j01[:, pose_col(0):pose_col(0) + 6] = jp0
    j01[:, sb_col(0):sb_col(0) + 9] = jsb0
    j01[:, pose_col(1):pose_col(1) + 6] = jp1
    j01[:, sb_col(1):sb_col(1) + 9] = jsb1
    a = a + w01 * (j01.T @ j01)
    b = b + w01 * (j01.T @ res01)

    # plane factors of all frames (drop column = pose_0)
    def weighted(group_planes, p_i, q_i):
        res, (j_piv, j_i, j_ex) = FA.pivot_point_plane_factor(
            group_planes.point, group_planes.coeff, x.p[0], x.q[0], p_i, q_i, x.ex_p, x.ex_q)
        r_scale, j_scale = FA.cauchy_scaling(res * res, cauchy_scale)
        mask = group_planes.mask.to(dtype)
        jcw = torch.cat([j_piv, j_i, j_ex], dim=-1) * (mask * j_scale)[..., None]
        return jcw, mask * r_scale * res

    jcw, rw = weighted(planes, x.p[1:], x.q[1:])
    hblk = torch.einsum("sfi,sfj->sij", jcw, jcw)
    gblk = torch.einsum("sfi,sf->si", jcw, rw)
    a_pl = torch.zeros((full, full), dtype=dtype, device=dev)
    b_pl = torch.zeros((full,), dtype=dtype, device=dev)
    _scatter_frame_blocks(a_pl, b_pl, hblk, gblk, pose_col(0), m, ex_col, s)

    if planes_extra is not None:
        jcw_e, rw_e = weighted(planes_extra, x.p[s], x.q[s])
        h18 = torch.einsum("kfi,kfj->ij", jcw_e, jcw_e)
        g18 = torch.einsum("kfi,kf->i", jcw_e, rw_e)
        _scatter_shared_block(a_pl, b_pl, h18, g18, (pose_col(0), m + 6 * (s - 1), ex_col))

    if psum_axis is not None:
        a_pl, b_pl = _psum_packed((a_pl, b_pl), psum_axis)
    a = a + a_pl
    b = b + b_pl
    a_new, b_new = MG.schur_marginalize(a, b, m)
    lin_jac, lin_res = MG.factorize_prior(a_new, b_new)
    return MG.PriorState(lin_jac=lin_jac, lin_res=lin_res, x0_q=x.q[1:], x0_p=x.p[1:],
                         x0_sb=x.sb[1:], x0_ex_q=x.ex_q, x0_ex_p=x.ex_p,
                         valid=torch.tensor(True, device=dev))
