"""Tightly-coupled sliding-window LIO estimator
(port of lio_mapping_tpu.models.estimator; reference Estimator.cc).

One ``lio_step_impl`` call: preintegration of the new interval (with
prefixes), IMU-predicted deskew + stack downsample, window push, the pivot
local map, 5-NN plane association for frames pivot+1..W-1, the newest-frame
mini-GN (keep_features), convergence gates, the window LM, the yaw-gauge
fix and pivot marginalization.

The reference's variants are flags of ``EstimatorConfig``:

* ``use_corner`` (Estimator.h:55): corner stacks and a corner local map;
  each corner point adds two half-weighted plane-style rows from a 5-NN
  line fit. The corner search runs the plain tiled KNN on the card too
  (``make_knn5(..., force_tiled=True)``), as the reference pins it: a
  last-ulp near-tie flips the 5-NN set and the line-fit gate amplifies it.
* ``fix_map`` (Estimator.h:56): the local map is built at the frozen
  linearization poses (``qs_lin``/``ps_lin``); only the newest frame's is
  refreshed after the solve.
* ``cutoff_deskew``: the step takes the clouds as they come, without the
  IMU deskew.

The step is written as ``step_program``: stretches of device work and,
for the mini-GN's and the LM's early exits, conditional bodies (a round or
an iteration runs where its device flag says the loop has not stopped, as
the reference's ``lax.while_loop`` decides). ``lio_step_impl`` runs it
eagerly (``EagerRun``: the flags read on the host);
``models/step_graph.StepGraphs`` captures the whole program as one CUDA
graph whose bodies are conditional nodes, the port's counterpart of the
reference's one jitted program per sweep. The three ``eigh`` run on the
port's Householder + QL kernel (``ops/eigh.py``) and the surf searches go through
``ops.knn.knn``, which launches the CUDA KNN kernel on the card.

Distributed (``axis``, a ``parallel.multihost.Mesh``; see
``parallel/lio_dist.py``): every rank runs the step on the same inputs and
associates its slice of each stack's rows; the mini-GN's normal equations,
the gates' plane cost, the window LM and the marginalization sum their
plane terms over the ranks, so every rank ends with the same state. With
``map_shard`` the local map is rank-sliced too and the searches run the
ring KNN (``parallel/map_sharded.ring_knn``); the corner search stays on
the plain version there as well (the reference does not pin it on this
path; the port does).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import LioConfig
from ..ops import deskew as DS
from ..ops import factors as FA
from ..ops import gn as GN
from ..ops import knn as KNN
from ..ops import marginalization as MG
from ..ops import preintegration as PI
from ..ops import solver as SV
from ..ops import voxel as VX
from ..ops.cloud import Cloud
from ..ops.fits import line_fit, plane_fit, point_to_line_residual
from ..parallel import map_sharded as MS
from ..parallel import multihost as MH
from ..utils import quaternion as quat
from ..utils.se3 import Pose
from ..utils.tree import tree_leaves, tree_map


class EstimatorState(NamedTuple):
    """Sliding-window state; leading dim W1 = window_size + 1. Field order
    equals the reference's (the checkpoint bridge relies on it)."""

    qs: torch.Tensor      # (W1, 4) body orientation in world
    ps: torch.Tensor      # (W1, 3)
    vs: torch.Tensor      # (W1, 3)
    bas: torch.Tensor     # (W1, 3)
    bgs: torch.Tensor     # (W1, 3)
    pres: PI.Preintegration  # batched (W1,), pres[i] spans (i-1, i]
    imu: PI.ImuSamples       # batched (W1, M)
    surf_xyz: torch.Tensor   # (W1, C, 3) deskewed stacks, own laser frame
    surf_mask: torch.Tensor  # (W1, C)
    corner_xyz: torch.Tensor  # (W1, Cc, 3) (Cc=1 unless use_corner)
    corner_mask: torch.Tensor  # (W1, Cc)
    qs_lin: torch.Tensor     # (W1, 4) linearization poses (fix_map)
    ps_lin: torch.Tensor     # (W1, 3)
    prior: MG.PriorState
    g_vec: torch.Tensor   # (3,)
    q_lb: torch.Tensor    # (4,) laser->body extrinsic
    t_lb: torch.Tensor    # (3,)
    convergence_flag: torch.Tensor  # bool
    extrinsic_enabled: torch.Tensor  # bool


def init_state(cfg: LioConfig, dtype=torch.float32, device=None) -> EstimatorState:
    e = cfg.estimator
    w1 = e.window_size + 1
    z = dict(dtype=dtype, device=device)
    q_lb, t_lb = cfg.extrinsic_lb()
    eye_q = quat.identity(dtype, device).repeat(w1, 1)
    pre0 = PI.Preintegration.identity(dtype, device)
    imu0 = PI.ImuSamples.empty(e.imu.max_imu_per_frame, dtype, device)
    return EstimatorState(
        qs=eye_q,
        ps=torch.zeros((w1, 3), **z),
        vs=torch.zeros((w1, 3), **z),
        bas=torch.zeros((w1, 3), **z),
        bgs=torch.zeros((w1, 3), **z),
        pres=tree_map(lambda a: a.expand((w1,) + a.shape).clone(), pre0),
        imu=tree_map(lambda a: a.expand((w1,) + a.shape).clone(), imu0),
        surf_xyz=torch.zeros((w1, e.surf_stack_cap, 3), **z),
        surf_mask=torch.zeros((w1, e.surf_stack_cap), dtype=torch.bool, device=device),
        corner_xyz=torch.zeros((w1, e.corner_state_cap, 3), **z),
        corner_mask=torch.zeros((w1, e.corner_state_cap), dtype=torch.bool, device=device),
        qs_lin=eye_q.clone(),
        ps_lin=torch.zeros((w1, 3), **z),
        prior=MG.PriorState.empty(e.opt_window_size, dtype, device),
        g_vec=torch.tensor([0.0, 0.0, -e.imu.g_norm], **z),
        q_lb=q_lb.to(**z),
        t_lb=t_lb.to(**z),
        convergence_flag=torch.tensor(False, device=device),
        extrinsic_enabled=torch.tensor(e.opt_extrinsic and e.estimate_extrinsic != 0,
                                       device=device),
    )


def propagate_world(q0, p0, v0, ba, bg, g_vec, samples: PI.ImuSamples):
    """Midpoint world-state propagation over one frame's samples
    (Estimator.cc:387-394), one Python step per sample."""
    q, p, v = q0, p0, v0
    acc_prev, gyr_prev = samples.acc0, samples.gyr0
    for k in range(samples.dt.shape[0]):
        dt, acc, gyr = samples.dt[k], samples.acc[k], samples.gyr[k]
        un_acc_0 = quat.rotate(q, acc_prev - ba) + g_vec
        un_gyr = 0.5 * (gyr_prev + gyr) - bg
        q_new = quat.normalize(quat.qmul(q, quat.delta_q(un_gyr * dt)))
        un_acc_1 = quat.rotate(q_new, acc - ba) + g_vec
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        p = p + dt * v + 0.5 * dt * dt * un_acc
        v = v + dt * un_acc
        q = q_new
        is_pad = dt == 0
        acc_prev = torch.where(is_pad, acc_prev, acc)
        gyr_prev = torch.where(is_pad, gyr_prev, gyr)
    return q, p, v


def laser_pose(q_b, p_b, q_lb, t_lb) -> Pose:
    """Body pose -> laser pose: R_li = R_bi R_lb^-1, p_li = p_bi - R_li t_lb."""
    q_l = quat.qmul(q_b, quat.conjugate(q_lb))
    return Pose(q_l, p_b - quat.rotate(q_l, t_lb))


def _fov_ok(point_sel, local_q, local_t):
    """+-60 deg FOV cone check in the pivot frame (Estimator.cc:1063-1086)."""
    ten_z = point_sel.new_zeros(3)
    ten_z[2:3].fill_(10.0)  # [0, 0, 10] made on the device (no host-to-device copy)
    z_axis = quat.rotate(local_q, ten_z) + local_t
    sq1 = torch.sum((point_sel - local_t[None, :]) ** 2, dim=-1)
    sq2 = torch.sum((point_sel - z_axis[None, :]) ** 2, dim=-1)
    k = 10.0 * math.sqrt(3.0)
    check1 = 100.0 + sq1 - sq2 - k * torch.sqrt(sq1)
    check2 = 100.0 + sq1 - sq2 + k * torch.sqrt(sq1)
    return (check1 < 0) & (check2 > 0)


def make_knn5(map_xyz, map_mask, cfg: LioConfig, axis: MH.Mesh = None,
              force_tiled: bool = False):
    """5-NN closure over a local map: (point_sel, sel_mask) ->
    (sq_d (N,5), neighbors (N,5,3)). On the card the search runs the CUDA
    kernel with the AABB gate at ``min_match_sq_dis``; ``force_tiled``
    keeps it on the plain tiled version (the corner map's search). With
    ``axis`` the map is this rank's block of a map sharded over the mesh,
    searched by the ring KNN (``force_tiled`` reaches every ring step)."""
    e = cfg.estimator
    if axis is not None:
        def knn5_ring(point_sel, sel_mask):
            sq_d, _, neighbors = MS.ring_knn(point_sel, sel_mask, map_xyz, map_mask, k=5,
                                             axis=axis, prune_beyond=e.min_match_sq_dis,
                                             force_tiled=force_tiled)
            return sq_d, neighbors
        return knn5_ring

    def knn5(point_sel, sel_mask):
        sq_d, idx = KNN.knn(point_sel, sel_mask, map_xyz, map_mask, k=5,
                            prune_beyond=e.min_match_sq_dis, force_tiled=force_tiled)
        return sq_d, map_xyz[idx.to(torch.int64)]
    return knn5


def _surf_rows(knn5, point_sel, sel_mask, in_fov, cfg: LioConfig):
    """Row-wise 5-NN plane association core (Estimator.cc:1014-1097)."""
    e = cfg.estimator
    sq_d, neighbors = knn5(point_sel, sel_mask)
    nn_ok = sq_d[:, 4] < e.min_match_sq_dis
    w, d, plane_ok = plane_fit(neighbors, nn_ok, e.min_plane_dis)
    pd2 = torch.sum(w * point_sel, dim=-1) + d
    rng = torch.sqrt(torch.clamp_min(torch.linalg.norm(point_sel, dim=-1), 1e-12))
    s = 1.0 - 0.9 * torch.abs(pd2) / rng
    ok = sel_mask & nn_ok & plane_ok & (s > 0.1) & in_fov
    coeff = torch.cat([s[:, None] * w, (s * d)[:, None]], dim=-1)
    return coeff, s, ok


def _calculate_features(knn5, stack_xyz, stack_mask, local_q, local_t, cfg: LioConfig):
    """Batched 5-NN plane association of one frame's stack (moved into the
    pivot frame by (local_q, local_t)). Returns (coeff (C,4), score, ok)."""
    point_sel = quat.rotate(local_q[None, :], stack_xyz) + local_t[None, :]
    in_fov = _fov_ok(point_sel, local_q, local_t)
    return _surf_rows(knn5, point_sel, stack_mask, in_fov, cfg)


def _corner_rows(knn5, point_sel, sel_mask, in_fov, cfg: LioConfig):
    """Row-wise corner association core (Estimator.cc:1099-1232): 5-NN line
    fit (accepted when l_max > 3 l_mid), then the point-to-line constraint
    as TWO half-weighted plane-style rows: one along the normal from the
    line to the point (it carries the distance), one along
    ``(X1 - X2) x normal`` (not normalised, |.| = 0.2, as the reference).
    Returns (coeff1 (N,4), coeff2 (N,4), s (N,), ok (N,))."""
    e = cfg.estimator
    sq_d, neighbors = knn5(point_sel, sel_mask)
    nn_ok = sq_d[:, 4] < e.min_match_sq_dis
    centroid, direction, line_ok = line_fit(neighbors, nn_ok)
    ld2, n = point_to_line_residual(point_sel, centroid, direction)
    # (X1 - X2) x normal with X1/2 = c +- 0.1 u (Estimator.cc:1160)
    ncp = quat.cross(0.2 * direction, n)
    point_proj = point_sel - n * ld2[:, None]
    ld_p1 = -torch.sum(n * point_proj, dim=-1)
    ld_p2 = -torch.sum(ncp * point_proj, dim=-1)
    s = 1.0 - 0.9 * torch.abs(ld2)
    ok = sel_mask & nn_ok & line_ok & (s > 0.1) & in_fov
    # score and coefficients carry an extra 0.5 (Estimator.cc:1216-1228)
    coeff1 = 0.5 * torch.cat([s[:, None] * n, (s * ld_p1)[:, None]], dim=-1)
    coeff2 = 0.5 * torch.cat([s[:, None] * ncp, (s * ld_p2)[:, None]], dim=-1)
    return coeff1, coeff2, s, ok


def _calculate_corner_features(knn5, stack_xyz, stack_mask, local_q, local_t, cfg: LioConfig):
    """Corner association of one frame's stack (see :func:`_corner_rows`)."""
    point_sel = quat.rotate(local_q[None, :], stack_xyz) + local_t[None, :]
    in_fov = _fov_ok(point_sel, local_q, local_t)
    return _corner_rows(knn5, point_sel, stack_mask, in_fov, cfg)


def _associate_frame(assoc, stacks, local_q, local_t, cfg: LioConfig):
    """All feature rows for one frame: (points (F,3), coeff (F,4), ok (F,)).
    ``assoc`` = (surf knn5[, corner knn5]), ``stacks`` = (surf_xyz,
    surf_mask[, corner_xyz, corner_mask]); F = C_surf (+ 2 C_corner with
    ``use_corner``: each corner point gives two rows)."""
    coeff_s, _, ok_s = _calculate_features(assoc[0], stacks[0], stacks[1], local_q, local_t, cfg)
    if not cfg.estimator.use_corner:
        return stacks[0], coeff_s, ok_s
    c1, c2, _, ok_c = _calculate_corner_features(assoc[1], stacks[2], stacks[3], local_q,
                                                 local_t, cfg)
    return (_stack_points(stacks, cfg), torch.cat([coeff_s, c1, c2], dim=0),
            torch.cat([ok_s, ok_c, ok_c], dim=0))


def _stack_points(stacks, cfg: LioConfig):
    """The point rows of one :func:`_associate_frame` round's layout."""
    if not cfg.estimator.use_corner:
        return stacks[0]
    return torch.cat([stacks[0], stacks[2], stacks[2]], dim=0)


def _gn_system(assoc, stacks, pts, coeff_acc, ok_acc, lq, lt, it: int, cfg: LioConfig,
               axis: MH.Mesh = None):
    """Round ``it`` of the mini-GN up to its step: the newest frame's rows
    at (lq, lt) go into ``coeff_acc[it]`` / ``ok_acc[it]`` (in place), then
    the 6x6 normal equations over rounds 0..it (``keep_features``) or this
    round alone, summed over the ranks with ``axis``. Returns (A^T A, x)."""
    e = cfg.estimator
    dtype, dev = lt.dtype, lt.device
    _, coeff, ok = _associate_frame(assoc, stacks, lq, lt, cfg)
    coeff_acc[it] = coeff
    ok_acc[it] = ok
    if e.keep_features:
        # GN over the union of rounds 0..it
        w = coeff_acc[:it + 1, :, :3].reshape(-1, 3)
        b = coeff_acc[:it + 1, :, 3].reshape(-1)
        wrow = ok_acc[:it + 1].reshape(-1).to(dtype)
        pts_gn = pts.repeat(it + 1, 1)
    else:
        w, b, wrow, pts_gn = coeff[:, :3], coeff[:, 3], ok.to(dtype), pts
    rot = quat.to_matrix(lq)
    # J_r = -w^T (R [p]_x), J_t = w^T (Estimator.cc:1289-1290)
    j_r = -torch.einsum("ni,nij->nj", w, rot @ quat.skew(pts_gn))
    jac = torch.cat([j_r, w], dim=1)
    d2 = torch.sum(w * (quat.rotate(lq[None, :], pts_gn) + lt[None, :]), dim=-1) + b
    jw = jac * wrow[:, None]
    ata = jw.T @ jac
    atb = jw.T @ (-d2)
    if axis is not None:
        ab = MH.psum(torch.cat([ata, atb[:, None]], dim=1), axis)
        ata, atb = ab[:, :6], ab[:, 6]
    x = GN.solve(ata + 1e-9 * torch.eye(6, dtype=dtype, device=dev), atb)
    return ata, x


def _gn_update(x, proj, degen, lq, lt):
    """The round's step through round 0's degeneracy projection, applied to
    (lq, lt). Returns (lq', lt', converged) with ``converged`` the 0.05 deg /
    0.05 cm early abort as a device bool."""
    x = torch.where(degen, proj @ x, x)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    lt_new = lt + x[3:6]
    lq_new = quat.normalize(quat.qmul(lq, quat.delta_q(x[0:3])))
    delta_r = quat.angular_distance(lq, lq_new) * (180.0 / math.pi)
    delta_t = torch.linalg.norm(x[3:6]) * 100.0
    return lq_new, lt_new, (delta_r < 0.05) & (delta_t < 0.05)


def _gn_buffers(stacks, n_iters: int, cfg: LioConfig, like):
    """(pts, coeff_acc (n_iters, F, 4), ok_acc (n_iters, F)) of a mini-GN."""
    pts = _stack_points(stacks, cfg)
    n_rows = pts.shape[0]
    coeff_acc = torch.zeros((n_iters, n_rows, 4), dtype=like.dtype, device=like.device)
    ok_acc = torch.zeros((n_iters, n_rows), dtype=torch.bool, device=like.device)
    return pts, coeff_acc, ok_acc


def _calculate_laser_odom(assoc, stacks, local_q, local_t, cfg: LioConfig,
                          n_iters: int = 10, axis: MH.Mesh = None):
    """Mini scan-to-local-map GN for the newest frame (CalculateLaserOdom,
    Estimator.cc:1242-1359), <= ``n_iters`` rounds with the 0.05 deg /
    0.05 cm early abort; with ``keep_features`` each round's rows
    accumulate; with ``axis`` the rows are this rank's and the 6x6 normal
    equations are summed over the ranks. Returns (lq, lt, pts, coeff_acc
    (n_iters, F, 4), ok_acc (n_iters, F), n_exec) with n_exec a Python
    int. One host sync per round but the last; the step itself runs the
    same rounds as conditional bodies of :func:`step_program`."""
    pts, coeff_acc, ok_acc = _gn_buffers(stacks, n_iters, cfg, local_t)
    lq, lt = local_q, local_t
    proj = degen = None
    it = 0
    while it < n_iters:
        ata, x = _gn_system(assoc, stacks, pts, coeff_acc, ok_acc, lq, lt, it, cfg, axis)
        if it == 0:
            g = GN.degeneracy_projection(ata, 100.0)
            proj, degen = g.proj, g.is_degenerate
        lq, lt, converged = _gn_update(x, proj, degen, lq, lt)
        it += 1
        if it < n_iters and bool(converged):
            break
    return lq, lt, pts, coeff_acc, ok_acc, it


def _push(arr, new):
    return torch.cat([arr[1:], new[None]], dim=0)


def predict_and_push(state: EstimatorState, surf_cloud: Cloud, samples: PI.ImuSamples,
                     cfg: LioConfig, corner_cloud: Cloud = None):
    """Steps 1-4: preintegrate the interval, IMU-predicted deskew of the
    sweep to its end (not with ``cutoff_deskew``), stack downsample (the
    corner cloud too with ``use_corner``), window push. Returns the pushed
    state."""
    e = cfg.estimator
    w = e.window_size
    dtype, dev = state.ps.dtype, state.ps.device
    scan_period = cfg.sensor.scan_period
    q_prev, p_prev, v_prev = state.qs[w], state.ps[w], state.vs[w]
    ba, bg = state.bas[w], state.bgs[w]

    imu_cfg = e.imu
    noise18 = PI.noise_matrix(imu_cfg.acc_n, imu_cfg.gyr_n, imu_cfg.acc_w, imu_cfg.gyr_w,
                              dtype, dev)
    pre_k, prefixes = PI.integrate(samples, ba, bg, noise18, with_prefixes=True)
    q_pred, p_pred, v_pred = PI.apply_deltas(pre_k, q_prev, p_prev, v_prev, state.g_vec)

    # body motion over the SWEEP (the last scan_period of the interval)
    q_s, p_s, _ = PI.state_at_offset(prefixes, pre_k.sum_dt - scan_period,
                                     q_prev, p_prev, v_prev, state.g_vec)
    body_es = Pose(q_pred, p_pred).inverse() @ Pose(q_s, p_s)
    t_lb_pose = Pose(state.q_lb, state.t_lb)
    es_laser = t_lb_pose @ body_es @ t_lb_pose.inverse()

    deskew_on = e.enable_deskew and not e.cutoff_deskew
    deskewed = DS.transform_to_end(surf_cloud.xyz, surf_cloud.rel_time, es_laser.q,
                                   es_laser.t, scan_period, enabled=deskew_on)
    ds_xyz, ds_mask, _ = VX.voxel_downsample(deskewed, surf_cloud.mask, e.surf_filter_size,
                                             e.surf_stack_cap)
    if e.use_corner:
        c_deskewed = DS.transform_to_end(corner_cloud.xyz, corner_cloud.rel_time, es_laser.q,
                                         es_laser.t, scan_period, enabled=deskew_on)
        dc_xyz, dc_mask, _ = VX.voxel_downsample(c_deskewed, corner_cloud.mask,
                                                 e.corner_filter_size, e.corner_stack_cap)
    else:
        dc_xyz = torch.zeros((e.corner_state_cap, 3), dtype=dtype, device=dev)
        dc_mask = torch.zeros((e.corner_state_cap,), dtype=torch.bool, device=dev)
    return state._replace(
        qs=_push(state.qs, q_pred), ps=_push(state.ps, p_pred), vs=_push(state.vs, v_pred),
        bas=_push(state.bas, ba), bgs=_push(state.bgs, bg),
        pres=tree_map(_push, state.pres, pre_k),
        imu=tree_map(_push, state.imu, samples),
        surf_xyz=_push(state.surf_xyz, ds_xyz), surf_mask=_push(state.surf_mask, ds_mask),
        corner_xyz=_push(state.corner_xyz, dc_xyz),
        corner_mask=_push(state.corner_mask, dc_mask),
        qs_lin=_push(state.qs_lin, q_pred), ps_lin=_push(state.ps_lin, p_pred),
    )


def _relative_to_pivot(qs, ps, st: EstimatorState, pivot: int) -> Pose:
    """The laser poses of body poses (qs, ps) relative to the pivot's."""
    lposes = laser_pose(qs, ps, st.q_lb[None, :], st.t_lb[None, :])
    pinv = Pose(lposes.q[pivot], lposes.t[pivot]).inverse()
    return Pose(pinv.q[None, :], pinv.t[None, :]) @ lposes


def local_map(st: EstimatorState, cfg: LioConfig):
    """Step 5: every window frame's pose relative to the pivot laser frame,
    and the voxel-filtered local map of all frames but the newest, in the
    pivot frame (with ``fix_map`` at the frozen linearization poses,
    Estimator.cc:1398-1412). Returns (rel Pose (W1,), maps) with maps =
    (map_xyz, map_mask[, corner_xyz, corner_mask])."""
    e = cfg.estimator
    w, pivot = e.window_size, e.pivot_idx
    rel = _relative_to_pivot(st.qs, st.ps, st, pivot)
    rel_map = _relative_to_pivot(st.qs_lin, st.ps_lin, st, pivot) if e.fix_map else rel

    def filtered(xyz, mask, leaf, cap):
        pts = quat.rotate(rel_map.q[:, None, :], xyz) + rel_map.t[:, None, :]
        out_xyz, out_mask, _ = VX.voxel_downsample(pts[:w].reshape(-1, 3),
                                                   mask[:w].reshape(-1), leaf, cap)
        return out_xyz, out_mask

    maps = filtered(st.surf_xyz, st.surf_mask, e.surf_filter_size, e.local_map_filtered_cap)
    if e.use_corner:
        maps += filtered(st.corner_xyz, st.corner_mask, e.corner_filter_size,
                         e.local_map_corner_cap)
    return rel, maps


# Profiling hook (the reference's tools/profile_waterfall.py): one of "window", "map",
# "assoc", "gates", "solve" ends the step right after that stage and returns
# (st, debug dict), as the reference's hook does; each call then runs only
# the step's prefix. None in production.
_TRUNCATE_STAGE = None


def commit(v: dict, new: dict):
    """A conditional body's results into the values it updates: each leaf
    of ``new[name]`` copied into the same leaf of ``v[name]``, which must
    exist with the same shape and type (a CUDA graph's body writes into
    memory made before it; a skipped body leaves it as it was)."""
    for name, value in new.items():
        if name not in v:
            raise KeyError(f"{name!r}: a conditional body may only update values made "
                           "before it")
        old, fresh = tree_leaves(v[name]), tree_leaves(value)
        if len(old) != len(fresh):
            raise ValueError(f"{name!r}: the body changes the value's structure")
        for dst, src in zip(old, fresh):
            if not torch.is_tensor(dst):
                if dst != src:
                    raise ValueError(f"{name!r}: the body changes a constant")
                continue
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"{name!r}: {tuple(src.shape)} {src.dtype} into "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)


class EagerRun:
    """Runs :func:`step_program` as one eager call: each stretch on the
    spot, each conditional body after one host read of its flag (a host
    sync). A loop's flag stays set once set, so after it reads set the
    loop's later bodies are skipped without a read. ``models/step_graph.py``
    captures the program as one CUDA graph instead, the flags read by
    conditional nodes on the device."""

    def __init__(self):
        self._stopped = set()

    @staticmethod
    def stretch(key, fn, v):
        v.update(fn(v))

    def when(self, v, stop: str, key, fn):
        """Run the body ``fn`` unless the device flag ``v[stop]`` is set."""
        if stop in self._stopped:
            return
        if bool(v[stop]):  # a host sync
            self._stopped.add(stop)
            return
        commit(v, fn(v))


def lio_step_impl(state: EstimatorState, surf_cloud: Cloud, samples: PI.ImuSamples,
                  cfg: LioConfig, corner_cloud: Cloud = None, axis: MH.Mesh = None,
                  map_shard: bool = False) -> Tuple[EstimatorState, dict]:
    """The full per-sweep estimator step (see the module docstring), run
    eagerly; ``map_shard`` without ``axis`` changes nothing."""
    v = {"state": state, "surf_cloud": surf_cloud, "corner_cloud": corner_cloud,
         "samples": samples}
    return step_program(EagerRun(), v, cfg, extrinsic_prior(cfg), axis=axis, map_shard=map_shard)


def extrinsic_prior(cfg: LioConfig):
    """The extrinsic prior's values (q_lb, t_lb) as host floats, or None
    without the prior factor; the step makes them on the device by fills."""
    if not cfg.estimator.prior_factor:
        return None
    return tuple(x.tolist() for x in cfg.extrinsic_lb())


def _shard_rows(arr, mask, axis: MH.Mesh):
    """Association sharding (distributed step only): this rank's rows."""
    if axis is None:
        return arr, mask
    lo = axis.rank * (arr.shape[0] // axis.size)
    hi = lo + arr.shape[0] // axis.size
    return arr[lo:hi], mask[lo:hi]


def _assoc(maps, cfg: LioConfig, axis: MH.Mesh, map_shard: bool):
    """The surf (and with ``use_corner`` the corner) 5-NN searches over the
    local maps."""
    e = cfg.estimator
    if axis is not None and map_shard:
        assoc = (make_knn5(*_shard_rows(maps[0], maps[1], axis), cfg, axis=axis),)
        if e.use_corner:
            assoc += (make_knn5(*_shard_rows(maps[2], maps[3], axis), cfg, axis=axis,
                                force_tiled=True),)
        return assoc
    assoc = (make_knn5(maps[0], maps[1], cfg),)
    if e.use_corner:
        assoc += (make_knn5(maps[2], maps[3], cfg, force_tiled=True),)
    return assoc


def _frame_stacks(st: EstimatorState, i: int, cfg: LioConfig, axis: MH.Mesh):
    sx, sm = _shard_rows(st.surf_xyz[i], st.surf_mask[i], axis)
    if cfg.estimator.use_corner:
        return (sx, sm) + _shard_rows(st.corner_xyz[i], st.corner_mask[i], axis)
    return (sx, sm)


def step_program(run, v: dict, cfg: LioConfig, ex_prior, axis: MH.Mesh = None,
                 map_shard: bool = False, front=None) -> Tuple[EstimatorState, dict]:
    """The estimator step as stretches of device work and conditional
    bodies. ``run`` (:class:`EagerRun`, or ``step_graph.StepGraphs``) runs
    each stretch (``run.stretch(key, fn, v)``: ``fn`` reads the values of
    ``v`` and returns the new ones), each body (``run.when(v, stop, key,
    fn)``: ``fn`` runs unless the device flag ``v[stop]`` is set, and its
    results are copied into the values it updates, :func:`commit`). The
    mini-GN's rounds 1 .. n-1 run under ``~gn_converged`` and the LM's
    iterations 2 .. n under ``~lm_done``; both flags stay set once set (a
    skipped body leaves them), so the flat sequence of bodies is the
    reference's ``while_loop``. Their counts are device counters
    (``gn_rounds``, the LM carry's ``iters``): the outputs
    ``newest_rounds`` and ``solver_iterations``. Nothing is read back.

    ``v`` holds ``state``, and either ``samples``, ``surf_cloud`` and
    ``corner_cloud`` or, with ``front`` (v -> (surf cloud, corner cloud or
    None, samples, extra outputs)), what ``front`` reads: the graphed
    pipeline runs its front end inside the program. ``ex_prior`` is
    :func:`extrinsic_prior` of ``cfg``, made on the host before the
    program. Returns (new state, outputs)."""
    e = cfg.estimator
    n_ref = e.newest_refine_iters if e.imu_factor else 0
    max_it = e.max_solver_iterations

    run.stretch(("head",), lambda v: _st_head(v, cfg, axis, map_shard, n_ref, front), v)
    if "truncated" in v:
        return v["st"], v["truncated"]
    if n_ref > 0:
        run.stretch(("gn", 0), lambda v: _st_gn(v, cfg, axis, map_shard, 0), v)
        for it in range(1, n_ref):
            run.when(v, "gn_converged", ("gn", it),
                     lambda v, it=it: _st_gn(v, cfg, axis, map_shard, it))
    run.stretch(("post",), lambda v: _st_post(v, cfg, axis, map_shard, n_ref, ex_prior), v)
    if "truncated" in v:
        return v["st"], v["truncated"]
    if max_it > 0:
        run.stretch(("lm", 0), lambda v: _st_lm(v, cfg, axis), v)
        for it in range(1, max_it):
            run.when(v, "lm_done", ("lm", it), lambda v: _st_lm(v, cfg, axis))
    if _TRUNCATE_STAGE == "solve":
        return v["st"], {"q": v["lm"].x.q}
    run.stretch(("tail",), lambda v: _st_tail(v, cfg, axis), v)
    run.stretch(("final",), lambda v: _st_final(v, cfg, n_ref), v)
    return v["state"], dict(v["out"])


def _st_head(v, cfg: LioConfig, axis, map_shard, n_ref: int, front):
    """[front end,] window push, local map, the associations of frames
    pivot+1 .. W-1 and the mini-GN's round 0 up to its step."""
    e = cfg.estimator
    w, pivot = e.window_size, e.pivot_idx
    new = {}
    if front is not None:
        surf_cloud, corner_cloud, samples, new["front_out"] = front(v)
    else:
        surf_cloud, corner_cloud, samples = v["surf_cloud"], v["corner_cloud"], v["samples"]
    st = predict_and_push(v["state"], surf_cloud, samples, cfg, corner_cloud)
    new["st"] = st
    if _TRUNCATE_STAGE == "window":
        return {"st": st, "truncated": {}}
    rel, maps = local_map(st, cfg)
    if _TRUNCATE_STAGE == "map":
        return {"st": st, "truncated": {
            "m": maps[0], "maps": maps,
            "stacks": (st.surf_xyz, st.surf_mask, st.corner_xyz, st.corner_mask),
            "rel_q": rel.q, "rel_t": rel.t}}
    assoc = _assoc(maps, cfg, axis, map_shard)
    # features for frames pivot+1 .. window-1
    feats = ([], [], [])
    for i in range(pivot + 1, w):
        for acc, x in zip(feats, _associate_frame(assoc, _frame_stacks(st, i, cfg, axis),
                                                  rel.q[i], rel.t[i], cfg)):
            acc.append(x)
    new.update(rel=rel, maps=maps, feats=feats)
    if n_ref > 0:
        stacks = _frame_stacks(st, w, cfg, axis)
        pts, coeff_acc, ok_acc = _gn_buffers(stacks, n_ref, cfg, st.ps)
        lq, lt = rel.q[w], rel.t[w]
        new["gn_sys"] = _gn_system(assoc, stacks, pts, coeff_acc, ok_acc, lq, lt, 0, cfg, axis)
        new.update(gn_acc=(pts, coeff_acc, ok_acc), gn_pose=(lq, lt))
    return new


def _st_gn(v, cfg: LioConfig, axis, map_shard, it: int):
    """Mini-GN round ``it``: round 0 from its system on (the degeneracy
    projection from its A^T A), a later round whole (a conditional body);
    ends at the exit test, with the rounds run counted in ``gn_rounds``."""
    new = {}
    if it == 0:
        ata, x = v["gn_sys"]
        g = GN.degeneracy_projection(ata, 100.0)
        new["gn_proj"] = (g.proj, g.is_degenerate)
        new["gn_rounds"] = torch.ones((), dtype=torch.int32, device=x.device)
    else:
        new["gn_rounds"] = v["gn_rounds"] + 1
        st = v["st"]
        w = cfg.estimator.window_size
        pts, coeff_acc, ok_acc = v["gn_acc"]
        lq, lt = v["gn_pose"]
        _, x = _gn_system(_assoc(v["maps"], cfg, axis, map_shard), _frame_stacks(st, w, cfg, axis),
                          pts, coeff_acc, ok_acc, lq, lt, it, cfg, axis)
    proj, degen = new.get("gn_proj") or v["gn_proj"]
    lq, lt, new["gn_converged"] = _gn_update(x, proj, degen, *v["gn_pose"])
    new["gn_pose"] = (lq, lt)
    return new


def device_vector(values, dtype, device) -> torch.Tensor:
    """A small constant vector made on ``device`` by fills, one an element
    (no host-to-device copy); each value rounds to ``dtype`` as ``.to``
    rounds it."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, x in enumerate(values):
        out[i:i + 1].fill_(x)
    return out


def _st_post(v, cfg: LioConfig, axis, map_shard, n_ref: int, ex_prior_host):
    """The newest frame's rows after the mini-GN's rounds, the plane
    factors, the evaluation at x0 and the convergence gates, and the LM's
    start. The rows keep the reference's fixed shapes: the newest are the
    last round's, picked by a device index, and with ``keep_features`` the
    extra factors carry all ``n_ref`` rounds, those never run all-masked."""
    e = cfg.estimator
    s_opt, w, pivot = e.opt_window_size, e.window_size, e.pivot_idx
    st = v["st"]
    state = v["state"]
    dtype, dev = st.ps.dtype, st.ps.device
    feat_pts, feat_coeff, feat_ok = (list(x) for x in v["feats"])

    planes_extra = None
    if n_ref > 0:
        pts_n, coeff_acc, ok_acc = v["gn_acc"]
        last = torch.clamp_min(v["gn_rounds"].to(torch.int64) - 1, 0)
        coeff_n = coeff_acc.index_select(0, last.reshape(1))[0]
        ok_n = ok_acc.index_select(0, last.reshape(1))[0]
        if e.keep_features and n_ref > 1:
            # earlier rounds stay in the factor set, anchored at the newest
            # pose (rounds never run are all-masked)
            extra_ok = ok_acc & (torch.arange(n_ref, device=dev) != last)[:, None]
            planes_extra = SV.PlaneFactors(
                point=pts_n[None].expand((n_ref,) + pts_n.shape), coeff=coeff_acc,
                mask=extra_ok)
    else:
        rel = v["rel"]
        pts_n, coeff_n, ok_n = _associate_frame(_assoc(v["maps"], cfg, axis, map_shard),
                                                _frame_stacks(st, w, cfg, axis),
                                                rel.q[w], rel.t[w], cfg)
    feat_pts.append(pts_n)
    feat_coeff.append(coeff_n)
    feat_ok.append(ok_n)
    planes = SV.PlaneFactors(point=torch.stack(feat_pts), coeff=torch.stack(feat_coeff),
                             mask=torch.stack(feat_ok))
    if _TRUNCATE_STAGE == "assoc":
        return {"truncated": {"c": planes.coeff}}

    # gates + window solve
    x0 = SV.OptStates(
        q=st.qs[pivot:], p=st.ps[pivot:],
        sb=torch.cat([st.vs[pivot:], st.bas[pivot:], st.bgs[pivot:]], dim=-1),
        ex_q=st.q_lb, ex_p=st.t_lb)
    pres_opt = tree_map(lambda a: a[pivot + 1:], st.pres)
    ex_prior = None
    if ex_prior_host is not None:
        ex_prior = tuple(device_vector(x, dtype, dev) for x in ex_prior_host)

    # one evaluation at x0 serves the convergence gates and the LM's first
    # iteration
    imu_sqrt_infos = FA.sqrt_info_from_covariance(pres_opt.covariance)
    groups0 = SV._evaluate(x0, pres_opt, state.g_vec, planes, st.prior, ex_prior,
                           {"cauchy_scale": e.cauchy_loss_scale,
                            "imu_sqrt_infos": imu_sqrt_infos}, s_opt, planes_extra)
    costs0 = SV.group_costs(groups0)
    cost_plane0 = costs0["plane"] + costs0.get("plane_extra",
                                               torch.zeros((), dtype=dtype, device=dev))
    if axis is not None:
        # plane rows are sharded; the gates must see the global cost
        cost_plane0 = MH.psum(cost_plane0, axis)
    costs0["plane"] = cost_plane0
    costs0.pop("plane_extra", None)
    turn_off = costs0["imu"] > e.convergence_cost_pim_th
    ratio = costs0["marg"] / torch.clamp_min(cost_plane0 + costs0["imu"], 1e-12)
    convergence_flag = st.convergence_flag | (
        (~turn_off) & (ratio <= e.convergence_marg_ratio_th) & (ratio != 0.0))

    # not converged: fix extrinsic + drop the prior (Estimator.cc:1957-1981)
    prior_in = st.prior._replace(valid=st.prior.valid & convergence_flag)
    opt_ex = st.extrinsic_enabled & convergence_flag
    if _TRUNCATE_STAGE == "gates":
        return {"truncated": {"f": convergence_flag}}

    j_m, r_m, w_m = groups0["marg"]
    eval0 = dict(groups0)
    eval0["marg"] = (j_m, r_m, w_m * convergence_flag.to(w_m.dtype))
    prob, carry = SV.lm_start(
        x0, pres_opt, state.g_vec, planes, prior_in, ex_prior, s=s_opt,
        cauchy_scale=e.cauchy_loss_scale, opt_extrinsic=opt_ex, use_marg=True, eval0=eval0,
        imu_sqrt_infos=imu_sqrt_infos, planes_extra=planes_extra, psum_axis=axis)
    return {"lm_prob": prob, "lm": carry, "prior_in": prior_in, "costs0": costs0,
            "gates": (convergence_flag, turn_off)}


def _st_lm(v, cfg: LioConfig, axis):
    """One LM iteration; ends at its ``done`` (the carry counts it)."""
    e = cfg.estimator
    carry, done = SV.lm_iteration(v["lm_prob"], v["lm"], s=e.opt_window_size,
                                  cauchy_scale=e.cauchy_loss_scale, psum_axis=axis,
                                  ftol=e.solver_ftol)
    return {"lm": carry, "lm_done": done}


def _st_tail(v, cfg: LioConfig, axis):
    """The yaw-gauge fix and the marginalization's system."""
    e = cfg.estimator
    s_opt, pivot = e.opt_window_size, e.pivot_idx
    st = v["st"]
    prob = v["lm_prob"]
    x_opt = v["lm"].x
    dtype, dev = st.ps.dtype, st.ps.device
    n_plane = torch.sum(prob.planes.mask)
    if prob.planes_extra is not None:
        n_plane = n_plane + torch.sum(prob.planes_extra.mask)
    if axis is not None:
        n_plane = MH.psum(n_plane, axis)

    # yaw-gauge fix (DoubleToVector, Estimator.cc:2479-2568)
    r_pivot_old = quat.to_matrix(st.qs[pivot])
    origin_r0 = quat.rot_to_ypr(r_pivot_old)
    origin_p0 = st.ps[pivot]
    r00 = quat.rot_to_ypr(quat.to_matrix(x_opt.q[0]))
    y_diff = origin_r0[0] - r00[0]
    zero = torch.zeros((), dtype=dtype, device=dev)
    rot_diff = quat.ypr_to_rot(torch.stack([y_diff, zero, zero]))
    singular = (torch.abs(torch.abs(origin_r0[1]) - 90.0) < 1.0) | \
        (torch.abs(torch.abs(r00[1]) - 90.0) < 1.0)
    rot_diff = torch.where(singular, r_pivot_old @ quat.to_matrix(x_opt.q[0]).T, rot_diff)
    q_diff = quat.from_matrix(rot_diff)

    new_q_opt = quat.normalize(quat.qmul(q_diff[None, :], x_opt.q))
    new_p_opt = quat.rotate(q_diff[None, :], x_opt.p - x_opt.p[0][None, :]) + origin_p0[None, :]
    new_v_opt = quat.rotate(q_diff[None, :], x_opt.sb[:, 0:3])

    # pre-pivot frames follow the pivot correction (Estimator.cc:2508-2532)
    corr = Pose(new_q_opt[0], new_p_opt[0]) @ Pose(st.qs[pivot], st.ps[pivot]).inverse()
    pre_q = quat.normalize(quat.qmul(corr.q[None, :], st.qs[:pivot]))
    pre_p = quat.rotate(corr.q[None, :], st.ps[:pivot]) + corr.t[None, :]

    window = (torch.cat([pre_q, new_q_opt], dim=0), torch.cat([pre_p, new_p_opt], dim=0),
              torch.cat([st.vs[:pivot], new_v_opt], dim=0),
              torch.cat([st.bas[:pivot], x_opt.sb[:, 3:6]], dim=0),
              torch.cat([st.bgs[:pivot], x_opt.sb[:, 6:9]], dim=0))
    x_fixed = SV.OptStates(
        q=new_q_opt, p=new_p_opt,
        sb=torch.cat([new_v_opt, x_opt.sb[:, 3:6], x_opt.sb[:, 6:9]], dim=-1),
        ex_q=x_opt.ex_q, ex_p=x_opt.ex_p)

    # marginalize the pivot at the post-solve states
    a, b = SV.marginal_system(
        x_fixed, tree_map(lambda t: t[0], prob.pres), prob.g_vec, prob.planes, v["prior_in"],
        s=s_opt, cauchy_scale=e.cauchy_loss_scale, psum_axis=axis,
        planes_extra=prob.planes_extra)
    return {"window": window, "x_fixed": x_fixed, "n_plane": n_plane, "marg_ab": (a, b)}


def _st_final(v, cfg: LioConfig, n_ref: int):
    """The marginalization (the Schur complement and its factorization into
    the new prior, an ``eigh`` each), the new state and the step's
    outputs."""
    e = cfg.estimator
    w, pivot = e.window_size, e.pivot_idx
    st = v["st"]
    x_fixed = v["x_fixed"]
    convergence_flag, turn_off = v["gates"]
    prior_in = v["prior_in"]
    a_new, b_new = MG.schur_marginalize(*v["marg_ab"], SV.N_MARG)
    lin_jac, lin_res = MG.factorize_prior(0.5 * (a_new + a_new.T), b_new)
    new_prior = SV.prior_from_factor(x_fixed, lin_jac, lin_res)
    do_marg = torch.full_like(turn_off, e.marginalization_factor) & (~turn_off)
    prior_out = tree_map(lambda new, old: torch.where(do_marg, new, old),
                         new_prior, st.prior._replace(valid=prior_in.valid))

    qs_new, ps_new, vs_new, bas_new, bgs_new = v["window"]
    if e.fix_map:
        # only the newest frame's linearization point moves to its solved
        # pose (SlideWindow, Estimator.cc:2637-2643)
        qs_lin, ps_lin = st.qs_lin.clone(), st.ps_lin.clone()
        qs_lin[w], ps_lin[w] = qs_new[w], ps_new[w]
    else:
        qs_lin, ps_lin = qs_new, ps_new

    st = st._replace(
        qs=qs_new, ps=ps_new, vs=vs_new, bas=bas_new, bgs=bgs_new,
        qs_lin=qs_lin, ps_lin=ps_lin, prior=prior_out,
        q_lb=x_fixed.ex_q, t_lb=x_fixed.ex_p, convergence_flag=convergence_flag)

    outputs = {
        "laser_pose": laser_pose(st.qs[w], st.ps[w], st.q_lb, st.t_lb),
        "pivot_pose": laser_pose(st.qs[pivot], st.ps[pivot], st.q_lb, st.t_lb),
        "body_pose": Pose(st.qs[w], st.ps[w]),
        "velocity": st.vs[w],
        "ba": st.bas[w],
        "bg": st.bgs[w],
        "ex_q": st.q_lb,
        "ex_p": st.t_lb,
        "costs": v["costs0"],
        "convergence": convergence_flag,
        "n_features": v["n_plane"],
        "solver_iterations": v["lm"].iters.to(torch.int64),
        "newest_rounds": (v["gn_rounds"].to(torch.int64) if n_ref > 0
                          else torch.zeros((), dtype=torch.int64, device=st.ps.device)),
    }
    if "front_out" in v:
        outputs.update(v["front_out"])
    return {"state": st, "out": outputs}


lio_step = lio_step_impl
