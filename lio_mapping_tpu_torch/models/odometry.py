"""Scan-to-scan LOAM odometry (port of lio_mapping_tpu.models.odometry;
reference PointOdometry.cc:237-683).

Constant-velocity prior, per-iteration deskew of the query features,
correspondences re-searched every 5th iteration (corner: 1-NN + other-ring
NN; surf: 1-NN + same-ring + other-ring NN), distance-damped weights from
iteration 5, 6x6 normal equations with the eigenvalue-10 degeneracy
projection, abort at 0.1 deg / 0.1 cm. The GN ``while_loop`` is
``odometry_program``: one conditional body an iteration under a device
flag, run eagerly by ``odometry_step`` (one host read an iteration) or
captured into the pipeline's CUDA graph of a sweep
(``models/step_graph.py``), which reads nothing back.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import LioConfig
from ..ops import deskew as DS
from ..ops import gn as GN
from ..ops import knn as KNN
from ..ops.cloud import Cloud
from ..ops.features import SweepFeatures
from ..utils import quaternion as quat
from ..utils.se3 import Pose
from ..utils.tree import tree_map
from . import estimator as EST


class OdometryState(NamedTuple):
    pose: Pose          # transform_sum_: sweep-end pose in world (laser frame)
    q_es: torch.Tensor  # per-sweep increment estimate (transform_es_)
    t_es: torch.Tensor
    last_corner: Cloud  # previous less-sharp cloud @ sweep end
    last_surf: Cloud    # previous less-flat cloud @ sweep end
    initialized: torch.Tensor  # bool


def init_state(cfg: LioConfig, dtype=torch.float32, device=None) -> OdometryState:
    f = cfg.feature
    return OdometryState(
        pose=Pose.identity(dtype=dtype, device=device),
        q_es=quat.identity(dtype, device),
        t_es=torch.zeros(3, dtype=dtype, device=device),
        last_corner=Cloud.empty(f.corner_less_sharp_cap, dtype, device),
        last_surf=Cloud.empty(f.surf_less_flat_cap, dtype, device),
        initialized=torch.tensor(False, device=device),
    )


def _edge_residual(p0, p1, p2):
    """Point-to-line distance + unit gradient (PointOdometry.cc:401-419)."""
    a_vec = quat.cross(p0 - p1, p0 - p2)
    a012 = torch.linalg.norm(a_vec, dim=-1)
    l12 = torch.linalg.norm(p1 - p2, dim=-1)
    ld2 = a012 / torch.clamp_min(l12, 1e-12)
    n = quat.cross(p1 - p2, a_vec)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    return ld2, n


def _plane_residual(p0, p1, p2, p3):
    """Signed point-to-plane distance + normal (PointOdometry.cc:501-515)."""
    n = quat.cross(p2 - p1, p3 - p1)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    d = -torch.sum(n * p1, dim=-1)
    return torch.sum(n * p0, dim=-1) + d, n


def odometry_step(state: OdometryState, feats: SweepFeatures, cfg: LioConfig,
                  enable=None) -> Tuple[OdometryState, dict]:
    """Process one sweep of features; returns (new_state, outputs).
    ``enable`` mirrors the reference's /enable_odom service. Runs
    :func:`odometry_program` eagerly (one host read a GN iteration)."""
    v = {"odom": state, "feats": feats}
    if enable is not None:
        v["enable"] = torch.as_tensor(enable, device=state.t_es.device)
    return odometry_program(EST.EagerRun(), v, cfg)


def odometry_program(run, v: dict, cfg: LioConfig, front=None) -> Tuple[OdometryState, dict]:
    """The odometry as stretches and conditional bodies
    (``estimator.step_program``'s protocol): GN iteration ``it`` runs
    unless the device flag ``odo_stop`` is set. The flag starts as
    ``~(initialized & enough & enable)`` and takes each iteration's exit
    test, so the flat sequence of bodies is the reference's ``while_loop``;
    the state's increment and pose take the reference's select form.

    ``v`` holds ``odom`` (the state), optionally ``enable`` (a device
    bool; default on) and either ``feats`` or, with ``front`` (v ->
    SweepFeatures), what ``front`` reads. Leaves ``odom`` the new state and
    ``odo_out`` the outputs; returns both."""
    run.stretch(("odo", "head"), lambda v: _odo_head(v, cfg, front), v)
    for it in range(cfg.odometry.max_iterations):
        run.when(v, "odo_stop", ("odo", it), lambda v, it=it: _odo_iteration(v, cfg, it))
    run.stretch(("odo", "tail"), lambda v: _odo_tail(v, cfg), v)
    return v["odom"], v["odo_out"]


def _odo_head(v, cfg: LioConfig, front):
    """The sweep's features, the GN's gate and the loop values its bodies
    update: the increment (from the last one, the constant-velocity
    prior), the correspondences (zeros until the first search, as the
    reference's ``corr0``) and the degeneracy projection."""
    oc = cfg.odometry
    new = {}
    if front is not None:
        new["feats"] = feats = front(v)
    else:
        feats = v["feats"]
    state = v["odom"]
    dev = state.t_es.device
    enable = v.get("enable")
    if enable is None:
        enable = torch.ones((), dtype=torch.bool, device=dev)
    enough = (state.last_corner.count() > oc.min_corner_points) & \
        (state.last_surf.count() > oc.min_surf_points)
    run_gn = state.initialized & enough & enable
    n_c, n_s = feats.corner_sharp.mask.shape[0], feats.surf_flat.mask.shape[0]

    def zeros(n, dtype):
        return torch.zeros(n, dtype=dtype, device=dev)

    i32, b = torch.int32, torch.bool
    new.update(
        odo_run=run_gn, odo_stop=~run_gn, odo_q=state.q_es.clone(), odo_t=state.t_es.clone(),
        odo_corr=(zeros(n_c, i32), zeros(n_c, i32), zeros(n_c, b), zeros(n_s, i32),
                  zeros(n_s, i32), zeros(n_s, i32), zeros(n_s, b)),
        odo_proj=(torch.eye(6, dtype=state.t_es.dtype, device=dev), zeros((), b)))
    return new


def _deskew_queries(feats: SweepFeatures, q_es, t_es, scan_period: float):
    cq = DS.transform_to_start(feats.corner_sharp.xyz, feats.corner_sharp.rel_time, q_es, t_es,
                               scan_period)
    sq = DS.transform_to_start(feats.surf_flat.xyz, feats.surf_flat.rel_time, q_es, t_es,
                               scan_period)
    return cq, sq


def _gather(c: Cloud, i):
    return c.xyz[i.to(torch.int64)]


def _associate(cq_xyz, sq_xyz, feats: SweepFeatures, last_c: Cloud, last_s: Cloud, oc):
    """Corner: 1-NN + other-ring NN; surf: 1-NN + same-ring + other-ring NN."""
    corner_q, surf_q = feats.corner_sharp, feats.surf_flat
    cd1, ci1 = KNN.nearest(cq_xyz, corner_q.mask, last_c.xyz, last_c.mask)
    c_ok1 = cd1 < oc.nearest_sq_dist_th
    c_ring1 = last_c.ring[ci1.to(torch.int64)]
    cd2, ci2 = KNN.ring_constrained_nearest(
        cq_xyz, c_ring1, corner_q.mask & c_ok1, ci1, last_c.xyz, last_c.ring, last_c.mask,
        mode="other", ring_window=oc.ring_search_range)
    c_ok2 = c_ok1 & (cd2 < oc.nearest_sq_dist_th)

    sd1, si1 = KNN.nearest(sq_xyz, surf_q.mask, last_s.xyz, last_s.mask)
    s_ok1 = sd1 < oc.nearest_sq_dist_th
    s_ring1 = last_s.ring[si1.to(torch.int64)]
    sd2, si2 = KNN.ring_constrained_nearest(
        sq_xyz, s_ring1, surf_q.mask & s_ok1, si1, last_s.xyz, last_s.ring, last_s.mask,
        mode="same", ring_window=oc.ring_search_range)
    sd3, si3 = KNN.ring_constrained_nearest(
        sq_xyz, s_ring1, surf_q.mask & s_ok1, si1, last_s.xyz, last_s.ring, last_s.mask,
        mode="other", ring_window=oc.ring_search_range)
    s_ok = s_ok1 & (sd2 < oc.nearest_sq_dist_th) & (sd3 < oc.nearest_sq_dist_th)
    return (ci1, ci2, c_ok2, si1, si2, si3, s_ok)


def _build_system(cq_xyz, sq_xyz, q_es, t_es, corr, it: int, feats: SweepFeatures,
                  last_c: Cloud, last_s: Cloud, oc):
    """The GN rows at iteration ``it``: (J, rhs, row weights, valid rows)."""
    corner_q, surf_q = feats.corner_sharp, feats.surf_flat
    ci1, ci2, c_ok, si1, si2, si3, s_ok = corr
    weighted = it >= oc.weight_start_iter

    ld2, cn = _edge_residual(cq_xyz, _gather(last_c, ci1), _gather(last_c, ci2))
    s_c = 1.0 - 1.8 * torch.abs(ld2) if weighted else torch.ones_like(ld2)
    w_c = (s_c > 0.1) & (ld2 != 0.0) & c_ok & corner_q.mask

    pd2, sn = _plane_residual(sq_xyz, _gather(last_s, si1), _gather(last_s, si2),
                              _gather(last_s, si3))
    rng = torch.sqrt(torch.clamp_min(torch.linalg.norm(sq_xyz, dim=-1), 1e-12))
    s_s = 1.0 - 1.8 * torch.abs(pd2) / rng if weighted else torch.ones_like(pd2)
    w_s = (s_s > 0.1) & (pd2 != 0.0) & s_ok & surf_q.mask

    # original skewed points, like the reference
    p_all = torch.cat([corner_q.xyz, surf_q.xyz], dim=0)
    w_all = torch.cat([s_c[:, None] * cn, s_s[:, None] * sn], dim=0)
    d_all = torch.cat([s_c * ld2, s_s * pd2], dim=0)
    row_ok = torch.cat([w_c, w_s], dim=0)

    p_local = quat.rotate(quat.conjugate(q_es)[None, :], p_all - t_es[None, :])
    j_r = torch.einsum("ni,nij->nj", w_all, quat.skew(p_local))
    rt = quat.to_matrix(q_es).T
    j_t = -(w_all @ rt.T)
    jac = torch.cat([j_r, j_t], dim=1)
    return jac, -0.1 * d_all, row_ok.to(q_es.dtype), torch.sum(row_ok.to(torch.int32))


def _odo_iteration(v, cfg: LioConfig, it: int):
    """GN iteration ``it`` (a conditional body): the re-search every
    ``reassociate_every``-th iteration and the degeneracy projection at
    iteration 0 (both static per ``it``), the step, and the exit test."""
    oc = cfg.odometry
    feats, state = v["feats"], v["odom"]
    last_c, last_s = state.last_corner, state.last_surf
    q_es, t_es = v["odo_q"], v["odo_t"]
    new = {}
    cq_xyz, sq_xyz = _deskew_queries(feats, q_es, t_es, cfg.sensor.scan_period)
    if it % oc.reassociate_every == 0:
        new["odo_corr"] = corr = _associate(cq_xyz, sq_xyz, feats, last_c, last_s, oc)
    else:
        corr = v["odo_corr"]
    jac, rhs, w, n_rows = _build_system(cq_xyz, sq_xyz, q_es, t_es, corr, it, feats, last_c,
                                        last_s, oc)
    jw = jac * w[:, None]
    ata = jw.T @ jac
    atb = jw.T @ rhs
    x = GN.solve(ata + 1e-12 * torch.eye(6, dtype=ata.dtype, device=ata.device), atb)
    if it == 0:
        g = GN.degeneracy_projection(ata, oc.degeneracy_eigen_th)
        new["odo_proj"] = (g.proj, g.is_degenerate)
    proj, degen = new.get("odo_proj") or v["odo_proj"]
    x = torch.where(degen, proj @ x, x)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    skip = n_rows < 10  # reference `continue` (PointOdometry.cc:535)
    x = torch.where(skip, torch.zeros_like(x), x)
    t_new = t_es + x[3:6]
    q_new = quat.normalize(quat.qmul(q_es, quat.delta_q(x[0:3])))
    t_new = torch.where(torch.isfinite(t_new), t_new, torch.zeros_like(t_new))
    delta_r = quat.angular_distance(q_es, q_new) * (180.0 / math.pi)
    delta_t = torch.linalg.norm(x[3:6]) * 100.0
    new.update(odo_q=q_new, odo_t=t_new, odo_stop=(~skip) & (delta_r < oc.delta_r_abort_deg)
               & (delta_t < oc.delta_t_abort_cm))
    return new


def _odo_tail(v, cfg: LioConfig):
    """The new state and the outputs in the reference's select form: where
    the GN did not run the increment and pose stay and the clouds pass
    through raw, else the clouds are re-projected to the sweep's end."""
    state, feats, run_gn = v["odom"], v["feats"], v["odo_run"]
    scan_period = cfg.sensor.scan_period
    q_es = torch.where(run_gn, v["odo_q"], state.q_es)
    t_es = torch.where(run_gn, v["odo_t"], state.t_es)
    # transform_sum_ = transform_sum_ * transform_es_^-1
    pose = tree_map(lambda new, old: torch.where(run_gn, new, old),
                    (state.pose @ Pose(q_es, t_es).inverse()).normalized(), state.pose)

    def to_end(c: Cloud) -> Cloud:
        xyz = DS.transform_to_end(c.xyz, c.rel_time, q_es, t_es, scan_period)
        return c._replace(xyz=torch.where(run_gn, xyz, c.xyz),
                          rel_time=torch.where(run_gn, torch.zeros_like(c.rel_time), c.rel_time))

    new_state = OdometryState(
        pose=pose, q_es=q_es, t_es=t_es,
        last_corner=to_end(feats.corner_less_sharp), last_surf=to_end(feats.surf_less_flat),
        initialized=torch.ones((), dtype=torch.bool, device=q_es.device))
    outputs = {"pose": pose, "q_es": q_es, "t_es": t_es,
               "corner_cloud": new_state.last_corner, "surf_cloud": new_state.last_surf}
    return {"odom": new_state, "odo_out": outputs}
