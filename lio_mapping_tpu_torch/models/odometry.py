"""Scan-to-scan LOAM odometry (port of lio_mapping_tpu.models.odometry;
reference PointOdometry.cc:237-683).

Constant-velocity prior, per-iteration deskew of the query features,
correspondences re-searched every 5th iteration (corner: 1-NN + other-ring
NN; surf: 1-NN + same-ring + other-ring NN), distance-damped weights from
iteration 5, 6x6 normal equations with the eigenvalue-10 degeneracy
projection, abort at 0.1 deg / 0.1 cm. The GN ``while_loop`` is a Python
loop reading one device flag per iteration.
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
    ``enable`` mirrors the reference's /enable_odom service."""
    oc = cfg.odometry
    scan_period = cfg.sensor.scan_period
    dtype, dev = state.t_es.dtype, state.t_es.device
    if enable is None:
        enable = torch.tensor(True, device=dev)
    enable = torch.as_tensor(enable, device=dev)

    corner_q = feats.corner_sharp
    surf_q = feats.surf_flat
    last_c = state.last_corner
    last_s = state.last_surf

    enough = (last_c.count() > oc.min_corner_points) & (last_s.count() > oc.min_surf_points)
    run_gn = state.initialized & enough & enable

    def deskew_queries(q_es, t_es):
        cq = DS.transform_to_start(corner_q.xyz, corner_q.rel_time, q_es, t_es, scan_period)
        sq = DS.transform_to_start(surf_q.xyz, surf_q.rel_time, q_es, t_es, scan_period)
        return cq, sq

    def gather(c: Cloud, i):
        return c.xyz[i.to(torch.int64)]

    def associate(cq_xyz, sq_xyz):
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

    def build_system(q_es, t_es, corr, iter_count):
        ci1, ci2, c_ok, si1, si2, si3, s_ok = corr
        cq_xyz, sq_xyz = deskew_queries(q_es, t_es)
        weighted = iter_count >= oc.weight_start_iter

        ld2, cn = _edge_residual(cq_xyz, gather(last_c, ci1), gather(last_c, ci2))
        s_c = 1.0 - 1.8 * torch.abs(ld2) if weighted else torch.ones_like(ld2)
        w_c = (s_c > 0.1) & (ld2 != 0.0) & c_ok & corner_q.mask

        pd2, sn = _plane_residual(sq_xyz, gather(last_s, si1), gather(last_s, si2),
                                  gather(last_s, si3))
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
        return jac, -0.1 * d_all, row_ok.to(dtype), torch.sum(row_ok.to(torch.int32))

    q_es_out, t_es_out = state.q_es, state.t_es
    if bool(run_gn):  # host sync: the GN only runs on an initialized, fed stage
        q_es, t_es = state.q_es, state.t_es
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        corr = proj = degen = None
        it = 0
        while it < oc.max_iterations:
            if it % oc.reassociate_every == 0:
                corr = associate(*deskew_queries(q_es, t_es))
            jac, rhs, w, n_rows = build_system(q_es, t_es, corr, it)
            jw = jac * w[:, None]
            ata = jw.T @ jac
            atb = jw.T @ rhs
            x = GN.solve(ata + 1e-12 * eye6, atb)
            if it == 0:
                g = GN.degeneracy_projection(ata, oc.degeneracy_eigen_th)
                proj, degen = g.proj, g.is_degenerate
            x = torch.where(degen, proj @ x, x)
            x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
            skip = n_rows < 10  # reference `continue` (PointOdometry.cc:535)
            x = torch.where(skip, torch.zeros_like(x), x)
            t_new = t_es + x[3:6]
            q_new = quat.normalize(quat.qmul(q_es, quat.delta_q(x[0:3])))
            t_new = torch.where(torch.isfinite(t_new), t_new, torch.zeros_like(t_new))
            delta_r = quat.angular_distance(q_es, q_new) * (180.0 / math.pi)
            delta_t = torch.linalg.norm(x[3:6]) * 100.0
            done = (~skip) & (delta_r < oc.delta_r_abort_deg) & (delta_t < oc.delta_t_abort_cm)
            q_es, t_es = q_new, t_new
            it += 1
            if bool(done):  # one host sync per GN iteration
                break
        q_es_out, t_es_out = q_es, t_es
        # transform_sum_ = transform_sum_ * transform_es_^-1
        new_pose = (state.pose @ Pose(q_es_out, t_es_out).inverse()).normalized()
    else:
        new_pose = state.pose

    def to_end(c: Cloud) -> Cloud:
        # when the odometry did not run, clouds pass through raw
        if not bool(run_gn):
            return c
        xyz = DS.transform_to_end(c.xyz, c.rel_time, q_es_out, t_es_out, scan_period)
        return c._replace(xyz=xyz, rel_time=torch.zeros_like(c.rel_time))

    new_state = OdometryState(
        pose=new_pose, q_es=q_es_out, t_es=t_es_out,
        last_corner=to_end(feats.corner_less_sharp),
        last_surf=to_end(feats.surf_less_flat),
        initialized=torch.tensor(True, device=dev),
    )
    outputs = {
        "pose": new_pose,
        "q_es": q_es_out,
        "t_es": t_es_out,
        "corner_cloud": new_state.last_corner,
        "surf_cloud": new_state.last_surf,
    }
    return new_state, outputs

