"""Scan-to-map refinement and the flat voxel map store, the LiDAR-only
LOAM back end (port of lio_mapping_tpu.models.mapping; reference
PointMapping.cc).

* The map is one fixed-capacity padded point array per feature kind with a
  moving origin (``VoxelMapStore``); inserting is a union with the new
  world points, a wide-key voxel filter and a crop to the reference's
  active 21x21x11 cube region around the pose.
* ``optimize_to_map``: corner rows from 5-NN line fits, surf rows from 5-NN
  plane fits with the 0.2 m planarity check, the +-60 deg FOV cone gate,
  6-DoF GN with the eigenvalue-100 degeneracy projection taken at
  iteration 0, and the 0.05 deg / 0.05 cm abort. The reference's
  ``lax.while_loop`` is a Python loop reading one device flag an
  iteration. The surf search goes through ``ops/knn.knn`` with the match
  gate (on the card: the CUDA kernel); the corner search is pinned to the
  plain tiled version, as the reference pins it: near-tie flips there
  tripled the LOAM ATE on the TPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import LioConfig
from ..ops import gn as GN
from ..ops import knn as KNN
from ..ops import voxel as VX
from ..ops.cloud import Cloud
from ..ops.fits import line_fit, plane_fit, point_to_line_residual
from ..utils import quaternion as quat
from ..utils.se3 import Pose


class VoxelMapStore(NamedTuple):
    """Flat fixed-capacity voxel-centroid map with a moving origin.

    xyz: (CAP, 3) world coords; mask: (CAP,); origin: (3,) recenter point.
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    origin: torch.Tensor

    @staticmethod
    def empty(cap: int, dtype=torch.float32, device=None) -> "VoxelMapStore":
        return VoxelMapStore(
            xyz=torch.zeros((cap, 3), dtype=dtype, device=device),
            mask=torch.zeros((cap,), dtype=torch.bool, device=device),
            origin=torch.zeros((3,), dtype=dtype, device=device),
        )


class MappingState(NamedTuple):
    corner_map: VoxelMapStore
    surf_map: VoxelMapStore
    pose: Pose                  # transform_aft_mapped_ (tobe after update)
    pose_bef: Pose              # transform_bef_mapped_ (last odometry input)
    initialized: torch.Tensor   # bool


def init_state(cfg: LioConfig, dtype=torch.float32, device=None) -> MappingState:
    m = cfg.mapping
    return MappingState(
        corner_map=VoxelMapStore.empty(m.map_cloud_cap, dtype, device),
        surf_map=VoxelMapStore.empty(m.map_cloud_cap, dtype, device),
        pose=Pose.identity(dtype=dtype, device=device),
        pose_bef=Pose.identity(dtype=dtype, device=device),
        initialized=torch.tensor(False, device=device),
    )


def insert_into_map(vm: VoxelMapStore, points, mask, pose: Pose, leaf: float,
                    cfg: LioConfig) -> VoxelMapStore:
    """UpdateMapDatabase: union + wide-key voxel re-downsample + recenter.

    The active region is the reference's cube grid, +-525 m (xy) / +-275 m
    (z) around the snapped origin (PointMapping.cc:77-83,819-921), capped
    by what the 13-bit keys hold at this leaf."""
    m = cfg.mapping
    ext_xy = 0.5 * m.cube_length * m.cube_size_m
    ext_z = 0.5 * m.cube_height * m.cube_size_m
    key_limit = 0.95 * leaf * VX.HALF_CELLS_WIDE
    extent = torch.tensor([min(ext_xy, key_limit), min(ext_xy, key_limit),
                           min(ext_z, key_limit)], dtype=vm.xyz.dtype, device=vm.xyz.device)
    world = pose.apply(points)
    # the origin snaps to a coarse leaf multiple so the voxel grid stays
    # aligned as it follows the pose
    snap = leaf * 64.0
    new_origin = torch.round(pose.t / snap) * snap

    all_xyz = torch.cat([vm.xyz - new_origin[None, :], world - new_origin[None, :]], dim=0)
    in_range = torch.all(torch.abs(all_xyz) < extent[None, :], dim=-1)
    all_mask = torch.cat([vm.mask, mask], dim=0) & in_range
    out_xyz, out_mask, _ = VX.voxel_downsample(all_xyz, all_mask, leaf, vm.xyz.shape[0],
                                               wide=True)
    return VoxelMapStore(xyz=out_xyz + new_origin[None, :], mask=out_mask, origin=new_origin)


def _fov_ok(sel, pose: Pose):
    """+-60 deg FOV cone around the sensor's z axis (PointMapping.cc:487-503)."""
    z_axis = pose.apply_one(torch.tensor([0.0, 0.0, 10.0], dtype=sel.dtype, device=sel.device))
    sq1 = torch.sum((sel - pose.t[None, :]) ** 2, dim=-1)
    sq2 = torch.sum((sel - z_axis[None, :]) ** 2, dim=-1)
    k = 10.0 * math.sqrt(3.0)
    chk1 = 100.0 + sq1 - sq2 - k * torch.sqrt(sq1)
    chk2 = 100.0 + sq1 - sq2 + k * torch.sqrt(sq1)
    return (chk1 < 0) & (chk2 > 0)


def optimize_to_map(corner_db, corner_db_mask, surf_db, surf_db_mask,
                    corner_stack, corner_stack_mask, surf_stack, surf_stack_mask,
                    pose0: Pose, cfg: LioConfig, *, yaw_constrained: bool = False) -> Pose:
    """The scan-to-map GN (OptimizeTransformTobeMapped, PointMapping.cc:325-753).

    ``yaw_constrained`` selects the MapBuilder variant (MapBuilder.cc:624-1014):
    the rotation Jacobian damped by diag(5e-3, 5e-3, 1) in the body frame
    and a LEFT-multiplied DeltaQ update."""
    mcfg = cfg.mapping
    dtype, dev = pose0.t.dtype, pose0.t.device
    # too small a map: the reference runs the loop and then keeps pose0
    enough = (torch.sum(corner_db_mask) > 10) & (torch.sum(surf_db_mask) > 100)
    if not bool(enough):  # host sync
        return pose0
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    right_info = torch.diag(torch.tensor([5e-3, 5e-3, 1.0], dtype=dtype, device=dev))
    p_all = torch.cat([corner_stack, surf_stack], dim=0)
    skew_p = quat.skew(p_all)
    q, t = pose0.q, pose0.t
    proj = degen = None
    for it in range(mcfg.max_iterations):
        pose = Pose(q, t)

        # corner rows: 5-NN line fit, the search pinned to the plain version
        c_sel = pose.apply(corner_stack)
        c_d, c_idx = KNN.knn(c_sel, corner_stack_mask, corner_db, corner_db_mask, k=5,
                             prune_beyond=mcfg.min_match_sq_dis, force_tiled=True)
        c_ok = c_d[:, 4] < mcfg.min_match_sq_dis
        centroid, direction, line_ok = line_fit(corner_db[c_idx.to(torch.int64)], c_ok)
        ld2, c_n = point_to_line_residual(c_sel, centroid, direction)
        s_c = 1.0 - 0.9 * torch.abs(ld2)
        w_c = corner_stack_mask & c_ok & line_ok & (s_c > 0.1)

        # surf rows: 5-NN plane fit (the CUDA kernel on the card)
        s_sel = pose.apply(surf_stack)
        s_d, s_idx = KNN.knn(s_sel, surf_stack_mask, surf_db, surf_db_mask, k=5,
                             prune_beyond=mcfg.min_match_sq_dis)
        s_ok = s_d[:, 4] < mcfg.min_match_sq_dis
        pw, pd, plane_ok = plane_fit(surf_db[s_idx.to(torch.int64)], s_ok, mcfg.min_plane_dis)
        pd2 = torch.sum(pw * s_sel, dim=-1) + pd
        rng = torch.sqrt(torch.clamp_min(torch.linalg.norm(s_sel, dim=-1), 1e-12))
        s_s = 1.0 - 0.9 * torch.abs(pd2) / rng
        # the reference flips the plane so pd2 > 0 (PointMapping.cc:557-577);
        # d and w flip together in a GN row, which is the same
        w_s = surf_stack_mask & s_ok & plane_ok & (s_s > 0.1)

        # GN rows on the ORIGINAL stack points
        w_all = torch.cat([s_c[:, None] * c_n, s_s[:, None] * pw], dim=0)
        d_all = torch.cat([s_c * ld2, s_s * pd2], dim=0)
        row_ok = torch.cat([w_c & _fov_ok(c_sel, pose), w_s & _fov_ok(s_sel, pose)], dim=0)

        rot = quat.to_matrix(q)
        if yaw_constrained:
            # J_r damped to ~yaw-only in the body frame (MapBuilder.cc:894-905)
            j_r = -torch.einsum("ni,nij->nj", w_all, (rot @ skew_p) @ rot.T @ right_info)
        else:
            j_r = -torch.einsum("ni,nij->nj", w_all, rot @ skew_p)
        jac = torch.cat([j_r, w_all], dim=1)
        wrow = row_ok.to(dtype)
        n_rows = torch.sum(wrow)
        jw = jac * wrow[:, None]
        ata = jw.T @ jac
        atb = jw.T @ (-d_all)
        x = GN.solve(ata + 1e-9 * eye6, atb)
        if it == 0:
            g = GN.degeneracy_projection(ata, mcfg.degeneracy_eigen_th)
            proj, degen = g.proj, g.is_degenerate
        x = torch.where(degen, proj @ x, x)
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        few = n_rows < 50  # the reference's `continue` (:610)
        x = torch.where(few, torch.zeros_like(x), x)

        t_new = t + x[3:6]
        if yaw_constrained:
            # left-multiplied DeltaQ (MapBuilder.cc:984-986)
            q_new = quat.normalize(quat.qmul(quat.delta_q(x[0:3]), q))
        else:
            q_new = quat.normalize(quat.qmul(q, quat.delta_q(x[0:3])))
        t_new = torch.where(torch.isfinite(t_new), t_new, torch.zeros_like(t_new))
        delta_r = quat.angular_distance(q, q_new) * (180.0 / math.pi)
        delta_t = torch.linalg.norm(x[3:6]) * 100.0
        done = (~few) & (delta_r < mcfg.delta_r_abort_deg) & (delta_t < mcfg.delta_t_abort_cm)
        q, t = q_new, t_new
        if bool(done):  # one host sync per GN iteration
            break
    return Pose(q, t)


def mapping_step(state: MappingState, corner_cloud: Cloud, surf_cloud: Cloud,
                 odom_pose: Pose, cfg: LioConfig) -> Tuple[MappingState, dict]:
    """One PointMapping::Process call (PointMapping.cc:765-1110)."""
    m = cfg.mapping

    # TransformAssociateToMap: chain the odometry increment (:755-758)
    incre = state.pose_bef.inverse() @ odom_pose
    pose_tobe = (state.pose @ incre).normalized()

    # downsample the incoming stacks (corner 0.2, surf 0.4; :1014-1023)
    c_xyz, c_mask, _ = VX.voxel_downsample(corner_cloud.xyz, corner_cloud.mask,
                                           m.corner_filter_size, cfg.estimator.corner_stack_cap)
    s_xyz, s_mask, _ = VX.voxel_downsample(surf_cloud.xyz, surf_cloud.mask,
                                           m.surf_filter_size, cfg.estimator.surf_stack_cap)

    # the first call maps at the chained pose; the reference computes the
    # optimisation then and discards it
    pose_opt = pose_tobe
    if bool(state.initialized):  # host sync
        pose_opt = optimize_to_map(
            state.corner_map.xyz, state.corner_map.mask, state.surf_map.xyz,
            state.surf_map.mask, c_xyz, c_mask, s_xyz, s_mask, pose_tobe, cfg)

    corner_map = insert_into_map(state.corner_map, c_xyz, c_mask, pose_opt,
                                 m.corner_filter_size, cfg)
    surf_map = insert_into_map(state.surf_map, s_xyz, s_mask, pose_opt, m.surf_filter_size, cfg)
    new_state = MappingState(corner_map=corner_map, surf_map=surf_map, pose=pose_opt,
                             pose_bef=odom_pose,
                             initialized=torch.tensor(True, device=state.initialized.device))
    outputs = {"pose": pose_opt, "n_map_corner": torch.sum(state.corner_map.mask),
               "n_map_surf": torch.sum(state.surf_map.mask)}
    return new_state, outputs
