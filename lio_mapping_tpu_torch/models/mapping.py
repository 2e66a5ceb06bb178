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
  ``lax.while_loop`` is one conditional body an iteration under a device
  flag (``gn_bodies``): ``mapping_program`` is the whole step as a
  program, run eagerly by ``mapping_step`` (one host read an iteration)
  or captured into one CUDA graph by ``LoamPipeline`` on the card
  (``models/step_graph.py``). The surf search goes through ``ops/knn.knn`` with the match
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
from . import estimator as EST


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
    extent = EST.device_vector([min(ext_xy, key_limit), min(ext_xy, key_limit),
                                min(ext_z, key_limit)], vm.xyz.dtype, vm.xyz.device)
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
    z_axis = pose.apply_one(EST.device_vector([0.0, 0.0, 10.0], sel.dtype, sel.device))
    sq1 = torch.sum((sel - pose.t[None, :]) ** 2, dim=-1)
    sq2 = torch.sum((sel - z_axis[None, :]) ** 2, dim=-1)
    k = 10.0 * math.sqrt(3.0)
    chk1 = 100.0 + sq1 - sq2 - k * torch.sqrt(sq1)
    chk2 = 100.0 + sq1 - sq2 + k * torch.sqrt(sq1)
    return (chk1 < 0) & (chk2 > 0)


def optimize_to_map(corner_db, corner_db_mask, surf_db, surf_db_mask,
                    corner_stack, corner_stack_mask, surf_stack, surf_stack_mask,
                    pose0: Pose, cfg: LioConfig, *, yaw_constrained: bool = False) -> Pose:
    """The scan-to-map GN (OptimizeTransformTobeMapped, PointMapping.cc:325-753),
    run eagerly (one host read an iteration).

    ``yaw_constrained`` selects the MapBuilder variant (MapBuilder.cc:624-1014):
    the rotation Jacobian damped by diag(5e-3, 5e-3, 1) in the body frame
    and a LEFT-multiplied DeltaQ update."""
    v = _gn_start((corner_db, corner_db_mask, surf_db, surf_db_mask),
                  (corner_stack, corner_stack_mask, surf_stack, surf_stack_mask), pose0,
                  torch.ones((), dtype=torch.bool, device=pose0.t.device))
    gn_bodies(EST.EagerRun(), v, cfg, yaw_constrained)
    return _gn_pose(v)


def _gn_start(db, stacks, pose0: Pose, go) -> dict:
    """The GN's values before its first iteration: it runs where ``go``
    and the map is big enough (the reference runs its loop on too small a
    map and keeps ``pose0``), from ``pose0``."""
    enough = (torch.sum(db[1]) > 10) & (torch.sum(db[3]) > 100)
    go = go & enough
    dtype, dev = pose0.t.dtype, pose0.t.device
    return {"map_db": db, "map_stacks": stacks, "map_pose0": pose0, "map_go": go,
            "map_stop": ~go, "map_q": pose0.q.clone(), "map_t": pose0.t.clone(),
            "map_skew": quat.skew(torch.cat([stacks[0], stacks[2]], dim=0)),
            "map_proj": (torch.eye(6, dtype=dtype, device=dev),
                         torch.zeros((), dtype=torch.bool, device=dev))}


def gn_bodies(run, v: dict, cfg: LioConfig, yaw_constrained: bool):
    """The GN's iterations as conditional bodies under ``map_stop``
    (``estimator.step_program``'s protocol), over the values
    :func:`_gn_start` made."""
    for it in range(cfg.mapping.max_iterations):
        run.when(v, "map_stop", ("map", it),
                 lambda v, it=it: _gn_iteration(v, cfg, it, yaw_constrained))


def _gn_pose(v) -> Pose:
    """The refined pose, or ``pose0`` where the GN did not run (the
    reference's select)."""
    go, pose0 = v["map_go"], v["map_pose0"]
    return Pose(torch.where(go, v["map_q"], pose0.q), torch.where(go, v["map_t"], pose0.t))


def _gn_iteration(v, cfg: LioConfig, it: int, yaw_constrained: bool):
    """GN iteration ``it`` (a conditional body): the associations at the
    current pose, the step (the degeneracy projection taken at iteration
    0) and the exit test."""
    mcfg = cfg.mapping
    corner_db, corner_db_mask, surf_db, surf_db_mask = v["map_db"]
    corner_stack, corner_stack_mask, surf_stack, surf_stack_mask = v["map_stacks"]
    q, t = v["map_q"], v["map_t"]
    dtype, dev = t.dtype, t.device
    pose = Pose(q, t)
    new = {}

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
        right_info = torch.diag(EST.device_vector([5e-3, 5e-3, 1.0], dtype, dev))
        j_r = -torch.einsum("ni,nij->nj", w_all, (rot @ v["map_skew"]) @ rot.T @ right_info)
    else:
        j_r = -torch.einsum("ni,nij->nj", w_all, rot @ v["map_skew"])
    jac = torch.cat([j_r, w_all], dim=1)
    wrow = row_ok.to(dtype)
    n_rows = torch.sum(wrow)
    jw = jac * wrow[:, None]
    ata = jw.T @ jac
    atb = jw.T @ (-d_all)
    x = GN.solve(ata + 1e-9 * torch.eye(6, dtype=dtype, device=dev), atb)
    if it == 0:
        g = GN.degeneracy_projection(ata, mcfg.degeneracy_eigen_th)
        new["map_proj"] = (g.proj, g.is_degenerate)
    proj, degen = new.get("map_proj") or v["map_proj"]
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
    new.update(map_q=q_new, map_t=t_new, map_stop=(~few) & (delta_r < mcfg.delta_r_abort_deg)
               & (delta_t < mcfg.delta_t_abort_cm))
    return new


def associate_to_map(state: MappingState, odom_pose: Pose) -> Pose:
    """TransformAssociateToMap: the odometry increment since the last
    mapped sweep chained onto the mapped pose (PointMapping.cc:755-758)."""
    return (state.pose @ (state.pose_bef.inverse() @ odom_pose)).normalized()


def mapping_step(state: MappingState, corner_cloud: Cloud, surf_cloud: Cloud,
                 odom_pose: Pose, cfg: LioConfig) -> Tuple[MappingState, dict]:
    """One PointMapping::Process call (PointMapping.cc:765-1110): runs
    :func:`mapping_program` eagerly."""
    v = {"map": state, "corner_cloud": corner_cloud, "surf_cloud": surf_cloud,
         "odom_pose": odom_pose}
    return mapping_program(EST.EagerRun(), v, cfg)


def mapping_program(run, v: dict, cfg: LioConfig, *, predict=associate_to_map,
                    yaw_constrained: bool = False) -> Tuple[MappingState, dict]:
    """A scan-to-map step as stretches and conditional bodies
    (``estimator.step_program``'s protocol): the prediction (``predict``:
    (state, odometry pose) -> pose to be mapped), the stacks' downsample,
    the GN's iterations as bodies under ``map_stop`` (set from the start
    unless the map was initialized and is big enough, the reference's
    select at ``mapping_step``) and the map insert. ``v`` holds ``map``
    (the state), ``corner_cloud``, ``surf_cloud`` and ``odom_pose``; leaves
    ``map`` the new state and ``map_out`` the outputs, and returns both.
    ``yaw_constrained`` and ``models/map_builder.py``'s ``predict`` make
    it the 4D builder's step."""
    run.stretch(("map", "head"), lambda v: _map_head(v, cfg, predict), v)
    gn_bodies(run, v, cfg, yaw_constrained)
    run.stretch(("map", "tail"), lambda v: _map_tail(v, cfg), v)
    return v["map"], v["map_out"]


def _map_head(v, cfg: LioConfig, predict):
    m = cfg.mapping
    state = v["map"]
    corner_cloud, surf_cloud = v["corner_cloud"], v["surf_cloud"]
    # downsample the incoming stacks (corner 0.2, surf 0.4; :1014-1023)
    c_xyz, c_mask, _ = VX.voxel_downsample(corner_cloud.xyz, corner_cloud.mask,
                                           m.corner_filter_size, cfg.estimator.corner_stack_cap)
    s_xyz, s_mask, _ = VX.voxel_downsample(surf_cloud.xyz, surf_cloud.mask,
                                           m.surf_filter_size, cfg.estimator.surf_stack_cap)
    # the first call maps at the predicted pose; the reference computes the
    # optimisation then and discards it
    return _gn_start((state.corner_map.xyz, state.corner_map.mask, state.surf_map.xyz,
                      state.surf_map.mask), (c_xyz, c_mask, s_xyz, s_mask),
                     predict(state, v["odom_pose"]), state.initialized)


def _map_tail(v, cfg: LioConfig):
    m = cfg.mapping
    state = v["map"]
    pose_opt = _gn_pose(v)
    c_xyz, c_mask, s_xyz, s_mask = v["map_stacks"]
    corner_map = insert_into_map(state.corner_map, c_xyz, c_mask, pose_opt,
                                 m.corner_filter_size, cfg)
    surf_map = insert_into_map(state.surf_map, s_xyz, s_mask, pose_opt, m.surf_filter_size, cfg)
    new_state = MappingState(corner_map=corner_map, surf_map=surf_map, pose=pose_opt,
                             pose_bef=v["odom_pose"],
                             initialized=torch.ones((), dtype=torch.bool, device=pose_opt.t.device))
    outputs = {"pose": pose_opt, "n_map_corner": torch.sum(state.corner_map.mask),
               "n_map_surf": torch.sum(state.surf_map.mask)}
    return {"map": new_state, "map_out": outputs}
