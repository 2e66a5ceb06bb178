"""Global "4D" map builder: yaw-constrained scan-to-map refinement of the
estimator's output (port of lio_mapping_tpu.models.map_builder; reference
MapBuilder.cc).

Roll and pitch are observable in the tightly-coupled estimator through
gravity, so the builder keeps them and refines yaw and translation only:

* ``transform_4d_associate`` (MapBuilder.cc:55-75): predict with the full
  incremental transform but keep only its yaw offset over the incoming
  odometry rotation;
* ``map_builder_step`` (MapBuilder.cc:220-540): the scan-to-map GN of
  ``models/mapping.py`` with ``yaw_constrained=True`` (the rotation
  Jacobian damped by diag(5e-3, 5e-3, 1) in the body frame, a
  left-multiplied update) against the builder's own map stores. Its surf
  search runs the CUDA KNN on the card; the corner search stays on the
  plain tiled version, as in the LOAM back end.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import LioConfig
from ..ops import voxel as VX
from ..ops.cloud import Cloud
from ..utils import quaternion as quat
from ..utils.se3 import Pose
from .mapping import MappingState, init_state, insert_into_map, optimize_to_map

__all__ = ["init_state", "map_builder_step", "transform_4d_associate"]


def transform_4d_associate(state: MappingState, odom_pose: Pose) -> Pose:
    """Yaw-only pre-alignment (MapBuilder.cc:55-75)."""
    full = (state.pose @ (state.pose_bef.inverse() @ odom_pose)).normalized()
    y_diff = (quat.rot_to_ypr(quat.to_matrix(full.q))[0]
              - quat.rot_to_ypr(quat.to_matrix(odom_pose.q))[0])
    zero = torch.zeros((), dtype=odom_pose.t.dtype, device=odom_pose.t.device)
    rot_diff = quat.ypr_to_rot(torch.stack([y_diff, zero, zero]))
    q_new = quat.normalize(quat.qmul(quat.from_matrix(rot_diff), quat.normalize(odom_pose.q)))
    return Pose(q_new, full.t)


def map_builder_step(state: MappingState, corner_cloud: Cloud, surf_cloud: Cloud,
                     odom_pose: Pose, cfg: LioConfig) -> Tuple[MappingState, dict]:
    """One MapBuilder::ProcessMap call: the first maps at the predicted
    pose, later ones refine it against the map first."""
    m = cfg.mapping
    pose_tobe = transform_4d_associate(state, odom_pose)
    c_xyz, c_mask, _ = VX.voxel_downsample(corner_cloud.xyz, corner_cloud.mask,
                                           m.corner_filter_size, cfg.estimator.corner_stack_cap)
    s_xyz, s_mask, _ = VX.voxel_downsample(surf_cloud.xyz, surf_cloud.mask, m.surf_filter_size,
                                           cfg.estimator.surf_stack_cap)
    pose_opt = pose_tobe
    if bool(state.initialized):  # host sync
        pose_opt = optimize_to_map(
            state.corner_map.xyz, state.corner_map.mask, state.surf_map.xyz,
            state.surf_map.mask, c_xyz, c_mask, s_xyz, s_mask, pose_tobe, cfg,
            yaw_constrained=True)
    new_state = MappingState(
        corner_map=insert_into_map(state.corner_map, c_xyz, c_mask, pose_opt,
                                   m.corner_filter_size, cfg),
        surf_map=insert_into_map(state.surf_map, s_xyz, s_mask, pose_opt, m.surf_filter_size,
                                 cfg),
        pose=pose_opt, pose_bef=odom_pose,
        initialized=torch.tensor(True, device=state.initialized.device))
    return new_state, {"pose": pose_opt}
