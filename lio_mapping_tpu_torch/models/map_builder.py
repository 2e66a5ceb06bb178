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
  plain tiled version, as in the LOAM back end;
* ``MapBuilder``: the builder's state and step, one CUDA graph a step on
  the card (the reference's jitted ``map_builder_step``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import LioConfig
from ..ops.cloud import Cloud
from ..utils import quaternion as quat
from ..utils import timing as TM
from ..utils.se3 import Pose
from ..utils.tree import tree_map
from . import estimator as EST
from . import step_graph as SG
from .mapping import MappingState, init_state, mapping_program

__all__ = ["MapBuilder", "init_state", "map_builder_program", "map_builder_step",
           "transform_4d_associate"]


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
    pose, later ones refine it against the map first. Runs
    :func:`map_builder_program` eagerly."""
    v = {"map": state, "corner_cloud": corner_cloud, "surf_cloud": surf_cloud,
         "odom_pose": odom_pose}
    new_state, out = map_builder_program(EST.EagerRun(), v, cfg)
    return new_state, {"pose": out["pose"]}


def map_builder_program(run, v: dict, cfg: LioConfig) -> Tuple[MappingState, dict]:
    """The builder's step as a program: ``mapping.mapping_program`` with
    the yaw-only prediction and the yaw-constrained GN (same values in
    ``v``)."""
    return mapping_program(run, v, cfg, predict=transform_4d_associate, yaw_constrained=True)


class MapBuilder:
    """The builder's map state and its step. On a CUDA device (``graphs``,
    the default there) each step is one CUDA graph
    (``models/step_graph.StepGraphs``) that reads nothing back: the step's
    clouds and pose are copied into the graph's input buffers, the map
    state lives in its static buffers from step to step, and the returned
    pose is a copy that no later step overwrites. ``graphs=False`` (and
    the CPU) runs :func:`map_builder_step` eagerly; both give the same
    bits."""

    def __init__(self, cfg: LioConfig, device=None, dtype=torch.float32, graphs: bool = None):
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        TM.from_env(self.device)
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError("graphs=True needs a CUDA device")
        self.graphs = on_card if graphs is None else bool(graphs)
        self._step_graphs = None  # made at first use
        self.state = init_state(cfg, dtype, self.device)

    def graph_captures(self) -> int:
        """CUDA graphs captured so far (0 on the eager path)."""
        return 0 if self._step_graphs is None else self._step_graphs.stats["captures"]

    def step(self, corner_cloud: Cloud, surf_cloud: Cloud, odom_pose: Pose) -> dict:
        """One builder step on the estimator's (copied) outputs; returns
        ``{"pose": refined pose}``. With the tracer on, a host span
        (``builder``) with a stamp launched before its device work."""
        tr = TM.TRACER
        if tr is None:
            return self._step(corner_cloud, surf_cloud, odom_pose)
        with tr.span("builder", device=True):
            return self._step(corner_cloud, surf_cloud, odom_pose)

    def _step(self, corner_cloud: Cloud, surf_cloud: Cloud, odom_pose: Pose) -> dict:
        if not self.graphs:
            self.state, out = map_builder_step(self.state, corner_cloud, surf_cloud, odom_pose,
                                               self.cfg)
            return out
        if self._step_graphs is None:
            self._step_graphs = SG.StepGraphs(self.device)
        g, cfg = self._step_graphs, self.cfg
        v = {}
        for name, value in (("map", self.state), ("corner_cloud", corner_cloud),
                            ("surf_cloud", surf_cloud), ("odom_pose", odom_pose)):
            g.bind(v, name, value)

        def program(v):
            state, out = map_builder_program(g, v, cfg)
            return {"map": state, "pose": out["pose"]}

        g.stretch(("map_builder",), program, v)
        self.state = v["map"]
        with TM.span("outputs"):
            return {"pose": tree_map(torch.clone, v["pose"])}
