"""The full per-sweep LIO estimator step on a mesh of ranks (port of
lio_mapping_tpu.parallel.lio_dist).

``make_sharded_lio_step`` wraps ``models.estimator.lio_step_impl`` with the
mesh as its ``axis``: every rank gets the same inputs (state, cloud, IMU)
and returns the same outputs. Inside, the feature association rank-slices
every frame's stack rows, so the KNN and the plane and line fits run on
1/D of the rows per rank; with ``map_shard`` the local map is rank-sliced
too and the association runs the ring KNN (``parallel/map_sharded``). The
mini-GN, the convergence gates, the window LM and the pivot
marginalization sum their plane terms over the ranks (``multihost.psum``);
the small dense solves run on every rank, on the same bits.
"""

from __future__ import annotations

from ..config import LioConfig
from ..models import estimator as EST
from . import multihost as MH


def make_mesh(n_devices: int = None, device="cuda") -> MH.Mesh:
    """The mesh of the joined process group (one rank per process) on
    ``device``'s type; with ``n_devices``, it must have that many ranks."""
    mesh = MH.global_mesh(device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"the process group has {mesh.size} ranks, not {n_devices}")
    return mesh


def check_caps(cfg: LioConfig, n_devices: int):
    """Stack/map capacities must divide the mesh so rank-slicing keeps
    every row (a remainder would silently drop features)."""
    e = cfg.estimator
    caps = {"surf_stack_cap": e.surf_stack_cap}
    if e.use_corner:
        caps["corner_stack_cap"] = e.corner_stack_cap
        caps["local_map_corner_cap"] = e.local_map_corner_cap
    caps["local_map_filtered_cap"] = e.local_map_filtered_cap
    for name, cap in caps.items():
        if cap % n_devices != 0:
            raise ValueError(
                f"{name}={cap} not divisible by mesh size {n_devices}")


def make_sharded_lio_step(mesh: MH.Mesh, cfg: LioConfig, map_shard: bool = False):
    """The distributed ``lio_step``: (state, surf_cloud, samples
    [, corner_cloud]) -> (new_state, outputs), the same on every rank."""
    check_caps(cfg, mesh.size)

    def step(state, surf_cloud, samples, corner_cloud=None):
        return EST.lio_step_impl(state, surf_cloud, samples, cfg, corner_cloud,
                                 axis=mesh, map_shard=map_shard)
    return step
