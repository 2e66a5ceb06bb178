"""Distributed sliding-window bundle adjustment (port of
lio_mapping_tpu.parallel.sharded_ba).

Each rank holds a shard of the plane-feature rows; ``ops.solver.solve_window``
with ``psum_axis`` sums the rows' normal equations over the ranks
(``multihost.psum``) and runs the same LM on every rank.
``solve_window_sharded`` is the reference's name for that call. The full
distributed estimator step lives in ``parallel/lio_dist.py``.
"""

from __future__ import annotations

from ..ops import marginalization as MG
from ..ops import solver as SV
from . import multihost as MH


def solve_window_sharded(x0: SV.OptStates, pres, g_vec, planes_local: SV.PlaneFactors,
                         prior: MG.PriorState, ex_prior, *, s: int, max_iterations: int = 10,
                         cauchy_scale: float = 1.0, opt_extrinsic, use_marg, axis: MH.Mesh,
                         planes_extra_local: SV.PlaneFactors = None):
    """LM over the window with this rank's plane rows ``planes_local`` (and
    ``planes_extra_local``); every other input is the same on every rank.
    Returns (x_opt, final total cost), the same on every rank."""
    x_fin, diag = SV.solve_window(
        x0, pres, g_vec, planes_local, prior, ex_prior, s=s, max_iterations=max_iterations,
        cauchy_scale=cauchy_scale, opt_extrinsic=opt_extrinsic, use_marg=use_marg,
        planes_extra=planes_extra_local, psum_axis=axis)
    return x_fin, diag.cost_marg + diag.cost_imu + diag.cost_plane
