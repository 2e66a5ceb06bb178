"""Reduced distributed window-BA step: association, solve, marginalization
(port of lio_mapping_tpu.parallel.distributed).

One call on every rank of a mesh:

1. feature association: each rank moves ITS shard of every frame's stack
   into the pivot frame, runs the exact KNN against the local map
   (replicated, or with ``..._mapsharded`` a block per rank and the ring
   KNN), and fits planes (``ops/fits``);
2. the sharded window BA (``parallel/sharded_ba``): plane normal equations
   summed over the ranks;
3. the sharded pivot marginalization (``ops/solver.marginalize_pivot`` with
   ``psum_axis``), giving the new factored prior.

This is the isolated BA core (no front end, no deskew, no mini-GN or
gates) that the reference's ``tools/bench_scaling.py`` times. The full
distributed estimator step is ``parallel/lio_dist.make_sharded_lio_step``.

The ``make_*`` wrappers take the full inputs, the same on every rank, and
cut this rank's shards themselves: the stacks' feature axis (axis 1) and,
map-sharded, the map's rows. They return (x_opt, new_prior, cost), the
same on every rank.
"""

from __future__ import annotations

import torch

from ..config import LioConfig
from ..ops import knn as KNN
from ..ops import marginalization as MG
from ..ops import solver as SV
from ..ops.fits import plane_fit
from ..utils import quaternion as quat
from ..utils.tree import tree_map
from . import multihost as MH
from . import sharded_ba as SB
from .map_sharded import ring_knn


def _plane_rows(point_sel, stack_mask, sq_d, neighbors, cfg: LioConfig):
    e = cfg.estimator
    nn_ok = sq_d[:, 4] < e.min_match_sq_dis
    w, d, plane_ok = plane_fit(neighbors, nn_ok, e.min_plane_dis)
    pd2 = torch.sum(w * point_sel, dim=-1) + d
    rng = torch.sqrt(torch.clamp_min(torch.linalg.norm(point_sel, dim=-1), 1e-12))
    s = 1.0 - 0.9 * torch.abs(pd2) / rng
    ok = stack_mask & nn_ok & plane_ok & (s > 0.1)
    coeff = torch.cat([s[:, None] * w, (s * d)[:, None]], dim=-1)
    return coeff, ok


def _associate_local(map_xyz, map_mask, stack_xyz, stack_mask, rel_q, rel_t, cfg: LioConfig):
    """This rank's association of one frame's stack shard against the
    replicated local map (as ``models/estimator._calculate_features``)."""
    point_sel = quat.rotate(rel_q[None, :], stack_xyz) + rel_t[None, :]
    sq_d, idx = KNN.knn(point_sel, stack_mask, map_xyz, map_mask, k=5,
                        prune_beyond=cfg.estimator.min_match_sq_dis)
    return _plane_rows(point_sel, stack_mask, sq_d, map_xyz[idx.to(torch.int64)], cfg)


def _associate_local_mapsharded(db_block, db_block_mask, stack_xyz, stack_mask, rel_q, rel_t,
                                cfg: LioConfig, mesh: MH.Mesh):
    """Association with the map sharded: the ring KNN carries the
    neighbour coordinates, so the plane fit needs no global gather."""
    point_sel = quat.rotate(rel_q[None, :], stack_xyz) + rel_t[None, :]
    sq_d, _, neighbors = ring_knn(point_sel, stack_mask, db_block, db_block_mask, k=5,
                                  axis=mesh, prune_beyond=cfg.estimator.min_match_sq_dis)
    return _plane_rows(point_sel, stack_mask, sq_d, neighbors, cfg)


def _solve_and_marginalize(x0, pres, g_vec, stacks_xyz, coeffs, oks, prior, cfg, mesh):
    e = cfg.estimator
    s = e.opt_window_size
    planes_local = SV.PlaneFactors(point=stacks_xyz, coeff=torch.stack(coeffs),
                                   mask=torch.stack(oks))
    no_ex = torch.tensor(False, device=x0.p.device)
    x_opt, cost = SB.solve_window_sharded(
        x0, pres, g_vec, planes_local, prior, None, s=s,
        max_iterations=e.max_solver_iterations, cauchy_scale=e.cauchy_loss_scale,
        opt_extrinsic=no_ex, use_marg=prior.valid, axis=mesh)
    new_prior = SV.marginalize_pivot(
        x_opt, tree_map(lambda a: a[0], pres), g_vec, planes_local, prior, s=s,
        cauchy_scale=e.cauchy_loss_scale, psum_axis=mesh)
    return x_opt, new_prior, cost


def distributed_window_step(x0: SV.OptStates, pres, g_vec, map_xyz, map_mask, stacks_xyz,
                            stacks_mask, rel_q, rel_t, prior: MG.PriorState, cfg: LioConfig,
                            mesh: MH.Mesh):
    """This rank's body of the sharded window step: ``stacks_*`` (S, F_local,
    ...) are its shard, the map and everything else replicated."""
    coeffs, oks = [], []
    for i in range(cfg.estimator.opt_window_size):
        c_i, ok_i = _associate_local(map_xyz, map_mask, stacks_xyz[i], stacks_mask[i],
                                     rel_q[i + 1], rel_t[i + 1], cfg)
        coeffs.append(c_i)
        oks.append(ok_i)
    return _solve_and_marginalize(x0, pres, g_vec, stacks_xyz, coeffs, oks, prior, cfg, mesh)


def distributed_window_step_mapsharded(x0: SV.OptStates, pres, g_vec, map_xyz_block,
                                       map_mask_block, stacks_xyz, stacks_mask, rel_q, rel_t,
                                       prior: MG.PriorState, cfg: LioConfig, mesh: MH.Mesh):
    """This rank's body with BOTH the feature axis and the map sharded: the
    map blocks pass round the ring once per association."""
    coeffs, oks = [], []
    for i in range(cfg.estimator.opt_window_size):
        c_i, ok_i = _associate_local_mapsharded(map_xyz_block, map_mask_block, stacks_xyz[i],
                                                stacks_mask[i], rel_q[i + 1], rel_t[i + 1],
                                                cfg, mesh)
        coeffs.append(c_i)
        oks.append(ok_i)
    return _solve_and_marginalize(x0, pres, g_vec, stacks_xyz, coeffs, oks, prior, cfg, mesh)


def _shard_axis1(a: torch.Tensor, mesh: MH.Mesh) -> torch.Tensor:
    chunk = a.shape[1] // mesh.size
    return a[:, mesh.rank * chunk:(mesh.rank + 1) * chunk].contiguous()


def make_distributed_step(mesh: MH.Mesh, cfg: LioConfig):
    """``distributed_window_step`` on full inputs (the same on every rank):
    each rank cuts its feature shard. Returns (x_opt, new_prior, cost)."""
    def step(x0, pres, g_vec, map_xyz, map_mask, stacks_xyz, stacks_mask, rel_q, rel_t, prior):
        return distributed_window_step(
            x0, pres, g_vec, map_xyz, map_mask, _shard_axis1(stacks_xyz, mesh),
            _shard_axis1(stacks_mask, mesh), rel_q, rel_t, prior, cfg, mesh)
    return step


def make_distributed_step_mapsharded(mesh: MH.Mesh, cfg: LioConfig):
    """``distributed_window_step_mapsharded`` on full inputs: each rank cuts
    its feature shard and its map block."""
    def step(x0, pres, g_vec, map_xyz, map_mask, stacks_xyz, stacks_mask, rel_q, rel_t, prior):
        block_xyz, block_mask = MH.shard_rows((map_xyz, map_mask), mesh)
        return distributed_window_step_mapsharded(
            x0, pres, g_vec, block_xyz, block_mask, _shard_axis1(stacks_xyz, mesh),
            _shard_axis1(stacks_mask, mesh), rel_q, rel_t, prior, cfg, mesh)
    return step
