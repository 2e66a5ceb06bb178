"""Exact k-nearest-neighbour search (port of lio_mapping_tpu.ops.knn).

Contract (pinned by tests/test_torch_knn.py, and held by the CUDA kernel):

* squared distances ``|q|^2 + |p|^2 - 2 q.p``, clamped at 0, ascending;
* ties go to the lowest map index;
* rows with fewer than k valid map points get +inf and index 0 in the tail;
* masked queries get +inf distances.

This follows the reference's tiled path (the CPU oracle), which clamps at
0; its Pallas kernel does not clamp.

``knn`` sends a CUDA tensor with ``k <= 8`` (and not ``force_tiled``) to the
hand-written kernel (``ops/knn_kernel.py``); everything else runs the plain
tiled version below, which is also what the kernel is held against.
"""

from __future__ import annotations

import math

import torch

from . import knn_kernel

BIG = math.inf


def _select_k(cat_d: torch.Tensor, cat_i: torch.Tensor, k: int):
    """The k smallest of ``cat_d`` (Q, n), ascending; equal distances keep
    column order (``lax.top_k``'s rule), through a stable sort. Returns
    (dists (Q, k), ids (Q, k)) with ids gathered from ``cat_i``."""
    d, pos = torch.sort(cat_d, dim=1, stable=True)
    return d[:, :k], torch.gather(cat_i, 1, pos[:, :k])


def knn_tiled(queries, q_mask, db, db_mask, k: int = 5, tile: int = 2048):
    """Plain tiled exact kNN: a running top-k merge over ``tile``-row
    blocks of the map (reference knn.py:70-103). Returns (sq_dists (Q, k),
    idx (Q, k) int32)."""
    q = queries.shape[0]
    m = db.shape[0]
    dtype = queries.dtype
    dev = queries.device
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    best_d = torch.full((q, k), BIG, dtype=dtype, device=dev)
    best_i = torch.zeros((q, k), dtype=torch.int32, device=dev)
    for start in range(0, m, tile):
        p_tile = db[start:start + tile]
        m_tile = db_mask[start:start + tile]
        p_sq = torch.sum(p_tile * p_tile, dim=-1)
        cross = queries @ p_tile.T
        d = q_sq + p_sq[None, :] - 2.0 * cross
        d = torch.where(m_tile[None, :], torch.clamp_min(d, 0.0), BIG)
        idx = torch.arange(start, start + p_tile.shape[0], dtype=torch.int32, device=dev)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, idx[None, :].expand(q, -1)], dim=1)
        best_d, best_i = _select_k(cat_d, cat_i, k)
    best_d = torch.where(q_mask[:, None], best_d, BIG)
    return best_d, best_i


def knn(queries, q_mask, db, db_mask, k: int = 5, tile: int = 2048,
        prune_beyond: float = None, force_tiled: bool = False):
    """Exact kNN: for each query, the k nearest valid db points.

    Returns (sq_dists (Q, k) ascending, idx (Q, k) int32).
    ``prune_beyond``: squared-distance match gate enabling the kernel's
    AABB block pruning (exact for every row whose true k-th neighbour lies
    within the gate; beyond-gate rows report a k-th distance beyond it).
    """
    if queries.is_cuda and k <= knn_kernel.MAX_K and not force_tiled:
        return knn_kernel.knn_cuda(queries, q_mask, db, db_mask, k=k,
                                   prune_beyond=prune_beyond)
    return knn_tiled(queries, q_mask, db, db_mask, k=k, tile=tile)


def nearest(queries, q_mask, db, db_mask, tile: int = 2048):
    """1-NN convenience wrapper returning (sq_dist (Q,), idx (Q,))."""
    d, i = knn(queries, q_mask, db, db_mask, k=1, tile=tile)
    return d[:, 0], i[:, 0]


def ring_constrained_nearest(queries, q_ring, q_mask, exclude_idx, db, db_ring, db_mask,
                             mode: str, ring_window: float = 2.5, tile: int = 2048):
    """Nearest db point under a ring constraint relative to ``q_ring``
    (reference knn.py:112-177): mode "same" = same ring excluding
    ``exclude_idx``; mode "other" = a different ring within
    ``ring_window``. Returns (sq_dist (Q,), idx (Q,)); ties go to the
    lowest index. No kernel: this plain version is the port."""
    q = queries.shape[0]
    m = db.shape[0]
    dtype = queries.dtype
    dev = queries.device
    q_sq = torch.sum(queries * queries, dim=-1, keepdim=True)
    best_d = torch.full((q,), BIG, dtype=dtype, device=dev)
    best_i = torch.zeros((q,), dtype=torch.int32, device=dev)
    for start in range(0, m, tile):
        p_tile = db[start:start + tile]
        m_tile = db_mask[start:start + tile]
        r_tile = db_ring[start:start + tile]
        idx = torch.arange(start, start + p_tile.shape[0], dtype=torch.int32, device=dev)
        p_sq = torch.sum(p_tile * p_tile, dim=-1)
        d = q_sq + p_sq[None, :] - 2.0 * (queries @ p_tile.T)
        if mode == "same":
            ring_ok = (r_tile[None, :] == q_ring[:, None]) & (idx[None, :] != exclude_idx[:, None])
        else:
            dr = torch.abs(r_tile[None, :] - q_ring[:, None])
            ring_ok = (r_tile[None, :] != q_ring[:, None]) & (dr.to(dtype) <= ring_window)
        d = torch.where(m_tile[None, :] & ring_ok, torch.clamp_min(d, 0.0), BIG)
        tile_best, arg = torch.min(d, dim=1)
        better = tile_best < best_d
        best_d = torch.where(better, tile_best, best_d)
        best_i = torch.where(better, idx[arg], best_i)
    best_d = torch.where(q_mask, best_d, BIG)
    return best_d, best_i
