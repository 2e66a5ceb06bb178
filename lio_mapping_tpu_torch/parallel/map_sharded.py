"""Map-sharded distributed KNN: each rank owns a block of the map (port of
lio_mapping_tpu.parallel.map_sharded).

The queries are sharded over the ranks, and the map is cut into D equal
blocks, block r on rank r. A D-step ring: at step t rank r holds block
(r - t) mod D; it searches that block with ``ops.knn.knn`` (the CUDA kernel
on the card, unless ``force_tiled``), merges the block's top-k into its
running best, and passes the block on to rank r+1 (``multihost.ring_shift``).
The reference's last rotation only hands the blocks back to their owners;
here the ring stops after D - 1 shifts. The running best carries the
neighbour coordinates beside (distance, global index), so the plane and
line fits after it need no gather of the global map.

Exactness: every block's candidates enter the merge that the single-device
tiled search uses (ascending distance; equal distances keep the running
best first), so the distances equal ``ops.knn.knn`` on the concatenated
map, and the indices differ only among equal distances.
"""

from __future__ import annotations

import torch

from ..ops import knn as KNN
from . import multihost as MH


def ring_knn(queries: torch.Tensor, q_mask: torch.Tensor, db_block: torch.Tensor,
             db_mask: torch.Tensor, k: int = 5, axis: MH.Mesh = None,
             prune_beyond: float | None = None, force_tiled: bool = False):
    """Exact k-NN of this rank's queries (Qd, 3) against the GLOBAL map, of
    which this rank holds the block ``db_block`` (Md, 3); every rank's block
    has Md rows. Returns (sq_dists (Qd, k) ascending, global_idx (Qd, k)
    int32, neighbors (Qd, k, 3)); global indices address the blocks
    concatenated in rank order. ``force_tiled`` keeps every step's search on
    the plain version (the corner search's pin)."""
    mesh = axis
    q_n, m_d = queries.shape[0], db_block.shape[0]
    dtype, dev = queries.dtype, queries.device
    best_d = torch.full((q_n, k), KNN.BIG, dtype=dtype, device=dev)
    best_i = torch.zeros((q_n, k), dtype=torch.int32, device=dev)
    best_x = torch.zeros((q_n, k, 3), dtype=dtype, device=dev)
    # one message per shift: the block's points and mask side by side
    blk = torch.cat([db_block, db_mask[:, None].to(dtype)], dim=1)
    for t in range(mesh.size):
        if t > 0:
            blk = MH.ring_shift(blk, mesh)
        owner = (mesh.rank - t) % mesh.size
        blk_xyz, blk_mask = blk[:, :3].contiguous(), blk[:, 3] > 0.5
        d, i_local = KNN.knn(queries, q_mask, blk_xyz, blk_mask, k=k,
                             prune_beyond=prune_beyond, force_tiled=force_tiled)
        i_local = i_local.to(torch.int64)
        cat_d = torch.cat([best_d, d], dim=1)                         # (Q, 2k)
        cat_i = torch.cat([best_i, (i_local + owner * m_d).to(torch.int32)], dim=1)
        best_d, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d, pos = best_d[:, :k], pos[:, :k]
        best_i = torch.gather(cat_i, 1, pos)
        cat_x = torch.cat([best_x, blk_xyz[i_local]], dim=1)          # (Q, 2k, 3)
        best_x = torch.gather(cat_x, 1, pos[..., None].expand(-1, -1, 3))
    return best_d, best_i, best_x
