"""Voxel-grid downsampling (port of lio_mapping_tpu.ops.voxel).

Exact sort-based unique + centroid reduction replacing ``pcl::VoxelGrid``:
quantize to integer cells, pack into one int32 key (10 bits per axis,
origin-centred), stable-sort, segment-mean. Keys and their sort order match
the reference bit for bit; downstream KNN indices and tie-breaks depend on
the order of the centroids.

The segment sums are a deterministic segmented reduction over the sorted
run (``torch.segment_reduce``), not a scatter-add: on CUDA a scatter-add
uses atomics and changes the last ulp of a centroid from run to run.
"""

from __future__ import annotations

import torch

_BITS = 10
_HALF = 1 << (_BITS - 1)  # 512
_SPAN = 1 << _BITS
_INT32_MAX = torch.iinfo(torch.int32).max


def voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, leaf: float) -> torch.Tensor:
    """Packed int32 voxel key per point; invalid/out-of-range -> INT32 max."""
    # clamp before the cast: a float beyond int32 has no defined conversion
    cells = torch.clamp(torch.floor(xyz / leaf), -(1 << 20), 1 << 20)
    v = cells.to(torch.int32) + _HALF
    in_range = torch.all((v >= 0) & (v < _SPAN), dim=-1)
    key = (v[..., 0] * _SPAN + v[..., 1]) * _SPAN + v[..., 2]
    return torch.where(mask & in_range, key, _INT32_MAX)


def segment_sum_sorted(values: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Sums of ``values`` rows over ``n_seg`` segments given a NONDECREASING
    segment id per row (ids >= n_seg are dropped). Deterministic: one
    segmented reduction over contiguous runs, no atomics."""
    seg = torch.clamp(seg, max=n_seg)
    lengths = torch.bincount(seg, minlength=n_seg + 1)
    out = torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)
    return out[:n_seg]


def voxel_downsample_rows(xyz: torch.Tensor, mask: torch.Tensor, leaf: float,
                          capacity: int, aux: torch.Tensor | None = None):
    """Row-batched :func:`voxel_downsample`: each of the B rows of
    ``xyz`` (B, N, 3) / ``mask`` (B, N) is downsampled on its own, as the
    reference's ``vmap`` over rings does. Returns ((B,C,3), (B,C),
    (B,C,...) or None)."""
    b, n = mask.shape
    key = voxel_keys(xyz, mask, leaf)
    order = torch.argsort(key, dim=1, stable=True)
    key_s = torch.gather(key, 1, order)
    xyz_s = torch.gather(xyz, 1, order[..., None].expand(b, n, 3))
    valid_s = key_s != _INT32_MAX
    first = torch.ones_like(valid_s)
    first[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    first = first & valid_s
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    seg = torch.clamp(torch.where(valid_s, seg, capacity), max=capacity)
    # one id space over all rows: row r owns ids [r (C+1), r (C+1) + C]
    gid = (seg + (capacity + 1) * torch.arange(b, device=seg.device)[:, None]).reshape(-1)
    n_all = b * (capacity + 1)

    def seg_sum(v):
        s = segment_sum_sorted(v.reshape((b * n,) + tuple(v.shape[2:])), gid, n_all)
        return s.reshape((b, capacity + 1) + tuple(v.shape[2:]))[:, :capacity]

    cnts = seg_sum(valid_s.to(xyz.dtype))
    sums = seg_sum(xyz_s)
    out_mask = cnts > 0
    denom = torch.clamp_min(cnts, 1.0)
    out_xyz = sums / denom[..., None]

    out_aux = None
    if aux is not None:
        extra = (1,) * (aux.ndim - 2)
        aux_s = torch.gather(aux, 1, order.reshape((b, n) + extra).expand(aux.shape))
        keep = valid_s.reshape((b, n) + extra)
        aux_sums = seg_sum(torch.where(keep, aux_s, torch.zeros_like(aux_s)))
        out_aux = aux_sums / denom.reshape((b, capacity) + extra)
    return out_xyz, out_mask, out_aux


def voxel_downsample(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    capacity: int,
    aux: torch.Tensor | None = None,
    wide: bool = False,
):
    """Centroid-downsample (N,3) points to <=capacity voxel centroids.

    Returns (out_xyz (C,3), out_mask (C,), out_aux (C,...) or None), the
    centroids in ascending key order (a stable sort, as the reference)."""
    if wide:
        raise NotImplementedError("wide (13-bit two-key) voxel packing is not ported yet")
    ox, om, oa = voxel_downsample_rows(xyz[None], mask[None], leaf, capacity,
                                       None if aux is None else aux[None])
    return ox[0], om[0], None if oa is None else oa[0]

