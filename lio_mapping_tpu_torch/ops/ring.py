"""Sweep -> ring-organized cloud (port of lio_mapping_tpu.ops.ring).

Reference behaviour (PointProcessor::PointToRing): elevation -> ring by
``floor((deg - lower) * factor + 0.5)``, azimuth ``2*pi - atan2(y, x)``,
start azimuth from the first valid point, per-point relative time from the
azimuth offset. The per-ring ``push_back`` is a stable sort by ring plus a
prefix-sum scatter into a padded (R, P) grid.
"""

from __future__ import annotations

import math

import torch

from .cloud import RingCloud, scatter_rows


def project_to_rings(
    xyz: torch.Tensor,
    in_mask: torch.Tensor,
    *,
    n_rings: int,
    lower_bound_deg: float,
    upper_bound_deg: float,
    max_points_per_ring: int,
    scan_period: float,
    start_ori_override=None,
    ring_ids=None,
):
    """Bin a raw sweep (N,3) into per-ring rows with relative times.

    Returns ``(RingCloud, start_ori)``; ``start_ori_override`` replaces the
    observed first-point azimuth, ``ring_ids`` replaces elevation binning
    (the reference's ``uneven`` mode)."""
    n = xyz.shape[0]
    dtype = xyz.dtype
    two_pi = 2.0 * math.pi

    finite = torch.all(torch.isfinite(xyz), dim=-1)
    valid = in_mask & finite
    xyz = torch.where(valid[:, None], xyz, torch.zeros((), dtype=dtype, device=xyz.device))

    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if ring_ids is not None:
        ring = ring_ids.to(torch.int32)
    else:
        dis = torch.sqrt(x * x + y * y)
        ele_deg = torch.atan2(z, dis) * (180.0 / math.pi)
        factor = (n_rings - 1) / (upper_bound_deg - lower_bound_deg)
        ring = torch.floor((ele_deg - lower_bound_deg) * factor + 0.5).to(torch.int32)
    valid = valid & (ring >= 0) & (ring < n_rings)

    azi = two_pi - torch.atan2(y, x)
    azi = torch.where(azi >= two_pi, azi - two_pi, azi)

    first_idx = torch.argmax(valid.to(torch.int8))  # first True (0 if none)
    start_ori = azi[first_idx]
    if start_ori_override is not None:
        start_ori = torch.as_tensor(start_ori_override, dtype=dtype, device=xyz.device)

    azi_rel = azi - start_ori
    azi_rel = torch.where(azi_rel < 0, azi_rel + two_pi, azi_rel)
    rel_time = (scan_period / two_pi) * azi_rel

    # stable grouping by ring, preserving scan order within a ring
    ring_key = torch.where(valid, ring, n_rings).to(torch.int64)
    order = torch.argsort(ring_key, stable=True)
    ring_sorted = ring_key[order]

    counts = torch.bincount(ring_key, minlength=n_rings + 1)[:n_rings]
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(n, device=xyz.device)
    pos = rank - starts[torch.clamp(ring_sorted, 0, n_rings - 1)]

    dest_valid = (ring_sorted < n_rings) & (pos < max_points_per_ring)
    r_cap = n_rings * max_points_per_ring
    flat_dest = torch.where(dest_valid, ring_sorted * max_points_per_ring + pos, r_cap)

    out_xyz = scatter_rows(r_cap, flat_dest, xyz[order], 0.0)
    out_rt = scatter_rows(r_cap, flat_dest, rel_time[order], 0.0)
    out_mask = scatter_rows(r_cap, flat_dest, dest_valid, False)
    rc = RingCloud(
        out_xyz.reshape(n_rings, max_points_per_ring, 3),
        out_rt.reshape(n_rings, max_points_per_ring),
        out_mask.reshape(n_rings, max_points_per_ring),
        torch.clamp(counts, max=max_points_per_ring).to(torch.int32),
    )
    return rc, start_ori
