"""LOAM curvature feature extraction (port of lio_mapping_tpu.ops.features).

Reference behaviour (PointProcessor.cc:542-783) with fixed shapes, all rings
and all subregions at once: occlusion masking, +-5-neighbour curvature,
8 subregions per ring, <=2 sharp + <=20 less-sharp corners and <=4 flat
points per subregion with +-5-point non-max suppression, and a per-ring
0.2 m voxel filter of the less-flat points with rel_time recomputed from
the centroid azimuth.

The greedy pick loops are Python loops over the (static) pick budget:
24 rounds, each a handful of (R, NS, P) tensor ops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import FeatureConfig, SensorConfig
from .cloud import Cloud, RingCloud, compact_cloud
from .voxel import voxel_downsample_rows


class SweepFeatures(NamedTuple):
    corner_sharp: Cloud
    corner_less_sharp: Cloud
    surf_flat: Cloud
    surf_less_flat: Cloud


# Labels match the reference PointLabel enum (PointProcessor.h:97-102)
_CORNER_SHARP = 2
_CORNER_LESS_SHARP = 1
_SURFACE_LESS_FLAT = 0
_SURFACE_FLAT = -1


def _shift(a: torch.Tensor, k: int, fill=0.0) -> torch.Tensor:
    """a[:, i] -> a[:, i+k] along axis 1 with ``fill`` outside."""
    if k == 0:
        return a
    pad = torch.full((a.shape[0], abs(k)) + tuple(a.shape[2:]), fill,
                     dtype=a.dtype, device=a.device)
    if k > 0:
        return torch.cat([a[:, k:], pad], dim=1)
    return torch.cat([pad, a[:, : a.shape[1] - abs(k)]], dim=1)


def _occlusion_mask(xyz: torch.Tensor, count: torch.Tensor, ncr: int) -> torch.Tensor:
    """PrepareRing (PointProcessor.cc:542-585) -> picked-mask (R, P)."""
    p = xyz.shape[1]
    idx = torch.arange(p, device=xyz.device)[None, :]
    depth = torch.linalg.norm(xyz, dim=-1)
    sq = torch.sum(xyz * xyz, dim=-1)

    nxt = _shift(xyz, 1)
    prv = _shift(xyz, -1)
    diff_next2 = torch.sum((nxt - xyz) ** 2, dim=-1)
    diff_prev2 = torch.sum((xyz - prv) ** 2, dim=-1)
    depth_next = _shift(depth, 1)

    in_domain = (idx >= ncr) & (idx < count[:, None] - ncr)

    ratio_near = depth_next / torch.clamp_min(depth, 1e-12)
    wd_near = torch.linalg.norm(nxt - xyz * ratio_near[..., None], dim=-1) \
        / torch.clamp_min(depth_next, 1e-12)
    ratio_far = depth / torch.clamp_min(depth_next, 1e-12)
    wd_far = torch.linalg.norm(xyz - nxt * ratio_far[..., None], dim=-1) \
        / torch.clamp_min(depth, 1e-12)

    jump = diff_next2 > 0.1
    event_near = in_domain & jump & (depth > depth_next) & (wd_near < 0.1)  # mask [i-ncr, i]
    event_far = in_domain & jump & (depth <= depth_next) & (wd_far < 0.1)   # mask [i+1, i+ncr+1]

    mask = torch.zeros_like(in_domain)
    for k in range(0, ncr + 1):
        mask = mask | _shift(event_near, k, fill=False)
    for k in range(1, ncr + 2):
        mask = mask | _shift(event_far, -k, fill=False)

    parallel = (
        in_domain
        & ~(event_near | event_far)
        & (diff_next2 > 0.0002 * sq)
        & (diff_prev2 > 0.0002 * sq)
    )
    return mask | parallel


def _curvature(xyz: torch.Tensor, ncr: int) -> torch.Tensor:
    """|sum_{j=1..ncr}(p[i+j]+p[i-j]) - 2*ncr*p[i]|^2 per ring (R, P)."""
    acc = -2.0 * ncr * xyz
    for j in range(1, ncr + 1):
        acc = acc + _shift(xyz, j) + _shift(xyz, -j)
    return torch.sum(acc * acc, dim=-1)


def _mark(p: int, pos: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(R, P) bool with True at ``pos`` (R, NS) where ``ok``."""
    r = pos.shape[0]
    out = torch.zeros((r, p + 1), dtype=torch.bool, device=pos.device)
    out.scatter_(1, torch.where(ok, pos, p), True)
    return out[:, :p]


def _nms_masks_batched(i: torch.Tensor, ok: torch.Tensor, adj_big: torch.Tensor,
                       ncr: int) -> torch.Tensor:
    """MaskPickedInRing (PointProcessor.cc:624-645) for one pick per
    (ring, subregion): each pick plus its <=ncr-neighbour runs, each run
    stopping at the first >0.05 m^2 gap. Returns the (R, P) union."""
    p = adj_big.shape[1]
    pmax = p - 1

    def at(pos):
        return torch.gather(adj_big, 1, torch.clamp(pos, 0, pmax))

    new = _mark(p, i, ok)
    ok_f = ok
    ok_b = ok
    for k in range(1, ncr + 1):
        ok_f = ok_f & ~at(i + k - 1)
        new = new | _mark(p, torch.clamp(i + k, 0, pmax), ok_f)
        ok_b = ok_b & ~at(i - k)
        new = new | _mark(p, torch.clamp(i - k, 0, pmax), ok_b)
    return new


def _extract_labels(xyz: torch.Tensor, rc_mask: torch.Tensor, count: torch.Tensor,
                    cfg: FeatureConfig):
    """Label assignment for the whole sweep: (labels, in_region), both (R, P).

    All rings and subregions pick concurrently, as in the reference port.
    The subregions of a ring are disjoint index ranges, so one pick round
    writes each point at most once and the label update is a scatter."""
    r, p = rc_mask.shape
    ncr = cfg.num_curvature_regions
    ns = cfg.num_scan_subregions
    dev = xyz.device
    idx = torch.arange(p, device=dev)

    ring_long_enough = count > 2 * ncr + 1

    picked = _occlusion_mask(xyz, count, ncr)
    curv = _curvature(xyz, ncr)
    # gap to the next point; the last entry compares against zero-fill and
    # reads as a big gap, stopping NMS runs at the ring end
    adj = torch.sum((torch.roll(xyz, -1, dims=1) - xyz) ** 2, dim=-1)
    adj[:, -1] = torch.sum(xyz[:, -1] ** 2, dim=-1)
    adj_big = adj > 0.05

    j = torch.arange(ns, device=dev)
    n = count[:, None].to(torch.int64)
    sp = torch.div(ncr * (ns - j) + (n - ncr) * j, ns, rounding_mode="floor")
    ep = torch.div(ncr * (ns - 1 - j) + (n - ncr) * (j + 1), ns, rounding_mode="floor") - 1
    region_ok = (ep > sp) & ring_long_enough[:, None]
    in_region = (
        (idx[None, None, :] >= sp[..., None])
        & (idx[None, None, :] <= ep[..., None])
        & region_ok[..., None]
        & rc_mask[:, None, :]
    )                                                            # (R, NS, P)
    in_any_region = torch.any(in_region, dim=1)

    labels = torch.zeros((r, p + 1), dtype=torch.int32, device=dev)
    curv_b = curv[:, None, :]
    neg_inf = torch.tensor(-math.inf, dtype=curv.dtype, device=dev)
    pos_inf = torch.tensor(math.inf, dtype=curv.dtype, device=dev)

    # corner picks: descending curvature, curv > th
    n_picked = torch.zeros((r, ns), dtype=torch.int32, device=dev)
    corner_ok = (curv > cfg.surf_curv_th)[:, None, :]
    for _ in range(cfg.max_corner_less_sharp):
        cand = in_region & ~picked[:, None, :] & corner_ok
        vmax, i = torch.max(torch.where(cand, curv_b, neg_inf), dim=-1)
        ok = vmax > -math.inf
        new_label = torch.where(n_picked < cfg.max_corner_sharp,
                                _CORNER_SHARP, _CORNER_LESS_SHARP).to(torch.int32)
        labels.scatter_(1, torch.where(ok, i, p), new_label)
        picked = picked | _nms_masks_batched(i, ok, adj_big, ncr)
        n_picked = n_picked + ok.to(torch.int32)

    # flat picks: ascending curvature, curv < th
    flat_ok = (curv < cfg.surf_curv_th)[:, None, :]
    flat_label = torch.full((r, ns), _SURFACE_FLAT, dtype=torch.int32, device=dev)
    for _ in range(cfg.max_surf_flat):
        cand = in_region & ~picked[:, None, :] & flat_ok
        vmin, i = torch.min(torch.where(cand, curv_b, pos_inf), dim=-1)
        ok = vmin < math.inf
        labels.scatter_(1, torch.where(ok, i, p), flat_label)
        picked = picked | _nms_masks_batched(i, ok, adj_big, ncr)

    return labels[:, :p], in_any_region


def extract_features(rc: RingCloud, start_ori: torch.Tensor, cfg: FeatureConfig,
                     sensor: SensorConfig) -> SweepFeatures:
    """Full-sweep feature extraction (ExtractFeaturePoints)."""
    r, p = rc.mask.shape
    dev = rc.xyz.device
    two_pi = 2.0 * math.pi

    labels, in_region = _extract_labels(rc.xyz, rc.mask, rc.count, cfg)

    ring_ids = torch.arange(r, dtype=torch.int32, device=dev)[:, None].expand(r, p)
    flat = Cloud(rc.xyz.reshape(r * p, 3), rc.rel_time.reshape(r * p),
                 ring_ids.reshape(r * p), rc.mask.reshape(r * p))
    labels_f = labels.reshape(r * p)

    def select(cond, cap):
        return compact_cloud(flat._replace(mask=flat.mask & cond), cap)

    corner_sharp = select(labels_f == _CORNER_SHARP, cfg.corner_sharp_cap)
    corner_less_sharp = select(labels_f >= _CORNER_LESS_SHARP, cfg.corner_less_sharp_cap)
    surf_flat = select(labels_f == _SURFACE_FLAT, cfg.surf_flat_cap)

    # less-flat: all non-corner subregion points, voxel filtered per ring
    lf_mask = (labels <= _SURFACE_LESS_FLAT) & in_region & rc.mask
    per_ring_cap = max(256, cfg.surf_less_flat_cap // r)
    ds_xyz, ds_mask, _ = voxel_downsample_rows(rc.xyz, lf_mask, cfg.less_flat_filter_size,
                                               per_ring_cap)
    ds_xyz = ds_xyz.reshape(r * per_ring_cap, 3)
    ds_mask = ds_mask.reshape(r * per_ring_cap)
    ds_ring = torch.arange(r, dtype=torch.int32, device=dev)[:, None].expand(
        r, per_ring_cap).reshape(-1)

    # recompute rel_time from centroid azimuth (PointProcessor.cc:757-778)
    azi = two_pi - torch.atan2(ds_xyz[:, 1], ds_xyz[:, 0])
    azi = torch.where(azi >= two_pi, azi - two_pi, azi)
    azi_rel = azi - start_ori
    azi_rel = torch.where(azi_rel < 0, azi_rel + two_pi, azi_rel)
    ds_rt = (sensor.scan_period / two_pi) * azi_rel

    surf_less_flat = compact_cloud(Cloud(ds_xyz, ds_rt, ds_ring, ds_mask),
                                   cfg.surf_less_flat_cap)
    return SweepFeatures(corner_sharp, corner_less_sharp, surf_flat, surf_less_flat)
