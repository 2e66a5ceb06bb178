"""Fixed-shape point-cloud containers (port of lio_mapping_tpu.ops.cloud).

Clouds are padded tensors with explicit validity masks; ring and relative
time ride as separate channels, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Cloud(NamedTuple):
    """A flat padded point cloud.

    xyz: (N, 3) float; rel_time: (N,) float; ring: (N,) int32; mask: (N,) bool.
    """

    xyz: torch.Tensor
    rel_time: torch.Tensor
    ring: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32), dim=-1)

    @staticmethod
    def empty(capacity: int, dtype=torch.float32, device=None) -> "Cloud":
        return Cloud(
            xyz=torch.zeros((capacity, 3), dtype=dtype, device=device),
            rel_time=torch.zeros((capacity,), dtype=dtype, device=device),
            ring=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_xyz(xyz: torch.Tensor, rel_time=None, ring=None, mask=None) -> "Cloud":
        """A cloud of ``xyz`` (..., N, 3): rel_time 0, ring -1 and every
        point valid unless given."""
        lead = xyz.shape[:-1]
        if rel_time is None:
            rel_time = torch.zeros(lead, dtype=xyz.dtype, device=xyz.device)
        if ring is None:
            ring = torch.full(lead, -1, dtype=torch.int32, device=xyz.device)
        if mask is None:
            mask = torch.ones(lead, dtype=torch.bool, device=xyz.device)
        return Cloud(xyz, rel_time, ring, mask)

    def transform(self, pose) -> "Cloud":
        return self._replace(xyz=pose.apply(self.xyz))


class RingCloud(NamedTuple):
    """A sweep organized as per-ring rows, points compacted to the front.

    xyz: (R, P, 3); rel_time: (R, P); mask: (R, P); count: (R,) int32.
    """

    xyz: torch.Tensor
    rel_time: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor

    @property
    def n_rings(self) -> int:
        return self.xyz.shape[-3]

    @property
    def points_per_ring(self) -> int:
        return self.xyz.shape[-2]


def concat_clouds(a: Cloud, b: Cloud) -> Cloud:
    return Cloud(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def scatter_rows(n_out: int, slot: torch.Tensor, values: torch.Tensor, fill) -> torch.Tensor:
    """``out[slot] = values`` into ``n_out`` rows plus one dump row that
    absorbs every ``slot == n_out`` (the reference's ``mode="drop"``
    scatter); returns the first ``n_out`` rows. Slots below ``n_out`` must
    be unique."""
    out = torch.full((n_out + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[slot] = values
    return out[:n_out]


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int64 (n,) counts of each value of ``ids`` (int64, all in [0, n)): the
    result of ``torch.bincount(ids, minlength=n)``, without its reads of the
    largest and smallest id (two host syncs on a CUDA tensor). Integer
    sums, so the result is exact in any order."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def crop_box_filter(xyz: torch.Tensor, mask: torch.Tensor, box_min, box_max, rotation=None,
                    negative: bool = True) -> torch.Tensor:
    """Axis-aligned crop-box self-filter; returns the updated mask
    (input_filters_node.cc:54-62). The rotation into the filtering frame
    applies to the containment test only; ``negative`` removes the points
    inside the box."""
    p = xyz if rotation is None else xyz @ torch.as_tensor(rotation, dtype=xyz.dtype,
                                                           device=xyz.device).T
    lo = torch.as_tensor(box_min, dtype=xyz.dtype, device=xyz.device)
    hi = torch.as_tensor(box_max, dtype=xyz.dtype, device=xyz.device)
    inside = torch.all((p >= lo) & (p <= hi), dim=-1)
    return mask & (~inside if negative else inside)


# KAIST Urban rig: rotation to the gravity-aligned filtering frame and the
# vehicle-body crop box (input_filters_node.cc:55-56,84-88).
KAIST_SELF_FILTER_ROTATION = (
    (-4.91913910e-01, 7.13989130e-01, -4.98237120e-01),
    (-5.01145813e-01, -7.00156621e-01, -5.08560301e-01),
    (-7.11950546e-01, -4.78439170e-04, 7.02229444e-01),
)
KAIST_SELF_FILTER_BOX = ((-10.0, -5.0, -1.7), (5.0, 7.0, 0.6))


def compact_cloud(c: Cloud, capacity: int) -> Cloud:
    """Pack valid points to the front and truncate/pad to ``capacity``
    (stable order: prefix-sum slot assignment)."""
    slot = torch.cumsum(c.mask.to(torch.int64), dim=0) - 1
    slot = torch.where(c.mask, slot, capacity)
    slot = torch.clamp(slot, max=capacity)
    return Cloud(
        scatter_rows(capacity, slot, c.xyz, 0.0),
        scatter_rows(capacity, slot, c.rel_time, 0.0),
        scatter_rows(capacity, slot, c.ring, -1),
        scatter_rows(capacity, slot, c.mask, False),
    )
