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
