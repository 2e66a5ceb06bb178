"""Rigid-body poses on torch tensors (port of lio_mapping_tpu.utils.se3).

``Pose`` mirrors the reference's ``Twist<T>``: a unit quaternion + translation
acting on points as ``x' = R(q) x + t``; ``a @ b`` composes, ``inverse``
inverts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import quaternion as quat


class Pose(NamedTuple):
    """Batched rigid transform: q is (...,4) [w,x,y,z], t is (...,3)."""

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        q = quat.identity(dtype, device).expand(tuple(batch_shape) + (4,)).clone()
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return Pose(q, t)

    @staticmethod
    def from_matrix(m: torch.Tensor) -> "Pose":
        return Pose(quat.from_matrix(m[..., :3, :3]), m[..., :3, 3])

    def compose(self, other: "Pose") -> "Pose":
        """self * other (apply ``other`` first, then ``self``)."""
        return Pose(quat.qmul(self.q, other.q), quat.rotate(self.q, other.t) + self.t)

    def __matmul__(self, other: "Pose") -> "Pose":
        return self.compose(other)

    def inverse(self) -> "Pose":
        qinv = quat.conjugate(quat.normalize(self.q))
        return Pose(qinv, -quat.rotate(qinv, self.t))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform (...,3) points: R(q) p + t (broadcasts over points)."""
        return quat.rotate(self.q[..., None, :], points) + self.t[..., None, :]

    def apply_one(self, point: torch.Tensor) -> torch.Tensor:
        return quat.rotate(self.q, point) + self.t

    def rotation_matrix(self) -> torch.Tensor:
        return quat.to_matrix(self.q)

    def matrix(self) -> torch.Tensor:
        r = quat.to_matrix(self.q)
        top = torch.cat([r, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype, device=self.t.device)
        bottom = bottom.expand(self.t.shape[:-1] + (4,))[..., None, :]
        return torch.cat([top, bottom], dim=-2)

    def normalized(self) -> "Pose":
        return Pose(quat.normalize(self.q), self.t)

    def astype(self, dtype) -> "Pose":
        return Pose(self.q.to(dtype), self.t.to(dtype))


def pose_distance(a: Pose, b: Pose):
    """(rotation angle rad, translation norm) between two poses."""
    return quat.angular_distance(a.q, b.q), torch.linalg.norm(a.t - b.t, dim=-1)
