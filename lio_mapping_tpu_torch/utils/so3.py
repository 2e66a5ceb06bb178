"""SO(3) maps and Jacobians (port of lio_mapping_tpu.utils.so3)."""

from __future__ import annotations

import torch

from .quaternion import skew

__all__ = ["exp_matrix", "log_matrix", "right_jacobian", "right_jacobian_inverse", "left_jacobian"]


def _eye(phi: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=phi.dtype, device=phi.device)


def exp_matrix(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector -> rotation matrix."""
    angle = torch.linalg.norm(phi, dim=-1)
    small = angle < 1e-8
    a = torch.where(small, 1.0 - angle**2 / 6.0, torch.sin(angle) / torch.clamp_min(angle, 1e-30))
    b = torch.where(small, 0.5 - angle**2 / 24.0,
                    (1.0 - torch.cos(angle)) / torch.clamp_min(angle**2, 1e-30))
    k = skew(phi)
    return _eye(phi) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def log_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector (principal branch)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cos_a = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    angle = torch.arccos(cos_a)
    w = torch.stack(
        [m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]],
        dim=-1,
    )
    sin_a = torch.sin(angle)
    scale = torch.where(angle < 1e-7, 0.5 + angle**2 / 12.0,
                        angle / torch.clamp_min(2.0 * sin_a, 1e-30))
    return scale[..., None] * w


def right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_r(phi) = I - (1-cos)/a^2 [phi]x + (a - sin a)/a^3 [phi]x^2."""
    angle = torch.linalg.norm(phi, dim=-1)
    small = angle < 1e-8
    a2 = torch.clamp_min(angle**2, 1e-30)
    a3 = torch.clamp_min(angle**3, 1e-30)
    c1 = torch.where(small, 0.5 - angle**2 / 24.0, (1.0 - torch.cos(angle)) / a2)
    c2 = torch.where(small, 1.0 / 6.0 - angle**2 / 120.0, (angle - torch.sin(angle)) / a3)
    k = skew(phi)
    return _eye(phi) - c1[..., None, None] * k + c2[..., None, None] * (k @ k)


def right_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """J_r(phi)^-1 = I + 1/2 [phi]x + (1/a^2 - (1+cos)/(2 a sin)) [phi]x^2."""
    angle = torch.linalg.norm(phi, dim=-1)
    small = angle < 1e-8
    a2 = torch.clamp_min(angle**2, 1e-30)
    coef = torch.where(
        small,
        1.0 / 12.0 + angle**2 / 720.0,
        1.0 / a2 - (1.0 + torch.cos(angle))
        / torch.clamp_min(2.0 * angle * torch.sin(angle), 1e-30),
    )
    k = skew(phi)
    return _eye(phi) + 0.5 * k + coef[..., None, None] * (k @ k)


def left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_l(phi) = J_r(-phi)."""
    return right_jacobian(-phi)
