"""Quaternion algebra on torch tensors (port of lio_mapping_tpu.utils.quaternion).

Conventions as in the reference: ``(..., 4)`` tensors in **[w, x, y, z]**
order, Hamilton product, ``rotate(q, v) == R(q) @ v``. Every function
broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "identity", "normalize", "qmul", "conjugate", "inverse", "rotate",
    "to_matrix", "from_matrix", "delta_q", "from_axis_angle", "to_axis_angle",
    "exp", "log", "slerp", "left_matrix", "right_matrix", "angular_distance",
    "rot_to_ypr", "ypr_to_rot", "skew",
]


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (Eigen's ``a * b``)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse assuming (near-)unit quaternion."""
    return conjugate(normalize(q))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by unit quaternion(s) ``q``: R(q) @ v."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w,x,y,z] (branchless, Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, 0.0)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4.0 * qw0 + 1e-30), (m02 - m20) / (4.0 * qw0 + 1e-30),
         (m10 - m01) / (4.0 * qw0 + 1e-30)], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack(
        [(m21 - m12) / (4.0 * qx1 + 1e-30), qx1, (m01 + m10) / (4.0 * qx1 + 1e-30),
         (m02 + m20) / (4.0 * qx1 + 1e-30)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack(
        [(m02 - m20) / (4.0 * qy2 + 1e-30), (m01 + m10) / (4.0 * qy2 + 1e-30), qy2,
         (m12 + m21) / (4.0 * qy2 + 1e-30)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack(
        [(m10 - m01) / (4.0 * qz3 + 1e-30), (m02 + m20) / (4.0 * qz3 + 1e-30),
         (m12 + m21) / (4.0 * qz3 + 1e-30), qz3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    case = torch.argmax(pivots, dim=-1)  # first maximum, as jnp.argmax
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(qs, -2, idx)[..., 0, :]
    return normalize(q)


def delta_q(theta: torch.Tensor) -> torch.Tensor:
    """Small-angle quaternion [1, theta/2] (NOT normalized), reference DeltaQ."""
    one = torch.ones(theta.shape[:-1] + (1,), dtype=theta.dtype, device=theta.device)
    return torch.cat([one, 0.5 * theta], dim=-1)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def to_axis_angle(q: torch.Tensor):
    qn = normalize(q)
    qn = torch.where(qn[..., 0:1] < 0, -qn, qn)
    sin_half = torch.linalg.norm(qn[..., 1:4], dim=-1)
    angle = 2.0 * torch.atan2(sin_half, qn[..., 0])
    axis = qn[..., 1:4] / torch.clamp_min(sin_half, 1e-12)[..., None]
    return axis, angle


def exp(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential: rotation vector -> unit quaternion."""
    sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (inverse of exp)."""
    axis, angle = to_axis_angle(q)
    return axis * angle[..., None]


def slerp(q0: torch.Tensor, q1: torch.Tensor, s) -> torch.Tensor:
    """Eigen-equivalent slerp between unit quaternions, elementwise in s."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1_adj = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    s = torch.as_tensor(s, dtype=q0.dtype, device=q0.device)
    if s.ndim == q0.ndim - 1:
        s = s[..., None]
    use_lerp = sin_theta < 1e-5
    den = torch.clamp_min(sin_theta, 1e-30)
    w0 = torch.where(use_lerp, 1.0 - s, torch.sin((1.0 - s) * theta) / den)
    w1 = torch.where(use_lerp, s, torch.sin(s * theta) / den)
    return normalize(w0 * q0 + w1 * q1_adj)


def _quat_matrix(q: torch.Tensor, sign: float) -> torch.Tensor:
    w = q[..., 0]
    v = q[..., 1:4]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    top_left = w[..., None, None] * eye + sign * skew(v)
    top = torch.cat([top_left, v[..., :, None]], dim=-1)
    bottom = torch.cat([-v[..., None, :], w[..., None, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def left_matrix(q: torch.Tensor) -> torch.Tensor:
    """4x4 L(q) with q*p == L(q) @ coeffs(p), coeffs in Eigen order [x,y,z,w]
    (reference LeftQuatMatrix, math_utils.h:140-149)."""
    return _quat_matrix(q, 1.0)


def right_matrix(p: torch.Tensor) -> torch.Tensor:
    """4x4 R(p) with q*p == R(p) @ coeffs(q); coeffs order [x,y,z,w]."""
    return _quat_matrix(p, -1.0)


def angular_distance(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Angle (rad) of q0^-1 * q1, Eigen angularDistance equivalent."""
    d = qmul(conjugate(normalize(q0)), normalize(q1))
    return 2.0 * torch.atan2(torch.linalg.norm(d[..., 1:4], dim=-1), torch.abs(d[..., 0]))


def skew(v: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric matrix [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def rot_to_ypr(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> yaw/pitch/roll in DEGREES (reference R2ypr)."""
    n = m[..., :, 0]
    o = m[..., :, 1]
    a = m[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def ypr_to_rot(ypr_deg: torch.Tensor) -> torch.Tensor:
    """yaw/pitch/roll in DEGREES -> rotation matrix Rz(y)Ry(p)Rx(r)."""
    ypr = ypr_deg * (math.pi / 180.0)
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    m = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return m.reshape(ypr.shape[:-1] + (3, 3))
