"""Batched geometric fits (port of lio_mapping_tpu.ops.fits).

5-NN plane fits ``A x = -1`` via modified Gram-Schmidt QR with the 0.2 m
planarity check (PointMapping.cc:514-606 / Estimator.cc:1014-1056), and the
corner line fit (centroid + closed-form covariance eigendecomposition,
accept when lambda_max > 3 lambda_mid, PointMapping.cc:381-510), and
``eig3x3_descending``, the reference's general 3x3 eigendecomposition.
"""

from __future__ import annotations

import math

import torch

from ..utils.quaternion import cross


def solve3x3(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 solve (adjugate) with one refinement step."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))

    def apply_adjugate(r0, r1, r2):
        y0 = (c00 * r0 + c10 * r1 + c20 * r2) * inv_det
        y1 = (c01 * r0 + c11 * r1 + c21 * r2) * inv_det
        y2 = (c02 * r0 + c12 * r1 + c22 * r2) * inv_det
        return torch.stack([y0, y1, y2], dim=-1)

    x = apply_adjugate(b[..., 0], b[..., 1], b[..., 2])
    r = b - torch.einsum("...ij,...j->...i", m, x)
    return x + apply_adjugate(r[..., 0], r[..., 1], r[..., 2])


def sym_eig3x3(m: torch.Tensor):
    """Batched closed-form symmetric 3x3 eigendecomposition: eigenvalues
    ascending (trigonometric method), eigenvectors (columns) from the
    largest cross product of rows of (A - lambda I)."""
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    q = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]) / 3.0
    a_q = m - q[..., None, None] * eye
    p2 = torch.sum(a_q * a_q, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    detb = (
        a_q[..., 0, 0] * (a_q[..., 1, 1] * a_q[..., 2, 2] - a_q[..., 1, 2] * a_q[..., 2, 1])
        - a_q[..., 0, 1] * (a_q[..., 1, 0] * a_q[..., 2, 2] - a_q[..., 1, 2] * a_q[..., 2, 0])
        + a_q[..., 0, 2] * (a_q[..., 1, 0] * a_q[..., 2, 1] - a_q[..., 1, 1] * a_q[..., 2, 0])
    )
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = 3.0 * q - l0 - l2
    vals = torch.stack([l0, l1, l2], dim=-1)

    def eigvec(lam):
        am = m - lam[..., None, None] * eye
        c = torch.stack([cross(am[..., 0, :], am[..., 1, :]),
                         cross(am[..., 0, :], am[..., 2, :]),
                         cross(am[..., 1, :], am[..., 2, :])], dim=-2)
        best = torch.argmax(torch.sum(c * c, dim=-1), dim=-1)
        v = torch.gather(c, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
        return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-30)

    vecs = torch.stack([eigvec(l0), eigvec(l1), eigvec(l2)], dim=-1)
    return vals, vecs


def _sum_k(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, ``x[..., 0] + x[..., 1] + ...``
    (XLA's order for these short sums; torch's vectorised sum pairs them)."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def lstsq_k3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched least squares of (..., K, 3) @ x = (..., K) by modified
    Gram-Schmidt QR + 3x3 back substitution; the K-term sums in index
    order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    eps = 1e-30
    r00 = torch.sqrt(torch.clamp_min(_sum_k(a0 * a0), eps))
    q0 = a0 / r00[..., None]
    r01 = _sum_k(q0 * a1)
    v1 = a1 - r01[..., None] * q0
    r11 = torch.sqrt(torch.clamp_min(_sum_k(v1 * v1), eps))
    q1 = v1 / r11[..., None]
    r02 = _sum_k(q0 * a2)
    r12 = _sum_k(q1 * a2)
    v2 = a2 - r02[..., None] * q0 - r12[..., None] * q1
    r22 = torch.sqrt(torch.clamp_min(_sum_k(v2 * v2), eps))
    q2 = v2 / r22[..., None]
    c0 = _sum_k(q0 * b)
    c1 = _sum_k(q1 * b)
    c2 = _sum_k(q2 * b)
    x2 = c2 / r22
    x1 = (c1 - r12 * x2) / r11
    x0 = (c0 - r01 * x1 - r02 * x2) / r00
    return torch.stack([x0, x1, x2], dim=-1)


def plane_fit(neighbors: torch.Tensor, valid: torch.Tensor, min_plane_dis: float):
    """Fit plane w.p + d = 0, |w| = 1 through K neighbours (..., K, 3).
    Returns (w (...,3), d (...,), ok (...,)); every sum in index order."""
    ones = torch.ones(neighbors.shape[:-1], dtype=neighbors.dtype, device=neighbors.device)
    x = lstsq_k3(neighbors, -ones)
    norm = torch.sqrt(_sum_k(x * x))[..., None]
    w = x / torch.clamp_min(norm, 1e-12)
    d = 1.0 / torch.clamp_min(norm[..., 0], 1e-12)
    dist = torch.abs(_sum_k(neighbors * w[..., None, :]) + d[..., None])
    planar = torch.all(dist <= min_plane_dis, dim=-1)
    ok = valid & planar & torch.isfinite(d) & (norm[..., 0] > 1e-8)
    return w, d, ok


def eig3x3_descending(m: torch.Tensor):
    """Symmetric 3x3 eigendecomposition by ``torch.linalg.eigh``:
    eigenvalues ascending, as the reference's (its name notwithstanding)."""
    return torch.linalg.eigh(m)


def line_fit(neighbors: torch.Tensor, valid: torch.Tensor):
    """Edge line through K neighbours: (centroid, unit direction, ok) with
    ok when lambda_max > 3 lambda_mid (PointMapping.cc:423)."""
    k = neighbors.shape[-2]
    c = torch.mean(neighbors, dim=-2)
    dev = neighbors - c[..., None, :]
    cov = torch.einsum("...ki,...kj->...ij", dev, dev) / k
    vals, vecs = sym_eig3x3(cov)
    return c, vecs[..., :, 2], valid & (vals[..., 2] > 3.0 * vals[..., 1])


def point_to_line_residual(p, centroid, direction):
    """Distance + unit direction toward the line (PointMapping.cc:425-473)."""
    x1 = centroid + 0.1 * direction
    x2 = centroid - 0.1 * direction
    a_vec = cross(p - x1, p - x2)
    l12 = torch.linalg.norm(x1 - x2, dim=-1)
    ld2 = torch.linalg.norm(a_vec, dim=-1) / torch.clamp_min(l12, 1e-12)
    n = cross(x1 - x2, a_vec)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    return ld2, n
