"""Schur-complement marginalization (port of lio_mapping_tpu.ops.marginalization;
reference src/factor/MarginalizationFactor.cc).

Layouts (S = opt_window_size): full vector at marginalization time
[pose_0 (6) | sb_0 (9) | keep...], keep vector [pose_1..S | sb_1..S | ex],
n = 15 S + 6. ``PriorState`` stores the factored prior and the
linearization values of the kept blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import quaternion as quat
from . import eigh as EIGH

EPS = 1e-8  # MarginalizationFactor.h:109


class PriorState(NamedTuple):
    """Marginalization prior over [pose_0..S-1 | sb_0..S-1 | ex]."""

    lin_jac: torch.Tensor   # (n, n)
    lin_res: torch.Tensor   # (n,)
    x0_q: torch.Tensor      # (S, 4)
    x0_p: torch.Tensor      # (S, 3)
    x0_sb: torch.Tensor     # (S, 9)
    x0_ex_q: torch.Tensor   # (4,)
    x0_ex_p: torch.Tensor   # (3,)
    valid: torch.Tensor     # () bool

    @staticmethod
    def empty(opt_window_size: int, dtype=torch.float32, device=None) -> "PriorState":
        s = opt_window_size
        n = 15 * s + 6
        z = dict(dtype=dtype, device=device)
        return PriorState(
            lin_jac=torch.zeros((n, n), **z), lin_res=torch.zeros((n,), **z),
            x0_q=quat.identity(dtype, device).repeat(s, 1), x0_p=torch.zeros((s, 3), **z),
            x0_sb=torch.zeros((s, 9), **z), x0_ex_q=quat.identity(dtype, device),
            x0_ex_p=torch.zeros((3,), **z),
            valid=torch.zeros((), dtype=torch.bool, device=device))


def local_diff_pose(p, q, p0, q0):
    """Quaternion-aware local difference (MarginalizationFactor.cc:360-371)."""
    dq = quat.qmul(quat.conjugate(quat.normalize(q0)), quat.normalize(q))
    dtheta = 2.0 * dq[..., 1:4]
    dtheta = torch.where(dq[..., 0:1] < 0, -dtheta, dtheta)
    return torch.cat([p - p0, dtheta], dim=-1)


def prior_dx(prior: PriorState, qs, ps, sbs, ex_q, ex_p) -> torch.Tensor:
    """Stacked local differences of the kept states vs x0."""
    s = prior.x0_q.shape[0]
    d_pose = local_diff_pose(ps, qs, prior.x0_p, prior.x0_q)
    d_sb = sbs - prior.x0_sb
    d_ex = local_diff_pose(ex_p, ex_q, prior.x0_ex_p, prior.x0_ex_q)
    return torch.cat([d_pose.reshape(6 * s), d_sb.reshape(9 * s), d_ex])


def prior_residual(prior: PriorState, qs, ps, sbs, ex_q, ex_p):
    """Replay the factored prior: r = r0 + J dx (MarginalizationFactor.cc:373-374)."""
    dx = prior_dx(prior, qs, ps, sbs, ex_q, ex_p)
    r = prior.lin_res + prior.lin_jac @ dx
    return torch.where(prior.valid, r, torch.zeros_like(r))


def _rel_tol(dtype) -> float:
    """Eigenvalue cut as a fraction of the largest eigenvalue (see the
    reference: an absolute 1e-8 gate passes f32 eigh noise)."""
    return float(torch.finfo(dtype).eps) * 100.0


def _eigh(a: torch.Tensor):
    """``ops/eigh.eigh``: the Householder + QL kernel on the card, on the CPU
    ``torch.linalg.eigh`` (in float64 for a float32 matrix: MKL's float32
    divide-and-conquer refuses some of these Schur complements)."""
    return EIGH.eigh(a)


def equilibrate(a: torch.Tensor):
    """(D^-1 A D^-1 (diag -> 1), d) of the symmetrised A."""
    a = 0.5 * (a + a.T)
    d = torch.sqrt(torch.clamp_min(torch.diagonal(a), 1e-12))
    a_s = a / d[:, None] / d[None, :]
    return 0.5 * (a_s + a_s.T), d


def _equilibrated_eigh(a: torch.Tensor):
    """eigh of D^-1 A D^-1 (diag -> 1). Returns (vals, vecs, d) with
    A = D (V diag(vals) V^T) D."""
    a_s, d = equilibrate(a)
    vals, vecs = _eigh(a_s)
    return vals, vecs, d


def psd_pinv(a: torch.Tensor, eps: float = EPS):
    """Eigenvalue-thresholded pseudo-inverse (MarginalizationFactor.cc:280-282)
    on the equilibrated matrix with a dtype-relative cut."""
    vals, vecs, d = _equilibrated_eigh(a)
    return pinv_from_eigh(vals, vecs, d, eps)


def pinv_from_eigh(vals, vecs, d, eps: float = EPS):
    """:func:`psd_pinv` from the equilibrated matrix's eigendecomposition."""
    cut = torch.clamp_min(torch.max(vals) * _rel_tol(vecs.dtype), eps)
    keep = vals > cut
    inv_vals = torch.where(keep, 1.0 / torch.where(keep, vals, torch.ones_like(vals)),
                           torch.zeros_like(vals))
    pinv_s = (vecs * inv_vals[None, :]) @ vecs.T
    return pinv_s / d[:, None] / d[None, :]


def schur_marginalize(a: torch.Tensor, b: torch.Tensor, m: int):
    """Marginalize the leading m states: (A', b') over the trailing block."""
    return schur_with(a, b, m, psd_pinv(a[:m, :m]))


def schur_with(a: torch.Tensor, b: torch.Tensor, m: int, amm_inv: torch.Tensor):
    """:func:`schur_marginalize` given the pseudo-inverse of A's leading
    m x m block."""
    arm = a[m:, :m]
    return a[m:, m:] - arm @ amm_inv @ a[:m, m:], b[m:] - arm @ amm_inv @ b[:m]


def factorize_prior(a: torch.Tensor, b: torch.Tensor):
    """(A, b) -> whitened (lin_jac, lin_res) via eigendecomposition sqrt
    (MarginalizationFactor.cc:293-302), reference-exact absolute threshold.
    Rows are defined up to the sign of each eigenvector; J^T J = A and
    J^T r = b are not."""
    a = 0.5 * (a + a.T)
    vals, vecs = _eigh(a)
    return factor_from_eigh(vals, vecs, b)


def factor_from_eigh(vals, vecs, b):
    """:func:`factorize_prior` from the eigendecomposition of the
    symmetrised A."""
    keep = vals > EPS
    zero = torch.zeros_like(vals)
    s = torch.where(keep, vals, zero)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, vals, torch.ones_like(vals)), zero)
    lin_jac = torch.sqrt(s)[:, None] * vecs.T
    lin_res = torch.sqrt(s_inv)[:, None] * vecs.T @ b
    return lin_jac, lin_res
