"""Shared 6-DoF Gauss-Newton machinery with degeneracy projection
(port of lio_mapping_tpu.ops.gn; PointOdometry.cc:539-615).

As in the reference port, the projection ``P = V diag(mask) V^T`` removes
the near-null eigen-directions (scan ascending eigenvalues, stop at the
first above the threshold).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import eigh as EIGH
from . import lu_solve as LU


class GNState(NamedTuple):
    proj: torch.Tensor          # (6,6) degeneracy projection matrix
    is_degenerate: torch.Tensor  # bool


def degeneracy_projection(ata: torch.Tensor, eigen_th: float) -> GNState:
    """The degenerate-direction projector from A^T A (iteration 0 only); the
    ``eigh`` is ``ops/eigh.eigh`` (the Householder + QL kernel on the card)."""
    vals, vecs = EIGH.eigh(ata)  # ascending
    return projection_from_eigh(vals, vecs, eigen_th)


def projection_from_eigh(vals: torch.Tensor, vecs: torch.Tensor, eigen_th: float) -> GNState:
    """:func:`degeneracy_projection` from A^T A's eigendecomposition."""
    keep_small = torch.cumprod((vals < eigen_th).to(torch.int32), dim=0) == 1
    mask = (~keep_small).to(vecs.dtype)
    proj = (vecs * mask[None, :]) @ vecs.T
    return GNState(proj=proj, is_degenerate=torch.any(keep_small))


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve(a, b)`` without its error check (which reads
    the factorization's status back to the host): ``ops/lu_solve.solve``,
    the LU kernel on the card and ``torch.linalg.solve_ex`` on the CPU (the
    same factorization and solve as ``torch.linalg.solve``, bit for bit). A
    singular system gives non-finite entries instead of an error, as
    ``jnp.linalg.solve`` does in the reference."""
    return LU.solve(a, b)


def solve_normal_equations(jac, rhs, w, state: GNState | None, eigen_th: float):
    """Solve (J^T J) x = J^T b with row weights ``w`` and the degeneracy
    projection (computed when ``state`` is None). Returns (x (6,), state)."""
    jw = jac * w[:, None]
    ata = jw.T @ jac
    atb = jw.T @ rhs
    x = solve(ata + 1e-12 * torch.eye(6, dtype=ata.dtype, device=ata.device), atb)
    if state is None:
        state = degeneracy_projection(ata, eigen_th)
    x = torch.where(state.is_degenerate, state.proj @ x, x)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return x, state
