"""Peaks of the card and the work of the kernels the per-layer metrics
hold against them, counted from the problem's shape alone: the same count
whatever implements the kernel.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, float32
outside the tensor cores and HBM3 bandwidth. Each input and output byte
counts once.
"""

from __future__ import annotations

PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S)


def eigh_bound_s(n: int, itemsize: int = 4) -> float:
    """A symmetric eigendecomposition of order n: ~9 n^3 flops (tridiagonal
    reduction, QL, back-transformation); reads the matrix, writes the values
    and the vectors."""
    return bound_s(9.0 * n ** 3, itemsize * (n * n + n + n * n))


def solve_bound_s(n: int, itemsize: int = 4) -> float:
    """A dense solve of order n with one right-hand side by LU: (2/3) n^3 +
    2 n^2 flops; reads the matrix and the right-hand side, writes x."""
    return bound_s(2.0 / 3.0 * n ** 3 + 2.0 * n ** 2, itemsize * (n * n + 2 * n))
