"""Symmetric eigendecomposition of the step's small matrices: the wrapper
of the hand-written CUDA kernel (``csrc/eigh.cu``: a float64 Householder
tridiagonalization and implicit QL) and its plain version.

The kernel replaces the ``jnp.linalg.eigh`` calls that XLA runs inside the
reference's one program per sweep (``lio_mapping_tpu/ops/gn.py:31``,
``ops/marginalization.py:119`` and ``:155``): ``torch.linalg.eigh`` reads
LAPACK's status back to the host on every call, so the graphed step, which
reads nothing back, decomposes its 6x6, 15x15 and (15 S + 6)^2 matrices
with it. The source's note says what bounds it and what its design does
about that.

:func:`eigh` launches the kernel for a CUDA tensor (square, float32 or
float64 with n <= ``MAX_N``; anything else raises, and nothing falls back
to cuSOLVER) and runs :func:`eigh_plain` for a CPU tensor.
:func:`eigh_tridiag_reference` is the kernel's arithmetic step by step in
float64 (the same scaling, reduction, sums in the same order, QL chain and
sort): a CPU rehearsal (with 1 / sqrt for the chain's rsqrt), and on the
card the kernel's bits. The kernel is built with ``nvcc`` for ``sm_90a``
at first use into ``lio_mapping_tpu_torch/_build/`` and bound with
``ctypes`` (``ops/knn_kernel.py``'s way); nothing is built or loaded at
import. Its launches are counted by ``ops/launches.py`` (kind "eigh";
inside CUDA graphs at each replay).
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from . import cuda_build
from . import launches as LC

#: the largest order the kernel takes (``kMaxN`` in ``csrc/eigh.cu``: the
#: float64 matrix it keeps in shared memory), the same for float32 and
#: float64 inputs
MAX_N = 128
MAX_N_F64 = MAX_N
_TYPES = (torch.float32, torch.float64)
#: QL iterations on one eigenvalue after which it is taken as it stands
MAX_ITERS = 30

# the kernel's constants: QL's relative deflation test and its floors
_EPS = 2.0 ** -52
_TINY = 2.0 ** -960  # f^2 + g^2 below it ends a QL chain
_SAFE = 2.0 ** -480  # |e| at or below it deflates
_BIG = 2.0 ** 480
_LEAST_NORMAL = 2.0 ** -1022  # a column's sigma below it: no reflector

_lib = None
_lib_lock = threading.Lock()


def launches() -> int:
    """Launches of the kernel since import or :func:`reset_launches`."""
    return LC.count("eigh")


def reset_launches():
    LC.reset("eigh")


def build():
    """Compile ``csrc/eigh.cu`` into ``_build/`` (``ops/cuda_build.py``) and
    return the library path."""
    return cuda_build.build("eigh.cu", "lioeigh", extra=("--fmad=false",))


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for name in ("f32", "f64"):
                fn = getattr(lib, f"lio_eigh_{name}")
                fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
                fn.restype = ci
            lib.lio_eigh_max_n.restype = ci
            if lib.lio_eigh_max_n() != MAX_N:
                raise RuntimeError("csrc/eigh.cu and ops/eigh.py disagree on the largest order")
            _lib = lib
    return _lib


def eigh(a: torch.Tensor):
    """(eigenvalues ascending, eigenvectors as columns) of the symmetric
    ``a`` (..., n, n), read from its lower triangle as ``torch.linalg.eigh``
    reads it: the kernel on the card (in ``a``'s type), :func:`eigh_plain`
    on the CPU."""
    if a.device.type == "cpu":
        return eigh_plain(a)
    return eigh_cuda(a)


def eigh_plain(a: torch.Tensor):
    """``torch.linalg.eigh`` in the working type, except for a float32
    matrix, which is decomposed in float64 and returned in float32. In
    float32 the Schur complements of ``ops/marginalization`` carry rounding
    noise of ~1e5 (their bias blocks reach ~1e12 before the cancellation),
    and MKL's float32 divide-and-conquer refuses some of them as
    non-convergent where the reference's eigh decomposes them."""
    if a.dtype == torch.float32:
        vals, vecs = torch.linalg.eigh(a.double())
        return vals.float(), vecs.float()
    return torch.linalg.eigh(a)


def eigh_cuda(a: torch.Tensor, with_sweeps: bool = False):
    """One launch of the kernel over the batch of ``a``; raises on what the
    kernel does not take. Returns (vals, vecs) in ``a``'s type, the vectors
    column-major as ``torch.linalg.eigh`` returns them, and with
    ``with_sweeps`` the int32 QL iterations each matrix ran."""
    if not a.is_cuda:
        raise ValueError(f"eigh_cuda needs a CUDA tensor, got {a.device}")
    if a.dtype not in _TYPES:
        raise ValueError(f"the eigh kernel takes float32 or float64, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"eigh needs square matrices, got shape {tuple(a.shape)}")
    n = a.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the eigh kernel takes 1 <= n <= {MAX_N}, got {n}")
    batch_shape = a.shape[:-2]
    batch = math.prod(batch_shape)
    vals = torch.empty(batch_shape + (n,), dtype=a.dtype, device=a.device)
    vecs_t = torch.empty(batch_shape + (n, n), dtype=a.dtype, device=a.device)
    vecs = vecs_t.transpose(-1, -2)
    iters = (torch.zeros(batch_shape, dtype=torch.int32, device=a.device) if with_sweeps
             else None)
    if batch > 0:
        src = a.contiguous()
        lib = _load()
        stream = torch._C._cuda_getCurrentRawStream(a.device.index)
        fn = lib.lio_eigh_f32 if a.dtype == torch.float32 else lib.lio_eigh_f64
        err = fn(src.data_ptr(), vals.data_ptr(), vecs_t.data_ptr(),
                 None if iters is None else iters.data_ptr(), batch, n, MAX_ITERS, stream)
        if err != 0:
            raise RuntimeError(f"CUDA eigh kernel launch failed: cudaError {err}")
        LC.note("eigh", f"{batch}x{n}")
    return (vals, vecs, iters) if with_sweeps else (vals, vecs)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, step by step (csrc/eigh.cu)
# ---------------------------------------------------------------------------

def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """The kernel's butterfly sum over the last axis (32 lanes): lane l adds
    lane l ^ 16, then l ^ 8, ..., which is the halving tree."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _strided_sum(terms: torch.Tensor, width: int) -> torch.Tensor:
    """``width`` running sums, term j into sum j % width in order of j, from
    +0.0 (padding adds +0.0, which changes no sum: one that starts at +0.0
    is never -0.0)."""
    pad = (-terms.shape[0]) % width
    if pad:
        terms = torch.cat([terms, terms.new_zeros((pad,) + terms.shape[1:])])
    terms = terms.reshape((-1, width) + terms.shape[1:])
    acc = terms.new_zeros(terms.shape[1:])
    for row in terms:
        acc = acc + row
    return acc


def _dot4(rows: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_j rows[j] * y[j] as the kernel's two threads of a column sum it:
    four running sums by j % 4, then (s0 + s1) + (s2 + s3); one per column
    of ``rows``."""
    s = _strided_sum(rows * y[:, None], 4)
    return (s[0] + s[1]) + (s[2] + s[3])


def _hypot1(g: float) -> float:
    """sqrt(g^2 + 1) as the kernel's ``hypot1``."""
    ag = abs(g)
    if ag <= _BIG:
        return math.sqrt(g * g + 1.0)
    q = 1.0 / ag
    return ag * math.sqrt(1.0 + q * q)


def householder_reference(a: torch.Tensor):
    """The kernel's first stage on one (n, n) matrix on ``a``'s device: the
    lower triangle mirrored in float64, scaled by a power of two to a
    largest |a_ij| in [0.5, 1), reduced to tridiagonal form in LAPACK
    ``dsytrd('L')``'s column order, the reflectors accumulated backward into
    Q. Returns (d, e, Q, unscale): ``a * scale = Q T Q^T`` with T's
    diagonal ``d`` and subdiagonal ``e[:n-1]`` (Python floats, ``e[n-1] =
    0``) and ``unscale = 1 / scale``."""
    n = a.shape[-1]
    dev = a.device
    i = torch.arange(n, device=dev)
    m = torch.where(i[:, None] >= i[None, :], a, a.T).to(torch.float64)
    amax = float(m.abs().max()) if n else 0.0
    ex = 0
    if 0.0 < amax <= 1.7976931348623157e308:
        ex = min(max(math.frexp(amax)[1], -1020), 1000)
    m = m * math.ldexp(1.0, -ex)
    n_warps = (2 * n + 31) // 32  # 16 columns a warp, column c's first at lane c % 16
    d, e, taus = [0.0] * n, [0.0] * n, [0.0] * n
    for k in range(n - 2):
        x = m[k + 2:, k]
        sigma = float(_warp_sum(_strided_sum(x * x, 32)))
        alpha = float(m[k + 1, k])
        tau, beta = 0.0, alpha
        if sigma >= _LEAST_NORMAL:
            beta = -math.copysign(math.sqrt(alpha * alpha + sigma), alpha)
            tau = (beta - alpha) / beta
            scal = 1.0 / (alpha - beta)
            v = torch.cat([x.new_ones(1), x * scal])
            blk = m[k + 1:, k + 1:]
            p = tau * _dot4(blk, v)
            prod = p.new_zeros(32 * n_warps)
            cols = torch.arange(k + 1, n, device=dev)
            prod[32 * (cols // 16) + cols % 16] = p * v
            parts = _warp_sum(prod.reshape(n_warps, 32))
            pv = parts[0]
            for q in range(1, n_warps):
                pv = pv + parts[q]
            w = p + ((-0.5 * tau) * pv) * v
            m[k + 2:, k] = v[1:]
            m[k + 1:, k + 1:] = blk - (v[:, None] * w[None, :] + w[:, None] * v[None, :])
        d[k], e[k], taus[k] = float(m[k, k]), beta, tau
    if n >= 2:
        d[n - 2], e[n - 2] = float(m[n - 2, n - 2]), float(m[n - 1, n - 2])
    d[n - 1] = float(m[n - 1, n - 1])
    m[n - 1, n - 1] = 1.0
    for k in range(n - 3, -1, -1):
        v = m[k + 2:, k]
        tu = taus[k] * _dot4(m[k + 2:, k + 2:], v)
        m[k + 2:, k + 2:] = m[k + 2:, k + 2:] - v[:, None] * tu[None, :]
        m[k + 1, k + 2:] = -tu
        m[k + 1, k + 1] = 1.0 - taus[k]
        m[k + 2:, k + 1] = -taus[k] * v
    m[0, :] = 0.0
    m[:, 0] = 0.0
    m[0, 0] = 1.0
    return d, e, m, math.ldexp(1.0, ex)


def _rsqrt_on(device):
    """1 / sqrt(t) of a float as the kernel takes it: CUDA's ``rsqrt`` (one
    ``torch.rsqrt`` on the card, the same function) for a CUDA device, and
    on the CPU the correctly rounded 1 / sqrt(t) in its place (within an
    ulp of CUDA's: the CPU rehearsal is not the kernel's bits)."""
    if device is None or torch.device(device).type == "cpu":
        return lambda t: 1.0 / math.sqrt(t)
    one = torch.empty(1, dtype=torch.float64, device=device)

    def rsqrt(t):
        one.fill_(t)
        return float(torch.rsqrt(one))
    return rsqrt


def ql_reference(d, e, q, max_iters: int = MAX_ITERS, device=None):
    """The kernel's second stage: implicit QL with Wilkinson shifts on the
    tridiagonal (d, e) (lists of floats, changed in place), each rotation
    applied to the columns of ``q`` (a float64 array, changed in place), in
    the kernel's order of operations; each rotation's rsqrt on ``device``
    (:func:`_rsqrt_on`). Returns the QL iterations run."""
    rsqrt = _rsqrt_on(device)
    n = len(d)
    qt = np.ascontiguousarray(q.T)  # column i of q is row i here
    l, itl, iters = 0, 0, 0
    while l < n:
        m = l
        while m < n - 1 and abs(e[m]) > _EPS * (abs(d[m]) + abs(d[m + 1])) \
                and abs(e[m]) > _SAFE:
            m += 1
        if m == l or itl == max_iters:
            l, itl = l + 1, 0
            continue
        itl += 1
        iters += 1
        g = (d[l + 1] - d[l]) / (2.0 * e[l])
        g = (d[m] - d[l]) + e[l] / (g + math.copysign(_hypot1(g), g))
        s, c, p = 1.0, 1.0, 0.0
        x = qt[m].copy()
        i = m - 1
        while i >= l:
            f, b = s * e[i], c * e[i]
            t = f * f + g * g
            if not t >= _TINY:
                e[i + 1] = 0.0
                break
            rinv = rsqrt(t)
            r = t * rinv
            y = rinv * rinv
            e[i + 1] = r
            gg = d[i + 1] - p
            z = ((d[i] - gg) * f + (2.0 * b) * g) * y
            p = f * z
            d[i + 1] = gg + p
            s, c = f * rinv, g * rinv
            g = g * z - b
            yq = qt[i]
            qt[i + 1] = s * yq + c * x
            x = c * yq - s * x
            i -= 1
        qt[i + 1] = x
        if i >= l:
            d[i + 1] = d[i + 1] - p
            e[m] = 0.0
        else:
            d[l] = d[l] - p
            e[l] = g
            e[m] = 0.0
    q[...] = qt.T
    return iters


def eigh_tridiag_reference(a: torch.Tensor, max_iters: int = MAX_ITERS):
    """The kernel's algorithm on one (n, n) matrix, step by step, in
    float64: :func:`householder_reference` on ``a``'s device, then
    :func:`ql_reference` on the host (its rsqrt on ``a``'s device), then
    the kernel's sort (ascending, ties by index, NaNs last). Returns (vals,
    vecs, QL iterations) in ``a``'s type. Every operation is an IEEE
    float64 multiply, add, subtract, divide or square root in the kernel's
    order (the kernel is built without FMA contraction), or CUDA's rsqrt,
    so on the card it gives the kernel's bits. It reads its values back: a
    rehearsal, not a step."""
    d, e, m, unscale = householder_reference(a)
    q = m.cpu().numpy().copy()
    iters = ql_reference(d, e, q, max_iters, a.device)
    vals = torch.tensor([x * unscale for x in d], dtype=torch.float64)
    order = torch.argsort(torch.tensor(d, dtype=torch.float64), stable=True)
    vecs = torch.from_numpy(q)[:, order]
    return vals[order].to(a.device, a.dtype), vecs.to(a.device, a.dtype), iters
