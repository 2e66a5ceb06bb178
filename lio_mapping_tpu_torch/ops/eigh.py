"""Symmetric eigendecomposition of the step's small matrices: the wrapper
of the hand-written CUDA Jacobi kernel (``csrc/eigh.cu``) and its plain
version.

The kernel replaces the ``jnp.linalg.eigh`` calls that XLA runs inside the
reference's one program per sweep (``lio_mapping_tpu/ops/gn.py:31``,
``ops/marginalization.py:119`` and ``:155``): ``torch.linalg.eigh`` reads
LAPACK's status back to the host on every call, so the graphed step, which
reads nothing back, decomposes its 6x6, 15x15 and (15 S + 6)^2 matrices
with it. The source's note says why Jacobi and what bounds it.

:func:`eigh` launches the kernel for a CUDA tensor (square, float32 with
n <= ``MAX_N`` or float64 with n <= ``MAX_N_F64``; anything else raises,
and nothing falls back to cuSOLVER) and runs :func:`eigh_plain` for a CPU
tensor. :func:`eigh_jacobi_reference` is the kernel's arithmetic step by
step in torch (same pairing, same rotation rule, same stopping rule, the
matrix in its type and the rotations and vectors in float64): a CPU
rehearsal, and on the card the kernel's bits. The kernel is built with
``nvcc`` for ``sm_90a`` at first use into ``lio_mapping_tpu_torch/_build/``
and bound with ``ctypes`` (``ops/knn_kernel.py``'s way); nothing is built
or loaded at import. Its launches are counted by ``ops/launches.py`` (kind
"eigh"; inside CUDA graphs at each replay).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import cuda_build
from . import launches as LC

#: the largest order the kernel takes in float32 and in float64 (``kMaxN``
#: and ``kMaxN64`` in ``csrc/eigh.cu``: what shared memory holds)
MAX_N = 128
MAX_N_F64 = 118
_MAX_ORDER = {torch.float32: MAX_N, torch.float64: MAX_N_F64}
#: sweeps after which the kernel stops even if rotations remain
MAX_SWEEPS = 32

_lib = None
_lib_lock = threading.Lock()


def tolerance(n: int, dtype=torch.float32) -> float:
    """The relative off-diagonal threshold of an order-``n`` matrix of
    ``dtype``: a pair rotates while |a_pq| > tol sqrt|a_pp| sqrt|a_qq|."""
    return torch.finfo(dtype).eps * math.sqrt(n)


def launches() -> int:
    """Launches of the kernel since import or :func:`reset_launches`."""
    return LC.count("eigh")


def reset_launches():
    LC.reset("eigh")


def build():
    """Compile ``csrc/eigh.cu`` into ``_build/`` (``ops/cuda_build.py``) and
    return the library path."""
    return cuda_build.build("eigh.cu", "liojacobi", extra=("--fmad=false",))


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for name in ("f32", "f64"):
                fn = getattr(lib, f"lio_eigh_{name}")
                fn.argtypes = [vp, vp, vp, vp, ci, ci, ctypes.c_double, ci, vp]
                fn.restype = ci
                getattr(lib, f"lio_eigh_max_n_{name}").restype = ci
            if (lib.lio_eigh_max_n_f32(), lib.lio_eigh_max_n_f64()) != (MAX_N, MAX_N_F64):
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
    ``with_sweeps`` the int32 sweeps each matrix ran."""
    if not a.is_cuda:
        raise ValueError(f"eigh_cuda needs a CUDA tensor, got {a.device}")
    if a.dtype not in _MAX_ORDER:
        raise ValueError(f"the eigh kernel takes float32 or float64, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"eigh needs square matrices, got shape {tuple(a.shape)}")
    n = a.shape[-1]
    max_n = _MAX_ORDER[a.dtype]
    if not 1 <= n <= max_n:
        raise ValueError(f"the {a.dtype} eigh kernel takes 1 <= n <= {max_n}, got {n}")
    batch_shape = a.shape[:-2]
    batch = math.prod(batch_shape)
    vals = torch.empty(batch_shape + (n,), dtype=a.dtype, device=a.device)
    vecs_t = torch.empty(batch_shape + (n, n), dtype=a.dtype, device=a.device)
    vecs = vecs_t.transpose(-1, -2)
    sweeps = (torch.zeros(batch_shape, dtype=torch.int32, device=a.device) if with_sweeps
              else None)
    if batch > 0:
        src = a.contiguous()
        lib = _load()
        stream = torch._C._cuda_getCurrentRawStream(a.device.index)
        fn = lib.lio_eigh_f32 if a.dtype == torch.float32 else lib.lio_eigh_f64
        err = fn(src.data_ptr(), vals.data_ptr(), vecs_t.data_ptr(),
                 None if sweeps is None else sweeps.data_ptr(), batch, n,
                 tolerance(n, a.dtype), MAX_SWEEPS, stream)
        if err != 0:
            raise RuntimeError(f"CUDA eigh kernel launch failed: cudaError {err}")
        LC.note("eigh", f"{batch}x{n}")
    return (vals, vecs, sweeps) if with_sweeps else (vals, vecs)


def _round_robin(m: int, device=None):
    """The steps of one sweep: (p, q) index tensors of the m/2 disjoint
    pairs of each step, p < q (``csrc/eigh.cu``'s circle pairing)."""
    steps = []
    for r in range(m - 1):
        ps, qs = [], []
        for k in range(m // 2):
            i, j = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
            ps.append(min(i, j))
            qs.append(max(i, j))
        steps.append((torch.tensor(ps, device=device), torch.tensor(qs, device=device)))
    return steps


def eigh_jacobi_reference(a: torch.Tensor, max_sweeps: int = MAX_SWEEPS):
    """The kernel's algorithm on one (n, n) matrix on ``a``'s device, step
    by step (the rotations of a step at once, rows then columns, the pair's
    2x2 block set exactly): the matrix in ``a``'s type, the rotations and
    the eigenvectors in float64. Returns (vals ascending, vecs, sweeps run)
    in ``a``'s type. It reads its flags back: a rehearsal of the kernel on
    the CPU, and on the card the same operations as the kernel (which is
    built without FMA contraction), so the same bits."""
    n = a.shape[-1]
    m = n + n % 2
    f64 = torch.float64
    low = torch.tril(a)
    mat = torch.zeros((m, m), dtype=a.dtype, device=a.device)
    mat[:n, :n] = low + torch.tril(a, -1).T
    vec = torch.eye(m, dtype=f64, device=a.device)
    tol = tolerance(n, a.dtype)
    sweeps = 0
    for _ in range(max_sweeps):
        sweeps += 1
        rotated = False
        for p, q in _round_robin(m, a.device):
            app, aqq, apq = (x.to(f64) for x in (mat[p, p], mat[q, q], mat[p, q]))
            rot = (q < n) & (apq.abs() > tol * app.abs().sqrt() * aqq.abs().sqrt())
            if not bool(rot.any()):
                continue
            rotated = True
            p, q = p[rot], q[rot]
            app, aqq, apq = app[rot], aqq[rot], apq[rot]
            tau = (aqq - app) / (2.0 * apq)
            t = torch.copysign(torch.ones_like(tau), tau) / (tau.abs() + torch.hypot(
                torch.ones_like(tau), tau))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            x, y = mat[p, :].to(f64), mat[q, :].to(f64)
            mat[p, :] = (c[:, None] * x - s[:, None] * y).to(a.dtype)
            mat[q, :] = (s[:, None] * x + c[:, None] * y).to(a.dtype)
            for arr in (mat, vec):
                x, y = arr[:, p].to(f64), arr[:, q].to(f64)
                arr[:, p] = (c[None, :] * x - s[None, :] * y).to(arr.dtype)
                arr[:, q] = (s[None, :] * x + c[None, :] * y).to(arr.dtype)
            mat[p, p] = (app - t * apq).to(a.dtype)
            mat[q, q] = (aqq + t * apq).to(a.dtype)
            mat[p, q] = 0.0
            mat[q, p] = 0.0
        if not rotated:
            break
    d = torch.diagonal(mat)[:n]
    # the kernel's order: ascending, ties (-0.0 == 0.0 too) by index
    order = torch.argsort(d.cpu(), stable=True).to(a.device)
    return d[order], vec[:n, :n][:, order].to(a.dtype), sweeps
