"""Dense solve of the step's small systems: the wrapper of the hand-written
CUDA LU kernel (``csrc/lu_solve.cu``) and its plain version.

The kernel replaces the ``jnp.linalg.solve`` calls that XLA runs inside the
reference's one program per sweep (the mini-GN's 6x6 step,
``lio_mapping_tpu/models/estimator.py:369``; the window LM's damped system,
``lio_mapping_tpu/ops/solver.py:397``; the odometry's and mapping's 6x6
steps). On the card torch's solve goes to cuSOLVER, whose ``getrf``
allocates stream-ordered memory when it is captured on another stream than
its last call, and a CUDA graph's conditional body (the LM's iterations
after the first) may hold no allocation: the graphed step needs a solve of
its own. The source's note says what bounds it and how the kernel keeps
each row of the system in registers.

:func:`solve` launches the kernel for CUDA tensors (float32 or float64,
``a`` (n, n) with n <= ``MAX_N``, ``b`` (n,); anything else raises, and
nothing falls back to cuSOLVER) and runs :func:`solve_plain` for CPU
tensors: ``torch.linalg.solve_ex`` without its error check, bit for bit
the CPU's ``torch.linalg.solve``. A singular system gives non-finite
entries, as ``jnp.linalg.solve`` does. The kernel is built with ``nvcc``
for ``sm_90a`` at first use (``ops/cuda_build.py``) and bound with
``ctypes``; its launches are counted by ``ops/launches.py`` (kind "solve").
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build
from . import launches as LC

#: the largest order the kernel takes (``kMaxN`` in ``csrc/lu_solve.cu``)
MAX_N = 128

_lib = None
_lib_lock = threading.Lock()


def launches() -> int:
    """Launches of the kernel since import or :func:`reset_launches`."""
    return LC.count("solve")


def reset_launches():
    LC.reset("solve")


def build():
    """Compile ``csrc/lu_solve.cu`` into ``_build/`` and return its path."""
    return cuda_build.build("lu_solve.cu", "liolusolve")


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for name in ("lio_lu_solve_f32", "lio_lu_solve_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, vp, ci, ci, vp]
                fn.restype = ci
            lib.lio_lu_solve_max_n.restype = ci
            if lib.lio_lu_solve_max_n() != MAX_N:
                raise RuntimeError("csrc/lu_solve.cu and ops/lu_solve.py disagree on MAX_N")
            _lib = lib
    return _lib


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with ``a @ x = b``: the kernel on the card, :func:`solve_plain` on
    the CPU."""
    if a.device.type == "cpu":
        return solve_plain(a, b)
    return solve_cuda(a, b)


def solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` without its error check, which reads the
    factorization's status back to the host."""
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


def solve_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel; raises on what it does not take."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"solve_cuda needs CUDA tensors on one device, got {a.device}, "
                         f"{b.device}")
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise ValueError(f"the solve kernel takes float32 or float64, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or tuple(b.shape) != (a.shape[0],):
        raise ValueError(f"the solve kernel takes a (n, n) and b (n,), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    n = a.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the solve kernel takes 1 <= n <= {MAX_N}, got {n}")
    a, b = a.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    lib = _load()
    fn = lib.lio_lu_solve_f32 if a.dtype == torch.float32 else lib.lio_lu_solve_f64
    err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), 1, n,
             torch._C._cuda_getCurrentRawStream(a.device.index))
    if err != 0:
        raise RuntimeError(f"CUDA solve kernel launch failed: cudaError {err}")
    LC.note("solve", f"1x{n}")
    return x


def lu_solve_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm on one system in ``a``'s type, step by step
    (the first largest pivot in LAPACK's row order, the multipliers, the
    trailing update, the back substitution; the rows swapped where the
    kernel records their positions). A CPU rehearsal of the kernel: it
    reads its pivots back."""
    n = a.shape[0]
    m = torch.cat([a, b[:, None]], dim=1).clone()
    for k in range(n):
        col = m[k:, k].abs()
        col = torch.where(torch.isnan(col), torch.full_like(col, -1.0), col)
        p = k + int(torch.argmax(col))  # the first of equal maxima
        if p != k:
            m[[k, p], k:] = m[[p, k], k:]
        piv = m[k, k]
        if piv != 0:
            m[k + 1:, k] = m[k + 1:, k] / piv
            m[k + 1:, k + 1:] -= m[k + 1:, k:k + 1] * m[k, k + 1:][None, :]
    for i in range(n - 1, -1, -1):
        m[i, n] = m[i, n] / m[i, i]
        m[:i, n] -= m[:i, i] * m[i, n]
    return m[:, n].clone()
