"""Wrapper of the hand-written CUDA KNN kernel (``csrc/knn.cu``).

Replaces ``lio_mapping_tpu/ops/pallas/knn_kernel.py::knn_pallas`` (the
reference's one Pallas kernel) and the AABB prune flags built around it.
The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
sources in this package only, into ``lio_mapping_tpu_torch/_build/`` (a
plain C entry point in a shared library, loaded with ``ctypes``). Nothing
is built or loaded at import.

``knn_cuda`` (and ``search``, which also returns the tile flags) makes
one ctypes call per search, which enqueues all of its device work (the
bounds kernel, then the search kernel, which also merges) on the current
stream; it allocates the outputs and the scratch with ``torch.empty`` and
runs no other PyTorch op on them. It raises on anything the kernel does
not take, CPU tensors included: ``ops/knn.py::knn`` sends those to the
plain version. ``prune_flags`` is the plain version of the kernel's tile
flags. ``LAUNCHES`` counts searches.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

# the constexprs of csrc/knn.cu (tests/test_torch_knn.py holds them equal)
BQ = 256       # queries per prune block (the Pallas BQ: prune-flag granularity)
BM = 2048      # map points per chunk (the Pallas BM)
TPQ = 8        # lanes per query in the search: sub-ranges per chunk
QPC = 32       # queries per search CTA
BATCH = 4      # sub-ranges are whole batches of this many points
BOUNDS_BYTES = 48  # sizeof(Bounds)
MAX_K = 8

#: searches since import (``chip_smoke.py`` resets and reads it)
LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "knn.cu"
_BUILD = _PKG / "_build"
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA KNN kernel is built at first use "
                       "and needs the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/knn.cu`` into ``_build/`` (named by the source hash, so
    an edited source rebuilds) and return the library path. ``ptxas``'s
    register and spill report lands beside it in ``<name>.log``."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD / f"liblioknn_{digest}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    # processes that start together (the ranks of ``run --mesh``) build once:
    # the first takes the lock, the others wait for it and find the library
    with open(_BUILD / "knn.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.lio_knn_f32.argtypes = ([vp] * 4 + [ci] * 3 + [ctypes.c_float] + [vp] * 3
                                        + [ctypes.c_size_t, vp])
            lib.lio_knn_f32.restype = ci
            lib.lio_knn_scratch_bytes.argtypes = [ci] * 3
            lib.lio_knn_scratch_bytes.restype = ctypes.c_size_t
            lib.lio_noop.argtypes = [vp]
            lib.lio_noop.restype = ci
            _lib = lib
    return _lib


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def scratch_bytes(q_n: int, m_n: int, k: int) -> int:
    """Scratch of one search (``lio_knn_scratch_bytes`` in ``csrc/knn.cu``):
    the (n_qblocks, n_chunks) uint8 tile flags first, then an int32 counter
    per query group, the bounds records, the packed map (float4 a point)
    and the per-chunk k-best lists (f32 distances and int32 indices)."""
    n_qb, n_ch, n_groups = -(-q_n // BQ), -(-m_n // BM), -(-q_n // QPC)
    parts = n_ch * k * q_n * 4
    return (_align16(n_qb * n_ch) + _align16(n_groups * 4) + _align16((n_qb + n_ch) * BOUNDS_BYTES)
            + _align16(m_n * 16) + _align16(parts) + parts)


def prune_flags(queries, q_mask, db, db_mask, prune_beyond: float) -> torch.Tensor:
    """(n_qblocks, n_chunks) uint8: 1 where the AABB lower bound between a
    256-query block and a 2048-point chunk exceeds the gate (reference
    knn_kernel.py:152-165). Empty blocks are pruned. The plain version of
    the kernel's flags: the lower bound is summed (g0^2 + g2^2) + g1^2, the
    order of ``torch.sum`` over the last axis on the card, on every device
    and in the kernel."""
    q_n, m_n = queries.shape[0], db.shape[0]
    n_qb, n_ch = -(-q_n // BQ), -(-m_n // BM)

    def aabb(pts, valid, n_blocks, bs):
        pad = n_blocks * bs - pts.shape[0]
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
        inf = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
        lo = torch.where(valid[:, None], pts, inf).reshape(n_blocks, bs, 3).amin(1)
        hi = torch.where(valid[:, None], pts, -inf).reshape(n_blocks, bs, 3).amax(1)
        return lo, hi

    q_lo, q_hi = aabb(queries, q_mask, n_qb, BQ)
    c_lo, c_hi = aabb(db, db_mask, n_ch, BM)
    gap = torch.clamp_min(torch.maximum(q_lo[:, None, :] - c_hi[None, :, :],
                                        c_lo[None, :, :] - q_hi[:, None, :]), 0.0)
    g2 = gap * gap
    lb = (g2[..., 0] + g2[..., 2]) + g2[..., 1]
    prune = torch.isnan(lb) | (lb > prune_beyond)
    return prune.to(torch.uint8).contiguous()


def _check(name, t, shape, dtype):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(queries, q_mask, db, db_mask, k, prune_beyond):
    """Checks the inputs, allocates, and enqueues one search: returns
    (out_d, out_i, scratch), the tile flags at the start of ``scratch``."""
    global LAUNCHES
    q_n, m_n = queries.shape[0], db.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"kernel takes 1 <= k <= {MAX_K}, got {k}")
    if q_n < 1 or m_n < 1:
        raise ValueError(f"kernel needs at least one query and one map point, got {q_n}, {m_n}")
    _check("queries", queries, (q_n, 3), torch.float32)
    _check("q_mask", q_mask, (q_n,), torch.bool)
    _check("db", db, (m_n, 3), torch.float32)
    _check("db_mask", db_mask, (m_n,), torch.bool)
    dev = queries.device
    if db.device != dev or q_mask.device != dev or db_mask.device != dev:
        raise ValueError(f"queries on {dev}, map on {db.device}")
    lib = _load()
    out_d = torch.empty((q_n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=dev)
    n_scratch = scratch_bytes(q_n, m_n, k)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    gate = math.inf if prune_beyond is None else float(prune_beyond)
    # the raw handle of the current stream, without building a Stream object
    # (which costs as much host time as the launches)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.lio_knn_f32(
        queries.data_ptr(), q_mask.data_ptr(), db.data_ptr(), db_mask.data_ptr(), q_n, m_n, k,
        gate, out_d.data_ptr(), out_i.data_ptr(), scratch.data_ptr(), n_scratch, stream)
    if err != 0:
        raise RuntimeError(f"CUDA KNN kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_d, out_i, scratch


def search(queries, q_mask, db, db_mask, k: int = 5, prune_beyond: float | None = None):
    """One search through the kernel: (sq_dists (Q, k) f32 ascending,
    idx (Q, k) int32, flags (ceil(Q/256), ceil(M/2048)) uint8).

    ``flags`` marks the tiles the kernel skipped: with a gate they equal
    ``prune_flags``; without one they mark the tiles with no valid query
    or no valid map point, which change no result. Masked queries get +inf
    and index 0."""
    out_d, out_i, scratch = _launch(queries, q_mask, db, db_mask, k, prune_beyond)
    n_qb, n_ch = -(-queries.shape[0] // BQ), -(-db.shape[0] // BM)
    return out_d, out_i, scratch[:n_qb * n_ch].view(n_qb, n_ch)


def knn_cuda(queries, q_mask, db, db_mask, k: int = 5, prune_beyond: float | None = None):
    """Exact kNN through the CUDA kernel; same contract as ``ops.knn.knn``.

    Returns (sq_dists (Q, k) f32 ascending, idx (Q, k) int32). Launches the
    kernel or raises; the choice of the plain version for CPU tensors is
    ``ops.knn.knn``'s."""
    out_d, out_i, _ = _launch(queries, q_mask, db, db_mask, k, prune_beyond)
    return out_d, out_i
