"""Wrapper of the hand-written CUDA KNN kernel (``csrc/knn.cu``).

Replaces ``lio_mapping_tpu/ops/pallas/knn_kernel.py::knn_pallas`` (the
reference's one Pallas kernel). The kernel is compiled with ``nvcc`` for
``sm_90a`` at first use, from the sources in this package only, into
``lio_mapping_tpu_torch/_build/`` (a plain C entry point in a shared
library, loaded with ``ctypes``). Nothing is built or loaded at import.

``knn_cuda`` launches the kernel and raises on anything the kernel does not
take, CPU tensors included: ``ops/knn.py::knn`` sends those to the plain
version. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

BQ = 256       # queries per block (the Pallas BQ: prune-flag granularity)
BM = 2048      # map points per chunk
MAX_K = 8

#: kernel launches since import (``chip_smoke.py`` resets and reads it)
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
            fn = lib.lio_knn_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def prune_flags(queries, q_mask, db, db_mask, prune_beyond: float) -> torch.Tensor:
    """(n_qblocks, n_chunks) uint8: 1 where the AABB lower bound between a
    256-query block and a 2048-point chunk exceeds the gate (reference
    knn_kernel.py:152-165). Empty blocks are pruned."""
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
    lb = torch.sum(gap * gap, dim=-1)
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


def knn_cuda(queries, q_mask, db, db_mask, k: int = 5, prune_beyond: float | None = None):
    """Exact kNN through the CUDA kernel; same contract as ``ops.knn.knn``.

    Returns (sq_dists (Q, k) f32 ascending, idx (Q, k) int32). Launches the
    kernel or raises; the choice of the plain version for CPU tensors is
    ``ops.knn.knn``'s."""
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
    if db.device != queries.device:
        raise ValueError(f"queries on {queries.device}, map on {db.device}")
    prune = None
    if prune_beyond is not None:
        prune = prune_flags(queries, q_mask, db, db_mask, float(prune_beyond))
    lib = _load()
    out_d = torch.empty((q_n, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = lib.lio_knn_f32(
        queries.data_ptr(), db.data_ptr(), db_mask.data_ptr(),
        None if prune is None else prune.data_ptr(), q_n, m_n, k,
        out_d.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"CUDA KNN kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    out_d = torch.where(q_mask[:, None], out_d, float("inf"))
    return out_d, out_i
