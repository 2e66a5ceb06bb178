"""``nvcc`` builds of the port's CUDA sources (``csrc/*.cu``) into
``lio_mapping_tpu_torch/_build/``: a shared library with a plain C entry
point, for ``sm_90a``, compiled at first use (never at import) and loaded
with ``ctypes``. A library is named by its source's hash, so an edited
source rebuilds; ``ptxas``'s register and spill report lands beside it in
``<name>.log``. Processes that start together (the ranks of ``run --mesh``)
build once: the first takes the source's lock, the others wait for it and
find the library."""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v",
         "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at first use "
                       "and need the CUDA toolkit")


def build(source: str, stem: str, extra=()) -> Path:
    """Compile ``csrc/<source>`` (with ``extra`` flags after the common
    ones) into ``_build/lib<stem>_<hash>.so`` unless it is there; returns
    its path."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(extra).encode()).hexdigest()[:16]
    out = BUILD / f"lib{stem}_{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, *extra, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out
