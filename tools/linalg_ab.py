#!/usr/bin/env python3
"""Hold this checkout's eigh and LU solve kernels against another checkout's, on one GPU.

    python3 tools/linalg_ab.py --ref DIR [--reps 50]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit). Both packages are loaded
side by side (the other under another name), each building its own
``csrc/eigh.cu`` and ``csrc/lu_solve.cu``, and both kernels are called
through their wrappers' ``eigh_cuda`` and ``solve_cuda``.

LU solve: on damped normal equations, Gaussian, small-integer (ties of
|a_ik| everywhere) and singular systems and systems with a NaN, at orders
1-128 in float32 and float64, it checks that the two kernels return the
same bits. eigh: on ``chip_smoke.py``'s synthetic matrices (Wishart, graded,
degenerate) it prints both kernels' eigenvalue error against float64
``torch.linalg.eigh`` and their iterations (different algorithms: no bits
compared). Then it times both kernels in turns (other, this, this, other)
at the main path's orders (CUDA events, mean of ``--reps`` calls after
warm-up), beside ``torch.linalg.eigh`` / ``torch.linalg.solve`` in float32.

Prints one JSON object per line; the last line is the summary. Exits
non-zero on any differing bit of the solve or without CUDA.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EIGH_ORDERS = (6, 15, 51, 81, 111, 128)
SOLVE_ORDERS = (6, 96, 126, 128)


def load_ops(root: str, alias: str):
    """(ops.eigh, ops.lu_solve) of the package under ``root``, imported as
    the top-level package ``alias``."""
    pkg = os.path.join(root, "lio_mapping_tpu_torch")
    spec = importlib.util.spec_from_file_location(alias, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{alias}.ops.eigh"),
            importlib.import_module(f"{alias}.ops.lu_solve"))


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def systems(n: int, rng):
    """(name, A, b) float64 systems of order ``n``."""
    j = rng.normal(size=(3 * n, n)) * 10.0 ** rng.uniform(0.0, 3.0, size=n)
    damped = j.T @ j
    damped += 1e-4 * np.diag(np.diag(damped))
    ints = rng.integers(-2, 3, size=(n, n)).astype(np.float64) + 3.0 * np.eye(n)
    sing = rng.normal(size=(n, n))
    sing[n // 2] = 0.0
    nan = rng.normal(size=(n, n))
    nan[n - 1, 0] = np.nan
    b = rng.normal(size=n)
    return [("damped", damped, b), ("gauss", rng.normal(size=(n, n)), b),
            ("ints", ints, np.round(b * 4)), ("singular", sing, b), ("nan", nan, b)]


def bits(x: torch.Tensor) -> np.ndarray:
    x = x.cpu().numpy()
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", required=True, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("linalg_ab: CUDA is not available")
    dev = torch.device("cuda")
    sys.path.insert(0, ROOT)
    import chip_smoke

    new_eigh, new_lu = load_ops(ROOT, "lio_this")
    ref_eigh, ref_lu = load_ops(os.path.abspath(args.ref), "lio_other")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)

    rng = np.random.default_rng(0)
    n_bad = n_cases = 0
    for n in (1, 2, 3, 5, 6, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 66, 96, 100, 126,
              127, 128):
        for name, a_np, b_np in systems(n, rng):
            for dtype in (torch.float32, torch.float64):
                a = torch.as_tensor(a_np, dtype=dtype, device=dev)
                b = torch.as_tensor(b_np, dtype=dtype, device=dev)
                same = np.array_equal(bits(new_lu.solve_cuda(a, b)), bits(ref_lu.solve_cuda(a, b)))
                n_cases += 1
                if not same:
                    n_bad += 1
                    print(json.dumps({"solve_differs": name, "n": n, "dtype": str(dtype)}),
                          flush=True)
    print(json.dumps({"solve_cases": n_cases, "solve_differing": n_bad}), flush=True)

    for n in EIGH_ORDERS:
        for name, m in chip_smoke.eigh_synthetic(n, n):
            a = torch.as_tensor(m, dtype=torch.float32, device=dev)
            truth = torch.linalg.eigh(a.double())[0]
            scale = float(truth.abs().max())
            rec = {"case": name, "n": n}
            for tag, mod in (("this", new_eigh), ("other", ref_eigh)):
                vals, _, it = mod.eigh_cuda(a, with_sweeps=True)
                rec[f"{tag}_rel_err"] = float((vals.double() - truth).abs().max()) / scale
                rec[f"{tag}_iterations"] = int(it)
            print(json.dumps(rec), flush=True)

    def solve_case(n):
        return chip_smoke.solve_synthetic(n, n)

    order = ("other", "this", "this", "other")
    mods = {"this": (new_eigh, new_lu), "other": (ref_eigh, ref_lu)}
    timed = []
    for n in EIGH_ORDERS:
        a = torch.as_tensor(chip_smoke.eigh_synthetic(n, n)[0][1], dtype=torch.float32,
                            device=dev)
        t = [cuda_ms(lambda: mods[o][0].eigh_cuda(a), args.reps) for o in order]
        lib = cuda_ms(lambda: torch.linalg.eigh(a), max(5, args.reps // 5))
        timed.append({"kernel": "eigh", "n": n, "other_ms": [t[0], t[3]],
                      "this_ms": [t[1], t[2]], "speedup": (t[0] + t[3]) / (t[1] + t[2]),
                      "library_ms": lib})
    for n in SOLVE_ORDERS:
        a, b = solve_case(n)
        t = [cuda_ms(lambda: mods[o][1].solve_cuda(a, b), args.reps) for o in order]
        lib = cuda_ms(lambda: torch.linalg.solve(a, b), max(5, args.reps // 5))
        timed.append({"kernel": "lu_solve", "n": n, "other_ms": [t[0], t[3]],
                      "this_ms": [t[1], t[2]], "speedup": (t[0] + t[3]) / (t[1] + t[2]),
                      "library_ms": lib})
    for rec in timed:
        print(json.dumps(rec), flush=True)
    summary = {"device": smi, "solve_cases": n_cases, "solve_differing": n_bad,
               "ok": n_bad == 0}
    print(json.dumps(summary), flush=True)
    if n_bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
