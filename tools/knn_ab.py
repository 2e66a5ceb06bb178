#!/usr/bin/env python3
"""Hold this checkout's CUDA KNN against another checkout's, on one GPU.

    python3 tools/knn_ab.py --ref DIR [--reps 20]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of an earlier commit). Both wrappers
(``lio_mapping_tpu_torch/ops/knn_kernel.py``) are loaded side by side, each
building its own ``csrc/knn.cu``, and both are called through ``knn_cuda``,
the entry the main path uses. On the main-path shapes of ``chip_smoke.py``
and on clustered and grid inputs (k = 1, 5, 8, gated and not) it checks
that the two return the same bits on every unmasked row, distances and
indices, and that this checkout's tile flags equal the other's
``prune_flags``. It also counts, on random gaps, how often PyTorch's
``sum(g * g, -1)`` on the card rounds otherwise than each order of the
three additions (the kernel adds ``(g0^2 + g2^2) + g1^2``). Then
it times both searches at the main-path shapes in turns (other, this,
this, other): the whole call (CUDA events, mean of ``--reps`` calls after
warm-up) and its device kernels alone (torch.profiler).

Prints one JSON object per line; the last line is the summary. Exits
non-zero on any difference or without CUDA.
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


def load_wrapper(root: str, name: str):
    """``ops/knn_kernel.py`` of the package under ``root``, imported with
    its package as the top-level package ``name`` (the wrapper imports its
    siblings relatively)."""
    pkg = os.path.join(root, "lio_mapping_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.knn_kernel")


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


def device_ms(fn, reps: int) -> float:
    """Device time per call summed over the CUDA kernels ``fn`` launches
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def extra_cases(dev):
    """Clustered (voxel-like, spatially sorted) and grid (exact ties)
    inputs at ragged sizes: (name, q, qm, db, dbm, k, gate)."""
    out = []
    for seed, (n_q, n_m) in enumerate([(700, 9000), (3000, 20000), (1, 2100), (257, 5)]):
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(8, 3)) * 5
        db = centers[rng.integers(0, 8, n_m)] + rng.normal(size=(n_m, 3)) * 0.5
        db = db[np.argsort(db[:, 0], kind="stable")]
        q = centers[rng.integers(0, 8, n_q)] + rng.normal(size=(n_q, 3)) * 0.7
        q = q[np.argsort(q[:, 0], kind="stable")]
        if seed == 1:  # grid coordinates: exact ties everywhere
            db, q = np.round(db * 4) / 4, np.round(q * 4) / 4
        dm, qm = rng.random(n_m) > 0.05, rng.random(n_q) > 0.1
        qm[0] = True
        t = [torch.as_tensor(x.astype(np.float32) if x.dtype == np.float64 else x).to(dev)
             for x in (q, qm, db, dm)]
        for k in (1, 5, 8):
            for gate in (None, 1.0):
                out.append((f"extra{seed}_{n_q}x{n_m}", *t, k, gate))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", required=True, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("knn_ab: CUDA is not available")
    dev = torch.device("cuda")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from lio_mapping_tpu_torch.config import LioConfig

    new = load_wrapper(ROOT, "knn_kernel_this")
    ref = load_wrapper(os.path.abspath(args.ref), "knn_kernel_other")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)

    main_cases, _ = chip_smoke.knn_cases(chip_smoke.sim_trajectory(), LioConfig.indoor())
    cases = main_cases + extra_cases(dev)
    n_bad = 0
    n_rows = 0
    for name, q, qm, db, dbm, k, gate in cases:
        rd, ri = ref.knn_cuda(q, qm, db, dbm, k=k, prune_beyond=gate)
        gd, gi, flags = new.search(q, qm, db, dbm, k=k, prune_beyond=gate)
        m = qm.cpu().numpy()
        rd, ri, gd, gi = (x.cpu().numpy() for x in (rd, ri, gd, gi))
        same_d = np.array_equal(rd[m].view(np.uint32), gd[m].view(np.uint32))
        same_i = np.array_equal(ri[m], gi[m])
        rec = {"case": name, "k": k, "gate": gate, "rows": int(m.sum()),
               "same_dist_bits": same_d, "same_idx": same_i,
               "masked_rows_inf": bool(np.isinf(gd[~m]).all())}
        if gate is not None:
            want = ref.prune_flags(q, qm, db, dbm, gate).cpu().numpy()
            rec["same_flags"] = bool(np.array_equal(flags.cpu().numpy(), want))
        ok = same_d and same_i and rec["masked_rows_inf"] and rec.get("same_flags", True)
        n_bad += not ok
        n_rows += int(m.sum())
        print(json.dumps(rec), flush=True)

    # PyTorch's rounding of a 3-term sum of squares against the kernel's
    torch.manual_seed(0)
    g = torch.rand((1 << 20, 3), device=dev) * torch.tensor([1.0, 0.3, 0.05], device=dev)
    g2 = g * g
    lb = torch.sum(g2, dim=-1)
    orders = {"(0+1)+2": int(torch.sum(lb != (g2[:, 0] + g2[:, 1]) + g2[:, 2])),
              "0+(1+2)": int(torch.sum(lb != g2[:, 0] + (g2[:, 1] + g2[:, 2]))),
              "(0+2)+1": int(torch.sum(lb != (g2[:, 0] + g2[:, 2]) + g2[:, 1]))}
    print(json.dumps({"sum_order_mismatches": orders, "of": g.shape[0]}), flush=True)

    def run(mod, case):
        _, q, qm, db, dbm, k, gate = case
        return lambda: mod.knn_cuda(q, qm, db, dbm, k=k, prune_beyond=gate)

    # every whole-call time before any profiling: torch.profiler leaves the
    # host slower for the rest of the process
    order = (ref, new, new, ref)
    t = [[cuda_ms(run(m, case), args.reps) for m in order] for case in main_cases]
    dev_t = [[device_ms(run(m, case), args.reps) for m in order] for case in main_cases]
    for case, tc, dc in zip(main_cases, t, dev_t):
        rec = {"case": case[0], "other_ms": [tc[0], tc[3]], "this_ms": [tc[1], tc[2]],
               "speedup": (tc[0] + tc[3]) / (tc[1] + tc[2]),
               "other_device_ms": [dc[0], dc[3]], "this_device_ms": [dc[1], dc[2]]}
        print(json.dumps(rec), flush=True)
    summary = {"device": smi, "cases": len(cases),
               "differing_cases": n_bad, "unmasked_rows_compared": n_rows,
               "sum_order_mismatches": orders, "ok": n_bad == 0}
    print(json.dumps(summary), flush=True)
    if n_bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
