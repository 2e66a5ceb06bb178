"""Scaling benchmark of the distributed window-BA step (counterpart of the
JAX package's ``tools/bench_scaling.py``; BASELINE config 5).

Runs ``parallel/distributed.make_distributed_step`` (association + sharded
BA + sharded marginalization) at a FIXED total problem size over meshes of
1, 2, 4, ... ranks, each mesh its own ``multihost.launch`` of spawned
processes, and reports the per-step wall time (a warm-up step, then
``--iters`` steps synchronised at the end, on rank 0) and the scaling
efficiency. Every rank builds the same seeded inputs and the step cuts its
shard of the stacks' feature axis.

The backend follows the port's rule (``multihost.choose_backend``): gloo on
the CPU and whenever ranks share a card, nccl with a card per rank. By
default the meshes go up to one rank per card (on the CPU: one rank);
``--virtual N`` runs up to N ranks sharing the card or the CPU, which
validates the collective structure, NOT a speed-up (the ranks share one
device and the host's cores). ``--processes N`` reports the 1-rank step and
the N-rank step (ranks sharing cards when there are fewer than N). ``mode``
and ``note`` say what was shared. The last line is the report as JSON.

Usage: python -m lio_mapping_tpu_torch.tools.bench_scaling [--virtual N]
       [--processes N] [--features-total 32768] [--map-points 16384]
       [--iters 20] [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import add_device_arg, device_label, resolve_device


def scaling_cfg():
    from ..config import LioConfig

    base = LioConfig.indoor()
    return dataclasses.replace(base, estimator=dataclasses.replace(
        base.estimator, window_size=12, opt_window_size=7, max_solver_iterations=8))


def make_inputs(cfg, features_total: int, map_points: int, device, dtype=torch.float32):
    """The fixed-size inputs of the JAX tool (seed 0), on ``device``: (x0,
    pres, g_vec, map_xyz, map_mask, stacks_xyz, stacks_mask, rel_q, rel_t,
    prior)."""
    from ..ops import marginalization as MG
    from ..ops import preintegration as PI
    from ..ops import solver as SV
    from ..utils import quaternion as quat
    from ..utils.tree import tree_map

    s = cfg.estimator.opt_window_size
    rng = np.random.default_rng(0)
    z = dict(dtype=dtype, device=device)

    def arr(a):
        return torch.as_tensor(a, **z)

    x0 = SV.OptStates(q=quat.identity(dtype, device).repeat(s + 1, 1),
                      p=arr(rng.normal(0, 0.05, (s + 1, 3))),
                      sb=torch.zeros((s + 1, 9), **z),
                      ex_q=quat.identity(dtype, device), ex_p=torch.zeros(3, **z))
    pre = PI.Preintegration.identity(dtype, device)._replace(
        covariance=torch.eye(15, **z) * 1e-4, sum_dt=torch.tensor(0.1, **z))
    pres = tree_map(lambda a: a.expand((s,) + a.shape).clone(), pre)
    g_vec = arr([0.0, 0.0, -9.805])
    map_xyz = arr(rng.uniform(-8, 8, (map_points, 3)))
    map_mask = torch.ones((map_points,), dtype=torch.bool, device=device)
    stacks_xyz = arr(rng.uniform(-8, 8, (s, features_total, 3)))
    stacks_mask = torch.ones((s, features_total), dtype=torch.bool, device=device)
    rel_q = quat.identity(dtype, device).repeat(s + 1, 1)
    rel_t = arr(rng.normal(0, 0.05, (s + 1, 3)))
    prior = MG.PriorState.empty(s, dtype, device)
    return (x0, pres, g_vec, map_xyz, map_mask, stacks_xyz, stacks_mask, rel_q, rel_t, prior)


def _rank(rank, world, address, opts, out_dir):
    """One rank: join the mesh, time the step, and on rank 0 write the
    per-step ms, the step's outputs and the kernel's searches (warm-up step
    included)."""
    from ..ops import knn_kernel
    from ..parallel import distributed as DIST
    from ..parallel import multihost as MH
    from ..utils.timing import synchronize

    if opts["device"] == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = MH.initialize(address, world, rank, device=opts["device"])
    try:
        cfg = scaling_cfg()
        inputs = make_inputs(cfg, opts["features_total"], opts["map_points"], mesh.device,
                             getattr(torch, opts["dtype"]))
        step = DIST.make_distributed_step(mesh, cfg)
        out = step(*inputs)
        synchronize(mesh.device)
        t0 = time.perf_counter()
        for _ in range(opts["iters"]):
            out = step(*inputs)
        synchronize(mesh.device)
        ms = (time.perf_counter() - t0) / opts["iters"] * 1e3
        if rank == 0:
            x_opt, _, cost = out
            np.savez(os.path.join(out_dir, f"ranks{world}.npz"), ms=ms,
                     q=x_opt.q.cpu().numpy(), p=x_opt.p.cpu().numpy(),
                     sb=x_opt.sb.cpu().numpy(), cost=cost.cpu().numpy(),
                     knn_launches=knn_kernel.launches(),
                     backend=mesh.backend, device=str(mesh.device))
    finally:
        MH.shutdown()
    return 0


def run_mesh(world: int, opts: dict) -> dict:
    """The step on ``world`` spawned ranks: rank 0's record (``ms``, ``q``,
    ``p``, ``sb``, ``cost``, ``knn_launches``, ``backend``, ``device``)."""
    from ..parallel import multihost as MH

    with tempfile.TemporaryDirectory() as td:
        rc = MH.launch(world, _rank, opts, td)
        if rc != 0:
            sys.exit(f"error: the {world}-rank step exited {rc}")
        with np.load(os.path.join(td, f"ranks{world}.npz")) as z:
            return {k: z[k].item() if z[k].ndim == 0 else z[k] for k in z.files}


def make_report(runs: dict, dev, n_cards: int, features_total: int, processes: int) -> dict:
    """The JAX tool's report of ``run_mesh`` records by rank count."""
    base_ms = runs[1]["ms"]
    steps = [{"n_devices": n, "ms_per_step": round(r["ms"], 3),
              "speedup": round(base_ms / r["ms"], 3),
              "efficiency": round(base_ms / r["ms"] / n, 3),
              "backend": r["backend"], "knn_launches": r["knn_launches"]}
             for n, r in runs.items()]
    shared = max(runs) > max(n_cards, 1)
    report = {
        "mode": (f"multiprocess-{dev.type} ({processes} procs)" if processes
                 else f"virtual-{dev.type}" if shared else dev.type),
        "devices": n_cards if dev.type == "cuda" else 1,
        "features_total": features_total,
        "steps": steps,
        "device": device_label(dev),
    }
    if processes:
        report["processes"] = processes
    if shared:
        where = "the card" if dev.type == "cuda" else "the CPU"
        report["note"] = (f"up to {max(runs)} ranks share {where} and the host's cores: "
                          "validates the collective structure, NOT speedup")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="up to N ranks sharing the card (or the CPU)")
    ap.add_argument("--features-total", type=int, default=32768,
                    help="total plane-feature rows per frame (fixed work)")
    ap.add_argument("--map-points", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--processes", type=int, default=0,
                    help="report the 1-rank step and the N-rank step")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    opts = {"device": dev.type, "features_total": args.features_total,
            "map_points": args.map_points, "iters": args.iters, "dtype": "float32"}
    if args.processes:
        counts = [1, args.processes]
    else:
        limit = args.virtual or max(n_cards, 1)
        counts = [n for n in (2 ** i for i in range(limit.bit_length()))
                  if n <= limit and args.features_total % n == 0]
    runs = {n: run_mesh(n, opts) for n in counts}

    report = make_report(runs, dev, n_cards, args.features_total, args.processes)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
