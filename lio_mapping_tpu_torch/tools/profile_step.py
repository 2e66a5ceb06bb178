"""Stage-level timing + FLOP accounting of the estimator step (counterpart
of the JAX package's ``tools/profile_step.py``).

Times each major stage of the per-sweep step as a separate call over the
bench config's shapes (``tools/bench.build_cfg``), each timed with a
synchronise around its loop, and costs each with the port's cost counter
(``utils/profiling.CostCounter``, in place of XLA's
``compiled.cost_analysis()``), so achieved TF/s and arithmetic intensity
are measured numbers. Flops of a matmul follow ``torch.utils.flop_counter``
(2mkn, as XLA counts a dot), every other compute op counts one flop per
output element, and views, copies, ``linalg`` and custom ops count 0 (XLA
counts its custom calls 0 too). Bytes are each op's input plus output
tensor bytes: eager PyTorch fuses nothing, so this is what the ops move,
where XLA's ``bytes accessed`` counts a fusion once.

On the card the KNN row runs the CUDA kernel, which the counter does not
see: the KNN row, ``calculate_features`` and ``calculate_laser_odom`` add
the same analytic flops as the JAX tool (``C*M*9``: the distance products
and assembly). On the CPU the plain version's ops are counted as well, as
XLA counts the JAX tool's plain fallback on the CPU. Each row records the
kernel's launches in one call (``knn_launches``), the aggregate those of the
whole run.

Usage: python -m lio_mapping_tpu_torch.tools.profile_step
       [--profile indoor|outdoor_64] [--json PROFILE_STEP.json] [--device cuda|cpu]
"""

import argparse
import json
import sys

import numpy as np
import torch

from . import add_device_arg, device_label, resolve_device

def measure(results, name, fn, *args, device, n=20, mult=1.0, analytic_flops=None):
    """Time + cost one stage and append its row to ``results``; ``mult``
    scales per-sweep occurrence (e.g. calculate_features runs once per
    non-pivot opt frame).

    ``analytic_flops``: hand-counted flops for work the counter cannot see
    (the CUDA KNN kernel)."""
    from ..ops import knn_kernel
    from ..utils.profiling import CostCounter, timed

    knn0 = knn_kernel.launches()
    with CostCounter() as counter:
        fn(*args)
    launches = knn_kernel.launches() - knn0
    flops, byt = float(counter.flops) or None, float(counter.bytes) or None
    if analytic_flops:
        flops = (flops or 0.0) + analytic_flops
    t_ms = timed(lambda: fn(*args), device, reps=n)[0]
    row = {"stage": name, "ms": round(t_ms, 3), "per_sweep_mult": mult,
           "knn_launches": launches}
    if analytic_flops:
        row["analytic_gflop"] = round(analytic_flops / 1e9, 3)
    if flops:
        row["gflop"] = round(flops / 1e9, 3)
        row["tflops_per_s"] = round(flops / (t_ms * 1e-3) / 1e12, 3)
    if byt:
        row["gbytes"] = round(byt / 1e9, 3)
        row["gbytes_per_s"] = round(byt / (t_ms * 1e-3) / 1e9, 1)
        if flops:
            row["flops_per_byte"] = round(flops / byt, 2)
    results.append(row)
    extra = ""
    if flops:
        extra = (f"  {row['gflop']} GF -> {row['tflops_per_s']} TF/s"
                 + (f", {row.get('flops_per_byte', '?')} F/B" if byt else ""))
    print(f"{name}: {t_ms:.2f} ms{extra}", flush=True)
    return t_ms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="indoor", choices=["indoor", "outdoor_64"])
    ap.add_argument("--json", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..models import estimator as E
    from ..ops import knn as KNN
    from ..ops import knn_kernel
    from ..ops import marginalization as MG
    from ..ops import preintegration as PI
    from ..ops import solver as SV
    from ..ops import voxel as VX
    from ..utils.tree import tree_map
    from .bench import build_cfg

    results = []
    cfg = build_cfg(args.profile)
    e = cfg.estimator
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)

    def arr(a):
        return torch.as_tensor(a, **f32)

    C = e.surf_stack_cap
    M = e.local_map_filtered_cap
    s_opt = e.opt_window_size

    stack = arr(rng.normal(size=(C, 3)) * 5)
    smask = torch.ones((C,), dtype=torch.bool, device=dev)
    mapc = arr(rng.normal(size=(M, 3)) * 5)
    mmask = torch.ones((M,), dtype=torch.bool, device=dev)
    lq = arr([0.0, 0.0, 0.0, 1.0])
    lt = torch.zeros((3,), **f32)

    knn_flops = C * M * (2 * 3 + 3)  # distance products + assembly
    measure(results, f"knn ({C}x{M}, k=5)", lambda a, b, c, d: KNN.knn(a, b, c, d, k=5),
            stack, smask, mapc, mmask, device=dev, analytic_flops=knn_flops)

    measure(results, "calculate_features",
            lambda mx, mm, sx, sm, q, t: E._calculate_features(
                E.make_knn5(mx, mm, cfg), sx, sm, q, t, cfg),
            mapc, mmask, stack, smask, lq, lt, device=dev, mult=float(s_opt - 1),
            analytic_flops=knn_flops)

    # analytic knn flops counted for ONE GN round: the 0.05deg/0.05cm early
    # abort makes the executed rounds data-dependent (random inputs converge
    # in round 1; real sweeps run 2-4 of the <=10 budget)
    measure(results, "calculate_laser_odom (1 of <=10 GN iters counted)",
            lambda mx, mm, sx, sm, q, t: E._calculate_laser_odom(
                (E.make_knn5(mx, mm, cfg),), (sx, sm), q, t, cfg),
            mapc, mmask, stack, smask, lq, lt, device=dev, analytic_flops=float(knn_flops))

    w = e.window_size
    merged = arr(rng.normal(size=(w * C, 3)) * 5)
    mergedm = torch.ones((w * C,), dtype=torch.bool, device=dev)
    measure(results, f"voxel_downsample {w*C}->{M}",
            lambda a, b: VX.voxel_downsample(a, b, e.surf_filter_size, M),
            merged, mergedm, device=dev)
    measure(results, f"voxel_downsample {C}->{C} (stack)",
            lambda a, b: VX.voxel_downsample(a, b, e.surf_filter_size, C),
            stack, smask, device=dev)

    # window solve with realistic factor counts
    S = s_opt
    qs = lq.repeat(S + 1, 1)
    ps = arr(rng.normal(size=(S + 1, 3)))
    sb = arr(rng.normal(size=(S + 1, 9)) * 0.1)
    x0 = SV.OptStates(q=qs, p=ps, sb=sb, ex_q=lq, ex_p=lt)
    imu = PI.ImuSamples.empty(64, **f32)
    imu.dt[:20] = 0.005
    imu.acc[:, 2] = 9.805
    noise18 = PI.noise_matrix(0.2, 0.02, 2e-4, 2e-5, **f32)
    zeros3 = torch.zeros(3, **f32)
    pre1 = PI.integrate(imu, zeros3, zeros3, noise18)
    pres = tree_map(lambda a: torch.stack([a] * S), pre1)
    planes = SV.PlaneFactors(
        point=arr(rng.normal(size=(S, C, 3)) * 5),
        coeff=arr(rng.normal(size=(S, C, 4)) * 0.2),
        mask=torch.ones((S, C), dtype=torch.bool, device=dev))
    prior = MG.PriorState.empty(S, **f32)
    g_vec = arr([0.0, 0.0, 9.805])
    no = torch.tensor(False, device=dev)
    yes = torch.tensor(True, device=dev)

    measure(results, f"solve_window ({e.max_solver_iterations} LM iters, {S}x{C})",
            lambda x, pr, pl, pri: SV.solve_window(
                x, pr, g_vec, pl, pri, None, s=S, max_iterations=e.max_solver_iterations,
                cauchy_scale=e.cauchy_loss_scale, opt_extrinsic=no, use_marg=yes),
            x0, pres, planes, prior, device=dev)

    measure(results, "marginalize_pivot",
            lambda x, pr, pl, pri: SV.marginalize_pivot(
                x, tree_map(lambda a: a[0], pr), g_vec, pl, pri, s=S,
                cauchy_scale=e.cauchy_loss_scale),
            x0, pres, planes, prior, device=dev)

    measure(results, "preintegration (64 samples)",
            lambda s_, a, b: PI.integrate(s_, a, b, noise18),
            imu, zeros3, zeros3, device=dev)

    total_ms = sum(r["ms"] * r["per_sweep_mult"] for r in results
                   if not r["stage"].startswith("knn "))
    total_gf = sum(r.get("gflop", 0.0) * r["per_sweep_mult"] for r in results
                   if not r["stage"].startswith("knn "))
    agg = {
        "profile": args.profile,
        "device": device_label(dev),
        "path": "eager (graphs=False): each stage called alone",
        "knn_launches": knn_kernel.launches(),
        "sum_stage_ms": round(total_ms, 2),
        "sum_stage_gflop": round(total_gf, 2),
        "aggregate_tflops_per_s": round(total_gf / total_ms, 3) if total_ms else None,
        "note": ("stages called one at a time in eager PyTorch, each synchronised; the "
                 "per-sweep step runs the same ops, so sum_stage_ms approximates it. knn row "
                 "excluded from totals (it is a sub-part of calculate_features). Flops: "
                 "matmuls by torch.utils.flop_counter, one per output element for other "
                 "compute ops, 0 for views, copies, linalg and custom ops (XLA counts custom "
                 "calls 0 too), plus the analytic KNN flops; bytes: each op's input plus "
                 "output tensors (eager fuses nothing)."),
    }
    print(f"sum of per-sweep stages: {total_ms:.1f} ms, {total_gf:.1f} GF "
          f"-> {agg['aggregate_tflops_per_s']} TF/s aggregate")

    report = {"stages": results, "aggregate": agg}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
