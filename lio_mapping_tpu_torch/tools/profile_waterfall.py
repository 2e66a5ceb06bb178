"""Cumulative stage waterfall of the estimator step on real inputs
(counterpart of the JAX package's ``tools/profile_waterfall.py``).

Sets ``models/estimator._TRUNCATE_STAGE`` to each checkpoint ("window",
"map", "assoc", "gates", "solve", then None for the full step) and times
the step: in eager PyTorch a truncated step simply stops after that stage,
so each time is the exact cumulative cost of the step's prefix and each
difference the cost of one stage, with no dead-code elimination involved.

Inputs are steady-state: the pipeline (the bench config) runs the
synthetic sequence until INITED and a consumed sweep after it; that
sweep's pre-step state, surf cloud and IMU samples feed the truncated
steps. The last line is a JSON object with each stage's cumulative and
delta ms.

Usage: python -m lio_mapping_tpu_torch.tools.profile_waterfall
       [indoor|outdoor_64] [--reps 30] [--device cuda|cpu]
"""

import argparse
import json
import sys

import numpy as np
import torch

from . import add_device_arg, device_label, resolve_device

STAGES = ["window", "map", "assoc", "gates", "solve", None]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("profile", nargs="?", default="indoor", choices=["indoor", "outdoor_64"])
    ap.add_argument("--reps", type=int, default=30, help="timed calls per prefix (5 warm-up)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..io import synthetic
    from ..models import estimator as EST
    from ..models.pipeline import LioPipeline
    from ..ops import knn_kernel
    from ..ops import preintegration as PI
    from ..utils.profiling import timed
    from .bench import build_cfg

    cfg = build_cfg(args.profile)
    traj = synthetic.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    # eager: the truncation hook cuts the eager step, and the captured state
    # must not be a graph's static buffer that the next sweep overwrites
    pipe = LioPipeline(cfg, device=dev, dtype=torch.float32, graphs=False)
    dt = cfg.sensor.scan_period

    state_cap = {}
    for i in range(6 * cfg.estimator.window_size + 24):
        if "state" in state_cap and "surf" in state_cap:
            break
        t0 = i * dt
        xyz, mask = synthetic.simulate_sweep(
            traj, t0, n_azimuth=900, n_rings=cfg.sensor.n_rings,
            lower_deg=cfg.sensor.lower_bound_deg, upper_deg=cfg.sensor.upper_bound_deg)
        ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t0 + dt, 200.0)
        a0, w0 = traj.imu(t0)
        dts = np.diff(np.concatenate([[t0], ts]))
        samples = pipe.make_samples(dts, acc, gyr, a0, w0)
        # capture the pre-step state once INITED
        if pipe.stage == "INITED":
            state_cap = {"state": pipe.est_state, "samples": samples}
        out = pipe.process(xyz, mask, samples)
        if pipe.stage == "INITED" and "surf_cloud" in out:
            state_cap["surf"] = out["surf_cloud"]
    if pipe.stage != "INITED":
        sys.exit("error: the pipeline did not initialize")

    st, surf = state_cap["state"], state_cap["surf"]
    samples = PI.unpack_samples(torch.as_tensor(state_cap["samples"], dtype=torch.float32,
                                                device=dev))
    print(f"profile={args.profile}  (cumulative | delta)")
    print("eager PyTorch (graphs=False): a truncated step stops after its stage, so "
          "cumulative is exact (no dead-code elimination involved)")
    rows, prev = [], 0.0
    knn0 = knn_kernel.launches()
    try:
        for stage in STAGES:
            EST._TRUNCATE_STAGE = stage
            t = timed(lambda: EST.lio_step_impl(st, surf, samples, cfg), dev,
                      reps=args.reps, warmup=5)[0]
            name = stage or "full"
            print(f"{name:8s} {t:7.2f} ms | +{t - prev:.2f}", flush=True)
            rows.append({"stage": name, "cumulative_ms": round(t, 3),
                         "delta_ms": round(t - prev, 3)})
            prev = t
    finally:
        EST._TRUNCATE_STAGE = None
    print(json.dumps({"profile": args.profile, "device": device_label(dev), "path": "eager",
                      "reps": args.reps, "stages": rows,
                      "knn_launches": knn_kernel.launches() - knn0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
