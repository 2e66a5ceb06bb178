"""A/B the estimator's accuracy/cost flags on the flagship synthetic indoor
sequence (counterpart of the JAX package's ``tools/ab_flags.py``).

The two knobs that trade accuracy for per-sweep compute:

* ``keep_features``: accumulate association rows across the newest-frame
  mini-GN rounds (Estimator.cc:978 semantics; the indoor yaml enables it).
* ``newest_refine_iters``: the mini-GN round budget itself
  (num_max_iterations_, Estimator.cc:1561): each round is one serial KNN +
  fit association pass.

Each variant runs in its OWN subprocess (``-m``, the same ``--device``) over
the SAME sequence (the ``cli simulate`` trajectory: pitch 0.4, roll 0.35,
rp_freq 0.45), which this process simulates once before the variants start
and hands them as an npz file, so the ray caster never sits inside a timed
loop. Each reports timestamp-matched ATE (RMSE and max), the INITED poses,
the steady frames/s after the first INITED pose (synchronised at both
ends) and the CUDA KNN kernel's searches; the results go, as one JSON
object, to the last line (and to ``--out`` when given).

Usage: python -m lio_mapping_tpu_torch.tools.ab_flags [--sweeps 90]
       [--out AB_FLAGS.json] [--device cuda|cpu]
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

from . import add_device_arg, device_label, last_json, resolve_device, run_module

VARIANTS = {
    "indoor_default": {},  # keep_features=True, newest_refine_iters=10
    "no_keep_features": {"keep_features": False},
    "refine_iters_2": {"newest_refine_iters": 2},
    "no_keep_refine_2": {"keep_features": False, "newest_refine_iters": 2},
}
IMU_RATE = 200.0


def trajectory(g_norm: float):
    from ..io import synthetic

    # the flagship sequence (cli simulate defaults): pitch/roll excitation so
    # the from-scratch extrinsic calibration accepts
    return synthetic.Trajectory(pitch_amp=0.4, roll_amp=0.35, rp_freq=0.45, g_norm=g_norm)


def variant_cfg(name: str):
    from ..config import LioConfig

    base = LioConfig.indoor()
    return dataclasses.replace(
        base, estimator=dataclasses.replace(base.estimator, **VARIANTS[name]))


def simulate(path: str, sweeps: int, cfg):
    """The sequence as an npz: per sweep its points, mask and IMU interval
    (sweep i starts at i scan periods)."""
    from ..io import synthetic

    traj = trajectory(cfg.estimator.imu.g_norm)
    dt = cfg.sensor.scan_period
    arrays = {}
    for i in range(sweeps):
        t0 = i * dt
        xyz, mask = synthetic.simulate_sweep(traj, t0, n_azimuth=900)
        ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t0 + dt, IMU_RATE)
        a0, w0 = traj.imu(t0)
        dts = np.diff(np.concatenate([[t0], ts]))
        for key, a in (("xyz", xyz), ("mask", mask), ("dts", dts), ("acc", acc), ("gyr", gyr),
                       ("a0", a0), ("w0", w0)):
            arrays[f"{key}{i}"] = a
    np.savez(path, **arrays)


def run_variant(name: str, sweeps: int, frames_path: str, device) -> dict:
    from ..io import synthetic
    from ..io.evaluation import evaluate_trajectory
    from ..models.pipeline import LioPipeline
    from ..ops import knn_kernel
    from ..utils.timing import synchronize

    cfg = variant_cfg(name)
    traj = trajectory(cfg.estimator.imu.g_norm)
    pipe = LioPipeline(cfg, device=device, dtype=torch.float32)
    dt = cfg.sensor.scan_period
    with np.load(frames_path) as z:
        frames = [(i * dt, z[f"xyz{i}"], z[f"mask{i}"],
                   tuple(z[f"{k}{i}"] for k in ("dts", "acc", "gyr", "a0", "w0")))
                  for i in range(sweeps)]

    knn0 = knn_kernel.launches()
    est, gt = [], []
    t_steady = None
    n_steady = 0
    for t0, xyz, mask, imu in frames:
        out = pipe.process(xyz, mask, pipe.make_samples(*imu))
        pose = out.get("laser_pose")
        if pose is None:
            continue
        if out["stage"] == "INITED":
            if t_steady is None:
                synchronize(device)
                t_steady = time.perf_counter()
            else:
                n_steady += 1
            est.append((pose.q.detach().cpu().numpy(), pose.t.detach().cpu().numpy()))
            gt.append(synthetic.gt_sensor_pose(traj, t0 + dt))
    if not est or pipe.stage != "INITED":
        return {"variant": name, "error": "init failed", "device": device_label(device)}
    synchronize(device)
    elapsed = time.perf_counter() - t_steady

    m = evaluate_trajectory(np.stack([e[0] for e in est]), np.stack([e[1] for e in est]),
                            np.stack([g[0] for g in gt]), np.stack([g[1] for g in gt]))
    return {
        "variant": name,
        "overrides": VARIANTS[name],
        "ate_rmse_m": round(float(m.ate_rmse), 4),
        "ate_max_m": round(float(m.ate_max), 4),
        "n_inited_poses": len(est),
        "fps": round(n_steady / elapsed, 2) if elapsed > 0 else None,
        "device": device_label(device),
        "knn_launches": knn_kernel.launches() - knn0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=90)
    ap.add_argument("--out", default=None, help="also write the results JSON here")
    add_device_arg(ap)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--frames", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.variant:
        print(json.dumps(run_variant(args.variant, args.sweeps, args.frames, device)))
        return 0

    results = []
    with tempfile.TemporaryDirectory() as td:
        frames = os.path.join(td, "frames.npz")
        simulate(frames, args.sweeps, variant_cfg("indoor_default"))
        for name in VARIANTS:
            proc = run_module("lio_mapping_tpu_torch.tools.ab_flags", "--variant", name,
                              "--sweeps", args.sweeps, "--frames", frames,
                              "--device", args.device, check=False)
            res = last_json(proc.stdout) or {"variant": name,
                                             "error": (proc.stderr or proc.stdout)[-400:]}
            results.append(res)
            print(json.dumps(res), flush=True)
    report = {"sweeps": args.sweeps, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    print(json.dumps(report))
    return 0 if all("error" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
