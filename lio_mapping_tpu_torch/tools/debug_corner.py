"""Isolate which flag (use_corner / fix_map) degrades closed-loop ATE
(counterpart of the JAX package's ``tools/debug_corner.py``).

16 sweeps at 540 azimuth steps of the default synthetic trajectory through
``LioPipeline`` in float64 on a small config (window 5/3, 2048-row surf
stacks, an 8192-row local map; 1024-row corner stacks and a 4096-row corner
map), in each of four modes: ``default``, ``fixmap``, ``corner``, ``both``
(``all`` runs the four). Each prints the JAX tool's line: the RMSE over the
INITED sweeps of the position error relative to the first INITED pose, and
each sweep's error. The last line is a JSON object with the device, each
mode's RMSE and errors, and the CUDA KNN kernel's searches.

Usage: python -m lio_mapping_tpu_torch.tools.debug_corner
       [all|default|fixmap|corner|both] [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from . import add_device_arg, device_label, resolve_device

MODES = {"default": (False, False), "fixmap": (False, True), "corner": (True, False),
         "both": (True, True)}


def small_cfg():
    from ..config import LioConfig

    base = LioConfig.indoor()
    est = dataclasses.replace(
        base.estimator, window_size=5, opt_window_size=3, init_window_factor=1,
        estimate_extrinsic=0, opt_extrinsic=False,
        extrinsic_rotation=(1, 0, 0, 0, 1, 0, 0, 0, 1),
        extrinsic_translation=(0.0, 0.0, 0.0),
        surf_stack_cap=2048, local_map_filtered_cap=8192,
        features_per_frame_cap=2048, max_solver_iterations=8)
    return dataclasses.replace(base, estimator=est)


def sweep_errors(poses, gts):
    """Each INITED sweep's position error relative to the first INITED pose:
    ``poses`` and ``gts`` are lists of (q wxyz, p) host arrays."""
    q0e, p0e = poses[0]
    q0g, p0g = gts[0]
    r0e = Rotation.from_quat(np.roll(np.asarray(q0e), -1))
    r0g = Rotation.from_quat(np.roll(np.asarray(q0g), -1))
    return [float(np.linalg.norm(r0e.inv().apply(pe - p0e) - r0g.inv().apply(pg - p0g)))
            for (_, pe), (_, pg) in zip(poses, gts)]


def run(use_corner: bool, fix_map: bool, device=None):
    """(rmse, per-sweep errors) of one mode, and prints the JAX tool's line;
    ``device`` None means the card."""
    from ..io import synthetic
    from ..models.pipeline import LioPipeline

    cfg = small_cfg()
    cfg = dataclasses.replace(cfg, estimator=dataclasses.replace(
        cfg.estimator, use_corner=use_corner, fix_map=fix_map,
        corner_stack_cap=1024, local_map_corner_cap=4096))
    traj = synthetic.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    pipe = LioPipeline(cfg, device=device, dtype=torch.float64)
    dt = cfg.sensor.scan_period
    est, gt = [], []
    for i in range(16):
        t0 = i * dt
        xyz, mask = synthetic.simulate_sweep(traj, t0, n_azimuth=540)
        ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t0 + dt, 200.0)
        a0, w0 = traj.imu(t0)
        dts = np.diff(np.concatenate([[t0], ts]))
        out = pipe.process(xyz, mask, pipe.make_samples(dts, acc, gyr, a0, w0))
        if out["stage"] != "INITED" or "body_pose" not in out:
            continue
        pose = out["laser_pose"]
        est.append((pose.q.detach().cpu().numpy(), pose.t.detach().cpu().numpy()))
        gt.append(synthetic.gt_sensor_pose(traj, t0 + dt))
    errs = sweep_errors(est, gt)
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    print(f"use_corner={use_corner} fix_map={fix_map}: RMSE={rmse:.4f} "
          f"errs={[f'{e:.3f}' for e in errs]}", flush=True)
    return rmse, errs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="all", choices=["all", *MODES])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from ..ops import knn_kernel

    knn0 = knn_kernel.launches()
    result = {"device": device_label(device), "rmse": {}, "errs": {}}
    for mode, flags in MODES.items():
        if args.mode in ("all", mode):
            result["rmse"][mode], result["errs"][mode] = run(*flags, device=device)
    result["knn_launches"] = knn_kernel.launches() - knn0
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
