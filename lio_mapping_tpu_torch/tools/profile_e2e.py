"""Split the bench's per-sweep time into its two device programs
(counterpart of the JAX package's ``tools/profile_e2e.py``): times
``process_sweep`` and the estimator step alone, on inputs already on the
device (the bench config), 20 calls each after 3 warm-up calls, each call
synchronised.

The JAX tool steps a random 16 x 900-point sweep from the estimator's zero
initial state; there the marginalization's eigendecomposition is
degenerate, which XLA turns into NaNs and ``torch.linalg.eigh`` refuses.
Here the step starts from a window fabricated from ground truth
(``io/synthetic.synthetic_estimator_state``) and takes the next simulated
sweep: the same work per call, on a state the step can solve.

Usage: python -m lio_mapping_tpu_torch.tools.profile_e2e [--device cuda|cpu]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import add_device_arg, device_label, resolve_device


def timeit(fn, device, n=20, warmup=3):
    from ..utils.timing import synchronize

    for _ in range(warmup):
        fn()
        synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        synchronize(device)
    return (time.perf_counter() - t0) / n * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..io import synthetic
    from ..models import estimator as EST
    from ..models.point_processor import process_sweep
    from ..ops import knn_kernel
    from ..ops import preintegration as PI
    from .bench import build_cfg

    cfg = build_cfg()
    traj = synthetic.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    state, t_next = synthetic.synthetic_estimator_state(cfg, traj, torch.float32, dev)
    dt = cfg.sensor.scan_period
    t0 = t_next - dt  # the sweep over (t_next - dt, t_next], as tests/test_torch_pipeline
    xyz_np, mask_np = synthetic.simulate_sweep(traj, t0, n_azimuth=900)
    xyz = torch.as_tensor(xyz_np[:, :3], dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask_np, device=dev)

    t_feat = timeit(lambda: process_sweep(xyz, mask, cfg), dev)
    print(f"process_sweep: {t_feat:.2f} ms")

    feats = process_sweep(xyz, mask, cfg)
    ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t0 + dt, 200.0)
    a0, w0 = traj.imu(t0)
    packed = PI.pack_samples_np(np.diff(np.concatenate([[t0], ts])), acc, gyr, a0, w0,
                                cfg.estimator.imu.max_imu_per_frame)
    samples = PI.unpack_samples(torch.as_tensor(packed, dtype=torch.float32, device=dev))

    # steady-state timing on a fixed state (the state evolves in real use, but
    # the work per call is the same)
    t_step = timeit(lambda: EST.lio_step_impl(state, feats.surf_less_flat, samples, cfg), dev)
    print(f"lio_step (device-resident inputs): {t_step:.2f} ms")
    print(f"sum: {t_feat + t_step:.2f} ms")
    print(json.dumps({"device": device_label(dev), "path": "eager",
                      "process_sweep_ms": round(t_feat, 3),
                      "lio_step_ms": round(t_step, 3), "sum_ms": round(t_feat + t_step, 3),
                      "knn_launches": knn_kernel.launches()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
