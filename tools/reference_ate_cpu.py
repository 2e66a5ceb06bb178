"""Accuracy reference for the PyTorch port: the JAX package's LioPipeline,
indoor profile, float32, on the CPU, over the sequence ``chip_smoke.py``
drives the port with (90 simulated sweeps, ``cli simulate`` defaults:
azimuth 900, pitch_amp 0.4, roll_amp 0.35, rp_freq 0.45, IMU 200 Hz; each
sweep paired with its own IMU interval as tests/test_lio_pipeline.py does).

Prints one JSON line: the stage at the end, the sweep at which the
pipeline went INITED, and ATE/RPE from ``io.evaluation``.

Usage: JAX_PLATFORMS=cpu python tools/reference_ate_cpu.py [--sweeps 90]
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lio_mapping_tpu.config import LioConfig  # noqa: E402
from lio_mapping_tpu.io import evaluation, synthetic  # noqa: E402
from lio_mapping_tpu.models.pipeline import LioPipeline  # noqa: E402

SCAN_DT = 0.1
IMU_RATE = 200.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=90)
    args = ap.parse_args()

    traj = synthetic.Trajectory(pitch_amp=0.4, roll_amp=0.35, rp_freq=0.45)
    pipe = LioPipeline(LioConfig.indoor(), dtype=jnp.float32)
    qs, ps, times, stages = [], [], [], []
    t_run = time.perf_counter()
    for i in range(args.sweeps):
        t0 = i * SCAN_DT
        xyz, mask = synthetic.simulate_sweep(traj, t0, n_azimuth=900)
        ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t0 + SCAN_DT, IMU_RATE)
        a0, w0 = traj.imu(t0)
        dts = np.diff(np.concatenate([[t0], ts]))
        out = pipe.process(xyz, mask, pipe.make_samples(dts, acc, gyr, a0, w0))
        qs.append(np.asarray(out["laser_pose"].q, np.float64))
        ps.append(np.asarray(out["laser_pose"].t, np.float64))
        times.append(t0 + SCAN_DT)
        stages.append(out["stage"])
    gt = [synthetic.gt_sensor_pose(traj, t) for t in times]
    m = evaluation.evaluate_trajectory(np.stack(qs), np.stack(ps), np.stack([g[0] for g in gt]),
                                       np.stack([g[1] for g in gt]))
    print(json.dumps({
        "package": "lio_mapping_tpu", "platform": "cpu", "dtype": "float32",
        "profile": "indoor", "sweeps": args.sweeps, "stage": pipe.stage,
        "inited_at_sweep": stages.index("INITED") if "INITED" in stages else None,
        "ate_rmse_m": m.ate_rmse, "rpe_trans_rmse_m": m.rpe_trans_rmse,
        "n_poses": m.n_poses, "run_s": time.perf_counter() - t_run,
    }))


if __name__ == "__main__":
    main()
