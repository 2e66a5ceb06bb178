"""Accuracy references for the PyTorch port: the JAX package on the CPU in
float32, on exactly the sequences ``chip_smoke.py`` drives the port with.

In-process (``LioPipeline``, each sweep paired with its own IMU interval as
tests/test_lio_pipeline.py does, IMU 200 Hz, azimuth 900):

* ``--profile indoor`` (default): 90 sweeps of the ``cli simulate``
  defaults (pitch_amp 0.4, roll_amp 0.35, rp_freq 0.45); ``--use-corner``
  and ``--fix-map`` turn on the estimator variants at the shipped corner
  capacities.
* ``--profile outdoor_64``: 60 sweeps of ``bench.py``'s sequence (its
  analytic trajectory, 64 rings at the HDL-64 angles) with its two
  synthetic-rig concessions, identity ``extrinsic_rotation`` and zero
  ``extrinsic_translation``.

Through the JAX package's CLI (``simulate``, ``run``, then the ATE of
``evaluate``), in a temporary directory:

* ``--cli-4d``: ``run --profile indoor --enable-4d --out-4d`` on the
  90-sweep ``simulate`` log; the ATE of the LIO and of the 4D trajectory.
* ``--cli-outdoor``: ``simulate --extrinsic-translation -2.4 0 0.7`` (the
  KAIST rig offset), then ``run --profile outdoor``.
* ``--cli-bag``: the ROS bag round trip of the 90-sweep ``simulate`` log,
  ``export-bag`` (bz2, default topics) then ``convert-bag``, and ``run
  --profile indoor`` on the converted log.
* ``--cli-rs32``: the ring-annotated RS-LiDAR-32 rig (``sensor_type`` 320):
  90 sweeps of the ``simulate`` trajectory at 32 rings from -25 to 15 deg
  and 1800 azimuth steps, each point's ``ring`` set from the simulator's
  firing-major order, written as a bag with ``BagWriter``; then
  ``convert-bag`` and ``run --config`` with the indoor estimator and
  ``SensorConfig.rs32_uneven()``'s fields as its ``sensor`` block.

Prints one JSON line: the stage at the end, the sweep (in-process) or
measurement pair (CLI) at which the pipeline went INITED, consumed INITED
sweeps, ATE/RPE from ``io.evaluation`` and the run time.

Usage: JAX_PLATFORMS=cpu python tools/reference_ate_cpu.py [--profile P]
       [--use-corner] [--fix-map] [--sweeps N]
       [--cli-4d | --cli-outdoor | --cli-bag | --cli-rs32]
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lio_mapping_tpu import cli  # noqa: E402
from lio_mapping_tpu.config import LioConfig  # noqa: E402
from lio_mapping_tpu.io import evaluation, synthetic  # noqa: E402
from lio_mapping_tpu.models.pipeline import LioPipeline  # noqa: E402

SCAN_DT = 0.1
IMU_RATE = 200.0
# the RS-LiDAR-32 rig: SensorConfig.rs32_uneven() as a YAML sensor block,
# and its simulated scan (0.2 deg azimuth steps at 10 Hz)
RS32_SENSOR = {"n_rings": 32, "lower_bound_deg": -25.0, "upper_bound_deg": 15.0,
               "max_points_per_ring": 2304, "uneven": True}
RS32_AZIMUTH = 1800


def build_cfg(profile: str, use_corner: bool, fix_map: bool):
    if profile == "outdoor_64":
        base = LioConfig.outdoor_64()
        est = dataclasses.replace(base.estimator, extrinsic_rotation=(1, 0, 0, 0, 1, 0, 0, 0, 1),
                                  extrinsic_translation=(0.0, 0.0, 0.0))
        return dataclasses.replace(base, estimator=est)
    base = LioConfig.indoor()
    est = dataclasses.replace(base.estimator, use_corner=use_corner, fix_map=fix_map)
    return dataclasses.replace(base, estimator=est)


def in_process(args):
    cfg = build_cfg(args.profile, args.use_corner, args.fix_map)
    if args.profile == "outdoor_64":
        traj = synthetic.Trajectory(g_norm=cfg.estimator.imu.g_norm)
        rings = dict(n_rings=cfg.sensor.n_rings, lower_deg=cfg.sensor.lower_bound_deg,
                     upper_deg=cfg.sensor.upper_bound_deg)
    else:
        traj = synthetic.Trajectory(pitch_amp=0.4, roll_amp=0.35, rp_freq=0.45)
        rings = {}
    n_sweeps = args.sweeps or (60 if args.profile == "outdoor_64" else 90)
    pipe = LioPipeline(cfg, dtype=jnp.float32)
    qs, ps, times, stages, consumed = [], [], [], [], 0
    t_run = time.perf_counter()
    for i in range(n_sweeps):
        t0 = i * SCAN_DT
        xyz, mask = synthetic.simulate_sweep(traj, t0, n_azimuth=900, **rings)
        ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t0 + SCAN_DT, IMU_RATE)
        a0, w0 = traj.imu(t0)
        dts = np.diff(np.concatenate([[t0], ts]))
        out = pipe.process(xyz, mask, pipe.make_samples(dts, acc, gyr, a0, w0))
        qs.append(np.asarray(out["laser_pose"].q, np.float64))
        ps.append(np.asarray(out["laser_pose"].t, np.float64))
        times.append(t0 + SCAN_DT)
        stages.append(out["stage"])
        consumed += int(out["stage"] == "INITED" and "body_pose" in out)
    gt = [synthetic.gt_sensor_pose(traj, t) for t in times]
    m = evaluation.evaluate_trajectory(np.stack(qs), np.stack(ps), np.stack([g[0] for g in gt]),
                                       np.stack([g[1] for g in gt]))
    return {
        "profile": args.profile, "use_corner": args.use_corner, "fix_map": args.fix_map,
        "sweeps": n_sweeps, "stage": pipe.stage,
        "inited_at_sweep": stages.index("INITED") if "INITED" in stages else None,
        "consumed_inited_sweeps": consumed,
        "ate_rmse_m": m.ate_rmse, "rpe_trans_rmse_m": m.rpe_trans_rmse,
        "n_poses": m.n_poses, "run_s": time.perf_counter() - t_run,
    }


def _ate(est, gt):
    t_e, q_e, p_e = evaluation.load_tum(est)
    t_g, q_g, p_g = evaluation.load_tum(gt)
    ei, gi = evaluation.associate_by_time(t_e, t_g, max_dt=0.02)
    return evaluation.evaluate_trajectory(q_e[ei], p_e[ei], q_g[gi], p_g[gi]).ate_rmse, len(t_e)


def write_rs32_bag(bag: str, gt: str, n_sweeps: int):
    """The RS-32 rig's sequence as a bz2 bag: ``simulate``'s IMU stream and
    trajectory, sweeps at 32 rings x 1800 azimuth steps carrying only their
    ``ring`` field (the simulator's order is firing-major)."""
    from lio_mapping_tpu.io import rosbag as RB

    traj = synthetic.Trajectory(pitch_amp=0.4, roll_amp=0.35, rp_freq=0.45)
    rings = np.tile(np.arange(RS32_SENSOR["n_rings"], dtype=np.uint16), RS32_AZIMUTH)
    t_imu = 0.0
    with RB.BagWriter(bag, compression="bz2") as w:
        for i in range(n_sweeps):
            t0 = i * SCAN_DT
            while t_imu < t0 + SCAN_DT:
                t_imu += 1.0 / IMU_RATE
                acc, gyr = traj.imu(t_imu)
                w.write("/imu/data", "sensor_msgs/Imu", t_imu, RB.serialize_imu(
                    t_imu, acc.astype(np.float32), gyr.astype(np.float32)))
            xyz, mask = synthetic.simulate_sweep(
                traj, t0, n_azimuth=RS32_AZIMUTH, n_rings=RS32_SENSOR["n_rings"],
                lower_deg=RS32_SENSOR["lower_bound_deg"],
                upper_deg=RS32_SENSOR["upper_bound_deg"])
            w.write("/velodyne_points", "sensor_msgs/PointCloud2", t0 + SCAN_DT,
                    RB.serialize_pointcloud2(t0 + SCAN_DT, xyz[mask], None, rings[mask]))
    times = [i * SCAN_DT + SCAN_DT for i in range(n_sweeps)]
    poses = [synthetic.gt_sensor_pose(traj, t) for t in times]
    evaluation.save_tum(gt, times, np.stack([q for q, _ in poses]),
                        np.stack([p for _, p in poses]))


def rs32_yaml(path: str):
    """The indoor profile with the RS-32 sensor block."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({"sensor": dict(RS32_SENSOR)}, f)


@contextlib.contextmanager
def stages_by_pair(stages):
    """Append each ``LioPipeline.process`` call's stage to ``stages``."""
    from lio_mapping_tpu.models import pipeline as PL

    orig = PL.LioPipeline.process

    def process(self, *a, **kw):
        out = orig(self, *a, **kw)
        stages.append(out["stage"])
        return out

    PL.LioPipeline.process = process
    try:
        yield stages
    finally:
        PL.LioPipeline.process = orig


def through_cli(args):
    t_run = time.perf_counter()
    n_sweeps = args.sweeps or 90
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)  # noqa: E731
        # the bag round trip simulates into sim.liol and converts into seq.liol
        sim_log = p("sim.liol") if args.cli_bag else p("seq.liol")
        steps = [["simulate", "--out", sim_log, "--gt-out", p("gt.tum"),
                  "--sweeps", str(n_sweeps)]]
        run = ["run", "--log", p("seq.liol"), "--out", p("traj.tum"), "--map-out", p("map.pcd"),
               "--stats-json", p("stats.json")]
        if args.cli_outdoor:
            steps[0] += ["--extrinsic-translation", "-2.4", "0", "0.7"]
            run += ["--profile", "outdoor"]
            tag = "outdoor"
        elif args.cli_bag:
            steps += [["export-bag", "--log", sim_log, "--out", p("seq.bag")],
                      ["bag-info", "--bag", p("seq.bag")],
                      ["convert-bag", "--bag", p("seq.bag"), "--out", p("seq.liol")]]
            run += ["--profile", "indoor"]
            tag = "indoor, bag round trip"
        elif args.cli_rs32:
            write_rs32_bag(p("seq.bag"), p("gt.tum"), n_sweeps)
            rs32_yaml(p("rs32.yaml"))
            steps = [["convert-bag", "--bag", p("seq.bag"), "--out", p("seq.liol")]]
            run += ["--config", p("rs32.yaml")]
            tag = "rs32 (indoor estimator, ring-annotated bag)"
        else:
            run += ["--profile", "indoor", "--enable-4d", "--out-4d", p("traj_4d.tum")]
            tag = "indoor --enable-4d"
        buf = io.StringIO()
        stages = []
        with contextlib.redirect_stdout(buf), stages_by_pair(stages):
            for step in steps + [run]:
                if cli.main(step) != 0:
                    raise SystemExit(f"the JAX CLI failed at {step[0]}:\n{buf.getvalue()}")
        text = buf.getvalue()
        ate, n_poses = _ate(p("traj.tum"), p("gt.tum"))
        with open(p("stats.json")) as f:
            stats = json.load(f)
        row = {"cli": tag, "sweeps": n_sweeps,
               "stage": re.search(r"\(stage: (\w+)\)", text).group(1),
               "inited_at_pair": stages.index("INITED") if "INITED" in stages else None,
               "ate_rmse_m": ate, "n_poses": n_poses, "n_pairs": stats["n_pairs"],
               "map_voxels": int(re.search(r"wrote (\d+) map voxels", text).group(1))}
        if args.cli_bag or args.cli_rs32:
            row["convert"] = re.search(r"converted .*", text).group(0)
        if args.cli_4d:
            row["ate_4d_rmse_m"], row["n_poses_4d"] = _ate(p("traj_4d.tum"), p("gt.tum"))
    row["run_s"] = time.perf_counter() - t_run
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="indoor", choices=["indoor", "outdoor_64"])
    ap.add_argument("--use-corner", action="store_true")
    ap.add_argument("--fix-map", action="store_true")
    ap.add_argument("--sweeps", type=int, default=None,
                    help="default 90 (indoor, CLI) or 60 (outdoor_64)")
    ap.add_argument("--cli-4d", action="store_true")
    ap.add_argument("--cli-outdoor", action="store_true")
    ap.add_argument("--cli-bag", action="store_true")
    ap.add_argument("--cli-rs32", action="store_true")
    args = ap.parse_args()
    cli_mode = args.cli_4d or args.cli_outdoor or args.cli_bag or args.cli_rs32
    row = through_cli(args) if cli_mode else in_process(args)
    print(json.dumps({"package": "lio_mapping_tpu", "platform": "cpu", "dtype": "float32",
                      **row}))


if __name__ == "__main__":
    main()
