"""End-to-end CLI throughput of the port (counterpart of the JAX package's
``tools/bench_cli.py``): time the production entry point, ``cli run
--two-phase`` phase B over a pre-generated log, and record f/s plus the
host-ingest / step / flush split.

Simulation cost is excluded by generating the log once up front; the stats
JSON is written by the phase-B process itself (``--stats-json``), so the
number includes everything a deployment pays per sweep: log parse,
measurement-queue pairing, IMU boundary interpolation, sample packing, the
launches, and the chunked deferred readbacks. ``simulate``, ``run`` and
``evaluate`` run as ``python -m lio_mapping_tpu_torch.cli`` subprocesses;
``run`` gets this tool's ``--device``.

Usage: python -m lio_mapping_tpu_torch.tools.bench_cli [--sweeps 400]
       [--out CLI_THROUGHPUT.json] [--profile-config small|indoor]
       [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile

from . import add_device_arg, device_label, resolve_device, run_module

SMALL_YAML = """\
estimator:
  window_size: 5
  opt_window_size: 3
  init_window_factor: 1
  estimate_extrinsic: 0
  opt_extrinsic: false
  extrinsic_rotation: [1, 0, 0, 0, 1, 0, 0, 0, 1]
  extrinsic_translation: [0.0, 0.0, 0.0]
  surf_stack_cap: 2048
  local_map_filtered_cap: 8192
  features_per_frame_cap: 2048
  max_solver_iterations: 8
"""
CLI = "lio_mapping_tpu_torch.cli"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", type=int, default=400)
    ap.add_argument("--azimuth", type=int, default=900)
    ap.add_argument("--out", default=None, help="also write the payload JSON here")
    ap.add_argument("--profile-config", default="indoor", choices=["small", "indoor"],
                    help="indoor = shipped profile (default; the small CI config's 5/3 "
                         "window cannot hold tracking over hundreds of sweeps and is only "
                         "meant for short runs)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as td:
        log = os.path.join(td, "seq.liol")
        gt = os.path.join(td, "gt.tum")
        traj = os.path.join(td, "traj.tum")
        stats = os.path.join(td, "stats.json")

        run_module(CLI, "simulate", "--out", log, "--sweeps", args.sweeps,
                   "--azimuth", args.azimuth, "--gt-out", gt)

        run_cmd = ["run", "--log", log, "--out", traj, "--mode", "lio", "--two-phase",
                   "--stats-json", stats, "--device", args.device]
        if args.profile_config == "small":
            cfg = os.path.join(td, "small.yaml")
            with open(cfg, "w") as f:
                f.write(SMALL_YAML)
            run_cmd += ["--config", cfg]
        else:
            run_cmd += ["--profile", "indoor"]
        run_module(CLI, *run_cmd)

        with open(stats) as f:
            payload = json.load(f)

        ev = run_module(CLI, "evaluate", "--est", traj, "--gt", gt).stdout
        for line in ev.splitlines():
            if line.startswith("ATE RMSE:"):
                payload["ate_rmse_m"] = float(line.split()[2])

    payload.update({
        "metric": "cli_phaseB_frames_per_sec",
        "value": payload["fps_steady"],
        "unit": "frames/s",
        "n_sim_sweeps": args.sweeps,
        "profile_config": args.profile_config,
        "methodology": "two_phase phase-B replay over pre-generated .liol log; sim cost "
                       "excluded; fps_steady excludes start-up steps (>10x the median step: "
                       "first calls that build the kernel and allocate) and the end-of-run "
                       "pose flush",
        "device": device_label(device),
    })
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
