"""Command-line runners (port of lio_mapping_tpu.cli).

    python -m lio_mapping_tpu_torch.cli simulate --out seq.liol --sweeps 90 \
        --gt-out gt.tum
    python -m lio_mapping_tpu_torch.cli run --log seq.liol --profile indoor \
        --out traj.tum [--map-out map.pcd] [--mode lio|loam] [--device cuda|cpu]
        [--config profile.yaml] [--self-filter] [--timing] [--trace-dir d]
        [--stats-json s.json] [--checkpoint-out c.npz --checkpoint-every N]
        [--resume c.npz] [--two-phase] [--enable-4d --out-4d traj_4d.tum]
        [--mesh N [--map-shard] [--ingest-shard]]
    python -m lio_mapping_tpu_torch.cli evaluate --est traj.tum --gt gt.tum
    python -m lio_mapping_tpu_torch.cli export-pcd --log seq.liol \
        --traj traj.tum --out map.pcd
    python -m lio_mapping_tpu_torch.cli bag-info --bag in.bag
    python -m lio_mapping_tpu_torch.cli convert-bag --bag in.bag --out seq.liol \
        [--points-topic T] [--imu-topic T] [--scan-period 0.1] [--min-range 0]
    python -m lio_mapping_tpu_torch.cli export-bag --log seq.liol --out out.bag \
        [--compression bz2|none]
    python -m lio_mapping_tpu_torch.cli plot-traj --est traj.tum [--gt gt.tum] \
        --out dash.png [--euler-csv euler.csv]
    python -m lio_mapping_tpu_torch.cli viz-normals --log seq.liol --traj traj.tum \
        --out normals.ply [--map-out map.ply] [--device cuda|cpu]

``run`` replays a sequence log through the pipeline (LIO, or the LiDAR-only
LOAM baseline), writes a TUM trajectory and, with ``--map-out``, the
accumulated global map as a PCD. It runs on the card unless given
``--device cpu``, and without CUDA it stops with an error; it never falls
back to the CPU by itself. The host loop is the reference's: the native
measurement queue pairs each sweep with its IMU up to ``t +
msg_time_delay``, the boundary sample is split there by linear
interpolation, sweeps are padded to 4096-row multiples (padded rows are
masked and get ring 0), and a sweep's cloud is copied to the card when it
arrives if the pipeline will consume it. A ring-annotated log (``.liol``
v2, from ``convert-bag`` of a bag whose clouds carry the driver's ``ring``
field) feeds a profile with ``sensor.uneven``; such a profile over a log
without rings raises. ``--enable-4d`` runs the yaw-constrained 4D map
builder (``models/map_builder.py``) on each INITED sweep the estimator
consumed, with its newest laser pose; ``--out-4d`` writes the refined poses.

``bag-info``, ``convert-bag`` and ``export-bag`` read and write ROS bags
(v2.0, none/bz2 chunks) through ``io/rosbag.py``; ``plot-traj`` renders
trajectory dashboards with matplotlib (imported only there). ``viz-normals``
rebuilds the estimator's plane association at one sweep, on the card
unless given ``--device cpu`` (without CUDA it stops with an error), so
its 5-NN search runs the CUDA KNN kernel.

``run --mesh N`` runs the estimator distributed over N ranks
(``parallel/``): it starts N processes itself (spawned, rendezvous on a free
local port), each joins the process group and runs the whole host loop on
the same log; the estimator step rank-slices its association and sums its
normal equations over the ranks (``--map-shard``: the local map too, ring
KNN; ``--ingest-shard``: each rank uploads only its rows of each cloud).
The backend is gloo on the CPU, nccl with a card per rank, else gloo with
ranks sharing the cards. Rank 0 alone prints and writes the files; the
command exits with the worst exit code of its ranks. Without ``--mesh``,
``--map-shard`` and ``--ingest-shard`` are ignored, and ``--mode loam``
ignores ``--mesh``, as in the reference.

``--compile-cache`` is accepted and has nothing to do: the port compiles no
XLA programs (its native library and kernel are built once into
``_build/``). Three faults of the reference are fixed here: ``--two-phase``
applies ``--self-filter`` to the initialisation sweep it puts back into
the map, the log reader keeps each sweep in its own handle, and a resumed
run (``--skip-pairs``) does not copy the skipped pairs' clouds to the
device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np

PAD_Q = 4096  # sweep rows are padded to a multiple of this (masked rows)


def _profile(name: str, config_path: str = None):
    """Named profile, or a YAML profile file (configs/*.yaml format)."""
    from .config import LioConfig, load_yaml

    if config_path:
        return load_yaml(config_path)
    return {"indoor": LioConfig.indoor, "outdoor": LioConfig.outdoor,
            "outdoor_64": LioConfig.outdoor_64}[name]()


def cmd_simulate(args):
    from scipy.spatial.transform import Rotation

    from . import native
    from .io import synthetic

    # rotation excitation about >= 2 axes by default: the indoor profile
    # calibrates the laser-IMU extrinsic from scratch, and its hand-eye gate
    # never accepts a yaw-only path
    traj = synthetic.Trajectory(pitch_amp=args.pitch_amp, roll_amp=args.roll_amp,
                                rp_freq=0.45)
    # optional laser->body rig offset: the sensor rides at T_wb * T_bl
    ext = None
    if args.extrinsic_translation or args.extrinsic_ypr_deg:
        t_lb = np.asarray(args.extrinsic_translation or (0.0, 0.0, 0.0))
        ypr = np.deg2rad(np.asarray(args.extrinsic_ypr_deg or (0.0, 0.0, 0.0)))
        q_lb = np.roll(Rotation.from_euler("ZYX", ypr).as_quat(), 1)
        ext = (q_lb, t_lb)
    log = native.SequenceLog(args.out, write=True)
    dt = 0.1
    t_imu = 0.0
    for i in range(args.sweeps):
        t0 = i * dt
        while t_imu < t0 + dt:  # IMU up to the sweep end
            t_imu += 1.0 / args.imu_rate
            acc, gyr = traj.imu(t_imu)
            log.write_imu(t_imu, acc.astype(np.float32), gyr.astype(np.float32))
        xyz, mask = synthetic.simulate_sweep(traj, t0, n_azimuth=args.azimuth, extrinsic_lb=ext)
        rel = np.zeros(len(xyz), np.float32)
        log.write_sweep(t0 + dt, xyz[mask], rel[mask])
    log.close()
    print(f"wrote {args.sweeps} sweeps to {args.out}")
    if args.gt_out:
        from .io.evaluation import save_tum

        times = [i * dt + dt for i in range(args.sweeps)]
        qs, ps = [], []
        for t in times:
            q, p = synthetic.gt_sensor_pose(traj, t, extrinsic_lb=ext)
            qs.append(q)
            ps.append(p)
        save_tum(args.gt_out, times, np.stack(qs), np.stack(ps))
        print(f"wrote ground truth to {args.gt_out}")
    return 0


def _run_two_phase(args):
    """Phase A initialises in a subprocess and checkpoints; phase B resumes
    in a fresh one and replays the rest of the log. Both run this package
    (``sys.executable -m lio_mapping_tpu_torch.cli``)."""
    import shutil
    import subprocess
    import tempfile

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "init_ckpt.npz")
        sidecar = os.path.join(td, "init_meta.json")
        prefix = os.path.join(td, "prefix.tum")
        base = [sys.executable, "-m", "lio_mapping_tpu_torch.cli", "run", "--log", args.log,
                "--profile", args.profile, "--mode", args.mode, "--device", args.device]
        if args.config:
            base += ["--config", args.config]
        if args.self_filter:
            base.append("--self-filter")
        # both phases run the same mesh: it changes the order of the sums
        if args.mesh:
            base += ["--mesh", str(args.mesh)]
        if args.map_shard:
            base.append("--map-shard")
        if args.ingest_shard:
            base.append("--ingest-shard")
        rc = subprocess.call(base + ["--out", prefix, "--checkpoint-out", ckpt,
                                     "--stop-at-init", sidecar], env=env)
        if rc != 0:
            return rc
        with open(sidecar) as f:
            meta = json.load(f)
        if not meta.get("inited"):
            print("two-phase: initialization never succeeded; the phase-A trajectory is "
                  "the full output")
            shutil.copy(prefix, args.out)
            return 1
        pb = base + ["--out", args.out, "--resume", ckpt, "--skip-pairs", str(meta["pairs"]),
                     "--bound-in", sidecar, "--traj-prefix", prefix]
        for flag, val in (("--map-out", args.map_out), ("--out-4d", args.out_4d),
                          ("--trace-dir", args.trace_dir),
                          ("--stats-json", args.stats_json),
                          ("--checkpoint-out", args.checkpoint_out)):
            if val:
                pb += [flag, val]
        if args.enable_4d:
            pb.append("--enable-4d")
        if args.timing:
            pb.append("--timing")
        if args.checkpoint_every:
            pb += ["--checkpoint-every", str(args.checkpoint_every)]
        return subprocess.call(pb, env=env)


def _host_f64(parts):
    """float64 numpy copies of pose parts: device tensors come back in one
    copy, host arrays (host-predicted poses) as they are."""
    import torch

    out = [None] * len(parts)
    on_dev = [i for i, a in enumerate(parts) if torch.is_tensor(a)]
    if on_dev:
        host = torch.stack([parts[i].detach() for i in on_dev]).to("cpu", torch.float64).numpy()
        for j, i in enumerate(on_dev):
            out[i] = host[j]
    return [np.asarray(a, np.float64) if o is None else o for a, o in zip(parts, out)]


def _no_cuda(device) -> bool:
    """True, with the error printed, when ``device`` is CUDA and there is
    none: the commands that run on the card never fall back to the CPU."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available; run with --device cpu to use the CPU",
              file=sys.stderr)
        return True
    return False


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_digest(pipe) -> str:
    """sha256 of every tensor of the pipeline's estimator state (its bytes
    on the host): equal digests mean bit-identical states."""
    import hashlib

    import torch

    from .utils.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(pipe.est_state):
        h.update(leaf.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _run_rank(rank, world, address, args):
    """One rank of ``run --mesh``: join the process group, run the replay,
    leave the group. Ranks other than 0 print nothing but errors."""
    from .parallel import multihost as MH

    mesh = MH.initialize(address, world, rank, device=args.device)
    try:
        if rank == 0:
            return _replay(args, mesh)
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            return _replay(args, mesh)
    finally:
        MH.shutdown()


def cmd_run(args):
    if args.stop_at_init and not args.checkpoint_out:
        # without a checkpoint the sidecar would claim `inited` with nothing
        # for phase B to resume from
        print("error: --stop-at-init requires --checkpoint-out", file=sys.stderr)
        return 2
    if args.two_phase and args.resume:
        print("error: --two-phase and --resume are mutually exclusive (phase A creates "
              "the init checkpoint itself; to resume a previous run use plain "
              "`run --resume`)", file=sys.stderr)
        return 2

    if _no_cuda(args.device):
        return 2
    if args.two_phase:
        return _run_two_phase(args)
    if args.mesh and args.mode == "lio":
        from .parallel import lio_dist
        from .parallel import multihost as MH

        # refused before any rank starts, with the reference's error
        lio_dist.check_caps(_profile(args.profile, args.config), args.mesh)
        return MH.launch(args.mesh, _run_rank, args)
    return _replay(args)


def _replay(args, mesh=None):
    """The replay of ``run`` (single process, or one rank of ``mesh``)."""
    import torch
    from scipy.spatial.transform import Rotation

    from . import native
    from .io.evaluation import load_tum, save_tum
    from .models import pipeline as PL
    from .ops import knn_kernel
    from .utils.timing import StageTimer, device_trace

    cfg = _profile(args.profile, args.config)
    device = mesh.device if mesh is not None else torch.device(args.device)
    writer = mesh is None or mesh.rank == 0  # the rank that prints and writes files
    if args.mode == "loam":
        pipe = PL.LoamPipeline(cfg, device=device, dtype=torch.float32)
    else:
        if mesh is not None:
            where = (f"{torch.cuda.device_count()} card(s)" if device.type == "cuda"
                     else "the CPU")
            mode = "".join(f" ({m})" for m, on in (("map-sharded", args.map_shard),
                                                    ("ingest-sharded", args.ingest_shard)) if on)
            print(f"distributed estimator over {mesh.size} ranks on {where}, backend "
                  f"{mesh.backend}{mode}")
        pipe = PL.LioPipeline(cfg, device=device, dtype=torch.float32, mesh=mesh,
                              map_shard=args.map_shard, ingest_shard=args.ingest_shard)
    if args.resume:
        pipe.load(args.resume)
        print(f"resumed from {args.resume} (frame {pipe.frame_count})")
    mq = native.MeasurementQueue(cfg.estimator.msg_time_delay)
    global_map = (native.GlobalVoxelMap(cfg.mapping.map_filter_size)
                  if args.map_out and writer else None)
    timer = StageTimer(enabled=args.timing, sync=args.timing)
    knn_launches0 = knn_kernel.LAUNCHES

    # the 4D map builder consumes the estimator's output
    # (launch/map_4D_indoor.launch:9-15)
    mb_state = None
    times_4d, qs_4d, ts_4d = [], [], []
    if args.enable_4d and writer:  # its poses are output only: rank 0 runs it
        from .models import map_builder as MB
        from .models import mapping as MAPM

        mb_state = MAPM.init_state(cfg, torch.float32, device)

    self_rot = self_box = None
    if args.self_filter:
        from .ops.cloud import KAIST_SELF_FILTER_BOX, KAIST_SELF_FILTER_ROTATION, crop_box_filter

        self_rot = np.asarray(KAIST_SELF_FILTER_ROTATION, np.float32)
        self_box = KAIST_SELF_FILTER_BOX

    def self_filter(xyz, mask):
        return crop_box_filter(torch.as_tensor(xyz), torch.as_tensor(mask), self_box[0],
                               self_box[1], self_rot).numpy()

    # poses stay on the device until a flush copies them back together:
    # once at the end for a pose-only replay, every FLUSH_EVERY sweeps when
    # the map export or the 4D builder is on
    FLUSH_EVERY = 512 if (global_map is not None or args.enable_4d) else 65536
    pend_t, pend_q, pend_p = [], [], []  # stamps + pose refs
    pend_t4, pend_q4, pend_p4 = [], [], []  # the 4D builder's
    map_pend = []                        # (index in pend, masked xyz)
    times, qs, ts = [], [], []

    # wall-clock split of the replay: step dispatch, flush readbacks, and
    # host ingest (log parse + queue + interpolation: the remainder)
    stats = {"t_step": 0.0, "t_flush": 0.0, "t_first_step": 0.0, "n_pairs": 0,
             "step_times": [], "n_consumed": 0, "est_launches": 0}

    def flush():
        f0 = time.perf_counter()
        qs_h = _host_f64(pend_q)
        ps_h = _host_f64(pend_p)
        times.extend(pend_t)
        qs.extend(qs_h)
        ts.extend(ps_h)
        if global_map is not None and map_pend:
            with timer.stage("global_map"):
                for idx, xyzm in map_pend:
                    world = Rotation.from_quat(np.roll(qs_h[idx], -1)).apply(xyzm) + ps_h[idx]
                    global_map.insert(world.astype(np.float32))
            map_pend.clear()
        pend_t.clear(), pend_q.clear(), pend_p.clear()
        times_4d.extend(pend_t4)
        qs_4d.extend(_host_f64(pend_q4))
        ts_4d.extend(_host_f64(pend_p4))
        pend_t4.clear(), pend_q4.clear(), pend_p4.clear()
        stats["t_flush"] += time.perf_counter() - f0

    def step(t, xyz, mask, samples, ring=None, pf=None):
        s0 = time.perf_counter()
        _step_impl(t, xyz, mask, samples, ring, pf)
        dt = time.perf_counter() - s0
        stats["t_step"] += dt
        stats["step_times"].append(dt)
        if stats["n_pairs"] == 0:
            stats["t_first_step"] = dt
        stats["n_pairs"] += 1

    def _step_impl(t, xyz, mask, samples, ring, pf=None):
        nonlocal mb_state
        if self_rot is not None:
            with timer.stage("self_filter"):
                mask = self_filter(xyz, mask)
        k0 = knn_kernel.LAUNCHES
        with timer.stage("pipeline", sync_on=device):
            if args.mode == "loam":
                out = pipe.process(xyz, mask, ring_ids=ring)
            elif pf is not None:
                out = pipe.process(pf, None, samples)  # cloud already on its way
            else:
                out = pipe.process(xyz, mask, samples, ring_ids=ring)
        pose = out.get("laser_pose")
        if pose is None:
            return
        if "n_features" in out:  # an estimator step ran
            stats["n_consumed"] += 1
            stats["est_launches"] += knn_kernel.LAUNCHES - k0
        if mb_state is not None and out.get("stage") == "INITED" \
                and "corner_cloud" in out and not out.get("predicted"):
            with timer.stage("map_builder", sync_on=device):
                mb_state, mb_out = MB.map_builder_step(
                    mb_state, out["corner_cloud"], out["surf_cloud"], pose, cfg)
            pend_t4.append(t)
            pend_q4.append(mb_out["pose"].q)
            pend_p4.append(mb_out["pose"].t)
        pend_t.append(t)
        pend_q.append(pose.q)
        pend_p.append(pose.t)
        if global_map is not None and out.get("stage") in ("INITED", "LOAM") \
                and not out.get("predicted"):
            map_pend.append((len(pend_t) - 1, np.asarray(xyz)[mask]))
        if len(pend_t) >= FLUSH_EVERY:
            flush()
        if args.checkpoint_out and args.checkpoint_every and writer and \
                (len(times) + len(pend_t)) % args.checkpoint_every == 0:
            with timer.stage("checkpoint"):
                pipe.save(args.checkpoint_out)

    sweeps = {}
    next_id = 0
    delay = cfg.estimator.msg_time_delay
    prev_bound = None  # (t_b, acc_b, gyr_b): interpolated interval boundary
    skip_pairs = args.skip_pairs or 0
    # two-phase --map-out: phase A's last (init) sweep is the one INITED
    # sweep whose cloud never reaches this process's pipeline (it lies
    # inside --skip-pairs); its pose is the last line of the phase-A prefix,
    # and its cloud goes into the map here, self-filtered like any other
    init_map_entry = None
    if global_map is not None and args.traj_prefix and skip_pairs:
        tp, qp, pp = load_tum(args.traj_prefix)
        if len(tp):
            init_map_entry = (float(tp[-1]), qp[-1], pp[-1])
    if args.bound_in:
        # phase-B resume: the skipped pairs' IMU is inside the checkpoint;
        # restore the interval boundary phase A stopped at
        with open(args.bound_in) as f:
            meta = json.load(f)
        if meta.get("prev_bound") is not None:
            b = meta["prev_bound"]
            prev_bound = (float(b[0]), np.asarray(b[1], np.float64),
                          np.asarray(b[2], np.float64))
    stop_at_init = args.stop_at_init
    pair_idx = 0
    stopped_early = False
    loop_t0 = time.perf_counter()
    with device_trace(args.trace_dir if writer else None):
        for item in native.SequenceLog(args.log):
            if stopped_early:
                break
            if item[0] == "imu":
                mq.push_imu(item[1], item[2], item[3])
            else:
                xyz, ring = item[2], item[4]
                # pad to the next PAD_Q multiple with masked rows, so that
                # the point counts of a log fall into a few shapes
                n_raw = len(xyz)
                n_pad = -(-max(n_raw, 1) // PAD_Q) * PAD_Q
                mask = np.zeros(n_pad, bool)
                mask[:n_raw] = True
                if n_pad != n_raw:
                    xyz = np.concatenate([xyz, np.zeros((n_pad - n_raw, 3), xyz.dtype)])
                    if ring is not None:
                        ring = np.concatenate([ring, np.zeros(n_pad - n_raw, ring.dtype)])
                # start the cloud's copy to the device now, while earlier
                # sweeps still run; skipped-cadence sweeps and the pairs a
                # resumed run skips never copy, and the self-filter edits the
                # mask on the host first. This sweep becomes pair ``ahead``;
                # the pipeline steps once per pair past the skip window
                ahead = pair_idx + len(sweeps)
                pf = None
                if args.mode == "lio" and not args.self_filter and ahead >= skip_pairs \
                        and pipe.will_consume(ahead - max(pair_idx, skip_pairs) + 1):
                    pf = pipe.prefetch_cloud(xyz, mask, ring)
                sweeps[next_id] = (xyz, mask, ring, pf)
                mq.push_sweep(item[1], next_id)
                next_id += 1
            while True:
                pair = mq.next_pair()
                if pair is None:
                    break
                t, sid, imu_t, acc, gyr = pair
                xyz, mask, ring, pf = sweeps.pop(sid)
                if pair_idx < skip_pairs:
                    if init_map_entry is not None and abs(t - init_map_entry[0]) < 1e-6:
                        _, q_i, p_i = init_map_entry
                        if self_rot is not None:
                            mask = self_filter(xyz, mask)
                        world = Rotation.from_quat(np.roll(q_i, -1)).apply(xyz[mask]) + p_i
                        global_map.insert(world.astype(np.float32))
                    pair_idx += 1
                    continue
                samples = None
                if args.mode == "lio" and len(imu_t) >= 2:
                    # split the boundary IMU sample at exactly t + delay
                    # (Estimator.cc:373-385), so each interval ends at the
                    # same offset from its sweep stamp
                    t_b = t + delay
                    if imu_t[-1] > t_b:
                        w = (t_b - imu_t[-2]) / max(imu_t[-1] - imu_t[-2], 1e-9)
                        acc_b = (1 - w) * acc[-2] + w * acc[-1]
                        gyr_b = (1 - w) * gyr[-2] + w * gyr[-1]
                        imu_t = np.concatenate([imu_t[:-1], [t_b]])
                        acc = np.concatenate([acc[:-1], acc_b[None]])
                        gyr = np.concatenate([gyr[:-1], gyr_b[None]])
                    else:
                        acc_b, gyr_b = acc[-1], gyr[-1]
                        t_b = imu_t[-1]
                    if prev_bound is not None:
                        t0_a, a0, w0 = prev_bound
                        keep = imu_t > t0_a + 1e-9
                        dts = np.diff(np.concatenate([[t0_a], imu_t[keep]]))
                        samples = pipe.make_samples(dts, acc[keep], gyr[keep], a0, w0)
                    else:
                        samples = pipe.make_samples(np.diff(imu_t), acc[1:], gyr[1:],
                                                    acc[0], gyr[0])
                    prev_bound = (t_b, acc_b, gyr_b)
                step(t, xyz, mask, samples, ring=ring, pf=pf)
                pair_idx += 1
                if stop_at_init and args.mode == "lio" and pipe.stage == "INITED":
                    stopped_early = True
                    break
    disp_ms = None
    probe_cost = 0.0
    if args.stats_json and writer:
        probe_t0 = time.perf_counter()
        # dispatch floor, before the final flush's readbacks: the mean time
        # of one small program enqueued back to back (on the card, the
        # launch floor)
        probe_in = torch.ones((64, 15, 15), dtype=torch.float32, device=device)

        def probe(x):
            return torch.einsum("kij,kjl,kml->im", x, x, x)

        for _ in range(3):
            probe(probe_in)
        _sync(device)
        p0 = time.perf_counter()
        for _ in range(30):
            probe(probe_in)
        _sync(device)
        disp_ms = (time.perf_counter() - p0) / 30 * 1e3
        probe_cost = time.perf_counter() - probe_t0

    flush()
    loop_wall = time.perf_counter() - loop_t0 - probe_cost
    ranks = None
    if mesh is not None and args.mode == "lio":
        ranks = _mesh_report(mesh, pipe, knn_kernel.LAUNCHES - knn_launches0, stats, loop_wall)
    if not writer:
        return 0

    if args.stats_json:
        n = stats["n_pairs"]
        # compile-like outliers: any step over 10x the median counts as
        # start-up cost and is left out of the steady rate
        st = np.asarray(stats["step_times"]) if stats["step_times"] else np.zeros(0)
        med = float(np.median(st)) if len(st) else 0.0
        compile_mask = st > 10.0 * max(med, 1e-9)
        t_compile = float(st[compile_mask].sum())
        n_steady = int((~compile_mask).sum())
        steady_wall = loop_wall - t_compile
        payload = {
            "n_pairs": n,
            "loop_wall_s": round(loop_wall, 4),
            "fps_total": round(n / loop_wall, 2) if loop_wall > 0 else 0.0,
            "fps_steady": round(n_steady / max(steady_wall - stats["t_flush"], 1e-9), 2)
            if n_steady else 0.0,
            "per_step_ms_median": round(med * 1e3, 3),
            "t_compile_s": round(t_compile, 4),
            "n_compile_steps": int(compile_mask.sum()),
            "t_first_step_s": round(stats["t_first_step"], 4),
            "t_step_s": round(stats["t_step"], 4),
            "t_flush_s": round(stats["t_flush"], 4),
            "t_ingest_s": round(max(0.0, loop_wall - stats["t_step"] - stats["t_flush"]), 4),
            "dispatch_floor_ms": round(disp_ms, 3) if disp_ms else None,
            "clean_stream": bool(disp_ms and disp_ms < 0.5),
            "mode": args.mode,
            "stage": pipe.stage if args.mode == "lio" else "LOAM",
            "resumed": bool(args.resume),
            "mesh": ranks,
        }
        with open(args.stats_json, "w") as f:
            json.dump(payload, f)
        print(f"replay stats -> {args.stats_json}: {payload['fps_steady']} f/s steady "
              f"({payload['fps_total']} incl. compile)")

    if stop_at_init:
        # phase A of --two-phase: checkpoint, sidecar, partial trajectory
        pipe.save(args.checkpoint_out)
        meta = {
            "inited": pipe.stage == "INITED" if args.mode == "lio" else True,
            "pairs": pair_idx,
            "prev_bound": None if prev_bound is None else [
                float(prev_bound[0]), np.asarray(prev_bound[1], np.float64).tolist(),
                np.asarray(prev_bound[2], np.float64).tolist()],
        }
        with open(stop_at_init, "w") as f:
            json.dump(meta, f)
        if times:
            save_tum(args.out, times, np.stack(qs), np.stack(ts))
        else:
            open(args.out, "w").close()
        print(f"stopped after init: {pair_idx} pairs, checkpoint {args.checkpoint_out}, "
              f"sidecar {stop_at_init}")
        return 0

    if args.traj_prefix:
        t_pre, q_pre, p_pre = load_tum(args.traj_prefix)
        times = list(t_pre) + times
        qs = list(q_pre) + qs
        ts = list(p_pre) + ts

    save_tum(args.out, times, np.stack(qs), np.stack(ts))
    stage = pipe.stage if args.mode == "lio" else "LOAM"
    print(f"wrote {len(times)} poses to {args.out} (stage: {stage})")
    if global_map is not None:
        global_map.save_pcd(args.map_out)
        print(f"wrote {len(global_map)} map voxels to {args.map_out}")
    if args.out_4d and times_4d:
        save_tum(args.out_4d, times_4d, np.stack(qs_4d), np.stack(ts_4d))
        print(f"wrote {len(times_4d)} 4D-refined poses to {args.out_4d}")
    if args.checkpoint_out:
        pipe.save(args.checkpoint_out)
        print(f"wrote checkpoint to {args.checkpoint_out}")
    if args.timing:
        print(timer.report())
        print(f"knn kernel launches: {knn_kernel.LAUNCHES - knn_launches0}")
    return 0


def _mesh_report(mesh, pipe, knn_launches: int, stats: dict, loop_wall: float) -> dict:
    """Every rank's device, kernel launches (all, and those of the estimator
    steps), collective counters, time split (replay loop, pipeline steps,
    inside collectives) and state digest, gathered to each rank (one
    ``all_gather_object``, not counted); rank 0 prints the collectives per
    consumed sweep. Returns the record ``--stats-json`` keeps under
    ``mesh``."""
    import torch.distributed as dist

    n_consumed = stats["n_consumed"]
    mine = {"rank": mesh.rank, "device": str(mesh.device), "knn_launches": knn_launches,
            "estimator_knn_launches": stats["est_launches"], **mesh.counters(),
            "loop_s": loop_wall, "step_s": stats["t_step"],
            "state_sha256": _state_digest(pipe)}
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, mine, group=mesh.group)
    per = max(n_consumed, 1)
    rec = {"ranks": mesh.size, "backend": mesh.backend, "consumed_sweeps": n_consumed,
           "collectives_per_consumed_sweep": mine["collectives"] / per,
           "bytes_per_consumed_sweep": mine["bytes"] / per,
           "host_bytes_per_consumed_sweep": mine["host_bytes"] / per,
           "states_equal": len({r["state_sha256"] for r in per_rank}) == 1,
           "per_rank": per_rank}
    print(f"collectives: {mine['collectives']} over {n_consumed} consumed sweeps "
          f"({rec['collectives_per_consumed_sweep']:.1f} per sweep, "
          f"{rec['bytes_per_consumed_sweep'] / 1e6:.3f} MB per sweep); "
          f"copied through the host: {mine['host_bytes']} bytes; backend {mesh.backend}; "
          f"rank states {'equal' if rec['states_equal'] else 'DIFFER'}")
    return rec


def cmd_export_pcd(args):
    """Sequence log + TUM trajectory -> one world-frame PCD (the reference's
    save_bag_to_pcd.cc:60-105): each sweep takes the pose with the nearest
    stamp within half a scan period. Host-side, on the CPU."""
    import torch

    from . import native
    from .io.evaluation import load_tum
    from .utils import quaternion as quat

    t_tr, q_tr, p_tr = load_tum(args.traj)
    gmap = native.GlobalVoxelMap(args.leaf)
    half = 0.05
    n_used = 0
    for item in native.SequenceLog(args.log):
        if item[0] != "sweep":
            continue
        t, xyz = item[1], item[2]
        i = int(np.argmin(np.abs(t_tr - t)))
        if abs(t_tr[i] - t) > half:
            continue
        q = torch.as_tensor(q_tr[i], dtype=torch.float32)[None, :]
        world = quat.rotate(q, torch.as_tensor(xyz)).numpy() + p_tr[i]
        gmap.insert(world)
        n_used += 1
    gmap.save_pcd(args.out)
    print(f"aggregated {n_used} sweeps -> {len(gmap)} voxels in {args.out}")
    return 0


def cmd_bag_info(args):
    """Topic inventory of a rosbag (``rosbag info`` equivalent)."""
    from .io.rosbag import BagReader

    info = BagReader(args.bag).topics()
    for topic, (msg_type, count) in sorted(info.items()):
        print(f"{topic:40s} {msg_type:30s} {count:8d} msgs")
    return 0


def cmd_convert_bag(args):
    """rosbag -> sequence log (the reference's `rosbag play` entry point).
    Topics default to the largest sensor_msgs/PointCloud2 and
    sensor_msgs/Imu topics in the bag."""
    from .io.rosbag import convert_bag

    n_sweeps, n_imu = convert_bag(args.bag, args.out, points_topic=args.points_topic,
                                  imu_topic=args.imu_topic, scan_period=args.scan_period,
                                  min_range=args.min_range)
    print(f"converted {n_sweeps} sweeps + {n_imu} imu msgs -> {args.out}")
    if n_sweeps == 0:
        print("warning: no sweeps converted (check --points-topic)")
        return 1
    return 0


def cmd_export_bag(args):
    """Sequence log -> rosbag (for ROS-side tooling/rviz replay)."""
    from . import native
    from .io import rosbag as RB

    n = 0
    with RB.BagWriter(args.out, compression=args.compression) as w:
        for item in native.SequenceLog(args.log):
            if item[0] == "sweep":
                _, t, xyz, rel, ring = item
                w.write(args.points_topic, "sensor_msgs/PointCloud2", t,
                        RB.serialize_pointcloud2(t, xyz, rel, ring=ring))
            else:
                _, t, acc, gyr = item
                w.write(args.imu_topic, "sensor_msgs/Imu", t, RB.serialize_imu(t, acc, gyr))
            n += 1
    print(f"wrote {n} messages to {args.out}")
    return 0


def cmd_plot_traj(args):
    """Trajectory dashboards: XY path, altitude, euler angles (PNG), and an
    optional euler CSV (scripts/transform_monitor.py's series)."""
    from .io.evaluation import load_tum
    from .io.viz import plot_trajectory, save_euler_csv

    t_e, q_e, p_e = load_tum(args.est)
    gt = load_tum(args.gt) if args.gt else None
    plot_trajectory(args.out, t_e, q_e, p_e, gt=gt, title=args.title)
    print(f"wrote {args.out}")
    if args.euler_csv:
        save_euler_csv(args.euler_csv, t_e, q_e)
        print(f"wrote {args.euler_csv}")
    return 0


class NormalsView(NamedTuple):
    """One sweep's plane association (``normals_view``), on the host:
    every query row of the voxel-filtered sweep, which rows were accepted,
    their unit normals and scores, and the local map's valid rows."""

    xyz: np.ndarray      # (C, 3) query rows, pivot (sweep) frame
    ok: np.ndarray       # (C,) accepted as surf features
    normals: np.ndarray  # (C, 3)
    scores: np.ndarray   # (C,)
    map_xyz: np.ndarray  # (M', 3)


def normals_view(log: str, traj: str, cfg, index: int = -1, frames: int = 10,
                 device="cuda", force_tiled: bool = False):
    """The estimator's association view at one sweep (PlaneNormalVisualizer,
    Visualizer.h:75-106): the ``frames`` sweeps before it, posed by the TUM
    trajectory (nearest stamp within half a scan period), form a local map
    in its frame; its voxel-filtered points associate against that map with
    the estimator's 5-NN plane rows (``make_knn5`` + ``_surf_rows``), on
    ``device``: on the card the search runs the CUDA kernel, unless
    ``force_tiled`` keeps it on the plain version. None when fewer than two
    sweeps are posed."""
    import torch

    from . import native
    from .io.evaluation import load_tum
    from .models import estimator as EST
    from .ops import voxel as VX
    from .utils import quaternion as quat
    from .utils.se3 import Pose

    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    e = cfg.estimator
    t_tr, q_tr, p_tr = load_tum(traj)
    posed = []  # (xyz, Pose)
    half = 0.05
    for item in native.SequenceLog(log):
        if item[0] != "sweep":
            continue
        t, xyz = item[1], item[2]
        i = int(np.argmin(np.abs(t_tr - t)))
        if abs(t_tr[i] - t) > half:
            continue
        posed.append((xyz, Pose(torch.as_tensor(q_tr[i], **f32),
                                torch.as_tensor(p_tr[i], **f32))))
    if len(posed) < 2:
        return None
    idx = index if index >= 0 else len(posed) - 1
    idx = min(max(idx, 1), len(posed) - 1)
    pivot_pose = posed[idx][1]

    # map: sweeps [idx - frames, idx) in the pivot frame
    pts = []
    for xyz, pose in posed[max(0, idx - frames):idx]:
        rel = pivot_pose.inverse() @ pose
        pts.append(quat.rotate(rel.q[None, :], torch.as_tensor(xyz, **f32)) + rel.t[None, :])
    merged = torch.cat(pts)
    map_xyz, map_mask, _ = VX.voxel_downsample(
        merged, torch.ones(len(merged), dtype=torch.bool, device=dev), e.surf_filter_size,
        e.local_map_filtered_cap)
    sweep = torch.as_tensor(posed[idx][0], **f32)
    q_xyz, q_mask, _ = VX.voxel_downsample(
        sweep, torch.ones(len(sweep), dtype=torch.bool, device=dev), e.surf_filter_size,
        e.surf_stack_cap)
    in_fov = torch.ones(q_xyz.shape[:1], dtype=torch.bool, device=dev)
    knn5 = EST.make_knn5(map_xyz, map_mask, cfg, force_tiled=force_tiled)
    coeff, score, ok = EST._surf_rows(knn5, q_xyz, q_mask, in_fov, cfg)
    normals = coeff[:, :3] / torch.clamp_min(score, 1e-6)[:, None]
    return NormalsView(q_xyz.cpu().numpy(), ok.cpu().numpy(), normals.cpu().numpy(),
                       score.cpu().numpy(), map_xyz[map_mask].cpu().numpy())


def cmd_viz_normals(args):
    """Local map + fitted plane normals export: the accepted features of
    ``normals_view`` as a normals-annotated PLY (the score as its quality
    channel), and the local map as a PLY cloud."""
    from .io.viz import save_ply_cloud, save_ply_normals

    if _no_cuda(args.device):
        return 2
    view = normals_view(args.log, args.traj, _profile(args.profile), args.index, args.frames,
                        args.device)
    if view is None:
        print("not enough posed sweeps")
        return 1
    save_ply_normals(args.out, view.xyz[view.ok], view.normals[view.ok], view.scores[view.ok])
    print(f"wrote {int(view.ok.sum())} features with normals to {args.out}")
    if args.map_out:
        save_ply_cloud(args.map_out, view.map_xyz)
        print(f"wrote local map to {args.map_out}")
    return 0


def cmd_evaluate(args):
    from .io.evaluation import associate_by_time, evaluate_trajectory, load_tum

    t_e, q_e, p_e = load_tum(args.est)
    t_g, q_g, p_g = load_tum(args.gt)
    ei, gi = associate_by_time(t_e, t_g, max_dt=args.max_dt)
    if len(ei) < 2:
        print(f"only {len(ei)} timestamp matches within {args.max_dt}s — "
              "check the trajectories' time bases")
        return 1
    m = evaluate_trajectory(q_e[ei], p_e[ei], q_g[gi], p_g[gi])
    print(f"matched {len(ei)}/{len(t_e)} poses by timestamp (max_dt {args.max_dt}s)")
    print(f"ATE RMSE: {m.ate_rmse:.4f} m  mean {m.ate_mean:.4f}  max {m.ate_max:.4f}")
    print(f"RPE: {m.rpe_trans_rmse:.4f} m / {m.rpe_rot_rmse_deg:.3f} deg over {m.n_poses} poses")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lio_mapping_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate")
    p.add_argument("--out", required=True)
    p.add_argument("--sweeps", type=int, default=100)
    p.add_argument("--azimuth", type=int, default=900)
    p.add_argument("--imu-rate", type=float, default=200.0)
    p.add_argument("--pitch-amp", type=float, default=0.4)
    p.add_argument("--gt-out", default=None)
    p.add_argument("--roll-amp", type=float, default=0.35)
    p.add_argument("--extrinsic-translation", nargs=3, type=float, default=None,
                   metavar=("X", "Y", "Z"), help="laser->body rig offset t_lb (m)")
    p.add_argument("--extrinsic-ypr-deg", nargs=3, type=float, default=None,
                   metavar=("YAW", "PITCH", "ROLL"), help="laser->body rig rotation (deg, ZYX)")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("run")
    p.add_argument("--log", required=True)
    p.add_argument("--profile", default="indoor", choices=["indoor", "outdoor", "outdoor_64"])
    p.add_argument("--config", default=None,
                   help="YAML profile file overriding --profile (configs/*.yaml format)")
    p.add_argument("--out", required=True)
    p.add_argument("--map-out", default=None)
    p.add_argument("--mode", default="lio", choices=["lio", "loam"],
                   help="lio = tightly-coupled estimator; loam = LiDAR-only baseline")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; `cpu` to run on the CPU)")
    p.add_argument("--self-filter", action="store_true",
                   help="KAIST-rig vehicle crop-box self-filter (input_filters_node.cc)")
    p.add_argument("--timing", action="store_true",
                   help="per-stage wall-clock report, each stage synchronised with the card")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--checkpoint-out", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--two-phase", action="store_true",
                   help="initialise in one subprocess, checkpoint, then resume and replay "
                        "the rest of the log in a fresh one; --map-out stays complete; "
                        "--enable-4d/--out-4d start one sweep after init (the builder "
                        "runs in phase B)")
    # worker flags of --two-phase (also usable to resume a checkpointed replay)
    p.add_argument("--stop-at-init", default=None, metavar="SIDECAR",
                   help="stop right after initialization; write the pair count and IMU "
                        "boundary to this JSON (requires --checkpoint-out)")
    p.add_argument("--skip-pairs", type=int, default=0,
                   help="with --resume: skip the first N measurement pairs of the log")
    p.add_argument("--bound-in", default=None,
                   help="with --resume: restore the IMU interval boundary from a "
                        "--stop-at-init sidecar")
    p.add_argument("--traj-prefix", default=None, help="prepend this TUM file's poses to --out")
    p.add_argument("--stats-json", default=None,
                   help="write replay-loop throughput stats (f/s, ingest/step/flush split) "
                        "to this JSON; with --two-phase, of phase B")
    p.add_argument("--enable-4d", action="store_true",
                   help="run the yaw-constrained 4D map builder on the estimator output "
                        "(map_4D_indoor.launch)")
    p.add_argument("--out-4d", default=None, help="TUM output of the 4D-refined trajectory")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="accepted for the reference's command lines; the port has no XLA "
                        "compilation to cache (its kernel and native library are built "
                        "once into _build/)")
    p.add_argument("--mesh", type=int, default=0,
                   help="run the estimator step distributed over this many "
                        "devices (full lio_step, one process per device)")
    p.add_argument("--map-shard", action="store_true",
                   help="with --mesh: shard the local map too "
                        "(ppermute-ring association)")
    p.add_argument("--ingest-shard", action="store_true",
                   help="with --mesh: each process/device transfers only "
                        "its row slice of the packed cloud (on-device "
                        "all_gather reassembles it)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("evaluate")
    p.add_argument("--est", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--max-dt", type=float, default=0.02,
                   help="max |dt| for nearest-timestamp pose association")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("bag-info")
    p.add_argument("--bag", required=True)
    p.set_defaults(fn=cmd_bag_info)

    p = sub.add_parser("convert-bag")
    p.add_argument("--bag", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--points-topic", default=None)
    p.add_argument("--imu-topic", default=None)
    p.add_argument("--scan-period", type=float, default=0.1)
    p.add_argument("--min-range", type=float, default=0.0,
                   help="drop points closer than this (self-returns)")
    p.set_defaults(fn=cmd_convert_bag)

    p = sub.add_parser("export-bag")
    p.add_argument("--log", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--points-topic", default="/velodyne_points")
    p.add_argument("--imu-topic", default="/imu/data")
    p.add_argument("--compression", default="bz2", choices=["none", "bz2"])
    p.set_defaults(fn=cmd_export_bag)

    p = sub.add_parser("plot-traj")
    p.add_argument("--est", required=True)
    p.add_argument("--gt", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--euler-csv", default=None,
                   help="also write t,yaw,pitch,roll CSV (transform_monitor.py output)")
    p.add_argument("--title", default="trajectory")
    p.set_defaults(fn=cmd_plot_traj)

    p = sub.add_parser("viz-normals")
    p.add_argument("--log", required=True)
    p.add_argument("--traj", required=True)
    p.add_argument("--out", required=True, help="features+normals PLY")
    p.add_argument("--map-out", default=None, help="local-map PLY")
    p.add_argument("--index", type=int, default=-1,
                   help="sweep index to associate (-1 = last)")
    p.add_argument("--frames", type=int, default=10,
                   help="how many previous sweeps build the local map")
    p.add_argument("--profile", default="indoor", choices=["indoor", "outdoor", "outdoor_64"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; `cpu` to run on the CPU)")
    p.set_defaults(fn=cmd_viz_normals)

    p = sub.add_parser("export-pcd")
    p.add_argument("--log", required=True)
    p.add_argument("--traj", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--leaf", type=float, default=0.2)
    p.set_defaults(fn=cmd_export_pcd)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
