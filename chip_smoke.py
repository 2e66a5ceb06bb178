#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lio_mapping_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

1. device: the card's name and power limit;
2. build: ``csrc/knn.cu``, ``csrc/eigh.cu``, ``csrc/lu_solve.cu`` and
   ``csrc/graph_if.cu`` compiled with ``nvcc`` for ``sm_90a`` from the
   sources in this checkout,
   one ``nvcc`` each, all started together (plus ``ptxas``'s register
   report);
3. kernel vs plain version on the card, at the shapes the main paths give
   the KNN: the estimator's 5-NN plane search (6144 queries against a
   24576-point voxel-filtered local map, with and without the 1.0 m^2 AABB
   gate), the scan-to-scan odometry's 1-NN searches (1024 vs 8192 surf,
   512 vs 4096 corner points) and LOAM's scan-to-map surf search (6144
   queries against the 65536-point map store, gated), the outdoor_64
   estimator's (8192 queries against a 32768-point local map, gated, from
   simulated HDL-64 sweeps), the 4D builder's corner search (2048 queries
   against the 65536-row corner store, gated) and a rank's searches of
   phase 15's 2-rank mesh
   (3072 queries against the 24576-point map, and against its 12288-row
   block when the map is sharded, gated), on inputs made by the port's own front end and
   ``insert_into_map`` from simulated sweeps; at the gated shapes also the
   kernel's tile flags against ``prune_flags``.
   Times from CUDA events after warm-up: the kernel's device work alone,
   the whole search as the main path calls it, one empty launch in the
   same loop, the plain version and a library yardstick; LOAM's scan-to-map
   corner search (2048 x 65536, pinned to the plain version) is timed too.
   After phase 7, each of the search's kernels under ``torch.profiler``.
   The ``eigh`` kernel (float64 Householder and implicit QL) against its
   plain version (float64 ``torch.linalg.eigh``) at n = 6, 15, 51, 81, 111
   and 128 on Wishart, graded and degenerate matrices, and (after phase 17)
   on the 6x6, 15x15 and 111x111 matrices of a real indoor sweep:
   eigenvalues, reconstruction, orthogonality, order, two launches' bits
   and the bits of ``eigh_tridiag_reference`` run on the card; the float64
   kernel against the plain version; on Wishart and graded matrices each
   eigenvalue against the float64 kernel's, relative to itself; on the real
   sweep's matrices what the step makes of them (the degeneracy projector,
   the pseudo-inverse, J^T J and J^T r of the prior) against what it makes
   of the plain version's. Its QL iterations, its time, the plain
   version's and ``torch.linalg.eigh``'s in float32, and its bound (~9 n^3
   flops).
   The LU solve kernel against its plain version (``torch.linalg.solve_ex``,
   cuSOLVER) and float64 ``torch.linalg.solve`` at n = 6, 96, 126 and 128
   on damped normal equations and (after phase 17) on the 6x6 and 126x126
   systems of a real indoor sweep: residual, error, two launches' bits,
   times and bound;
4. the main path: ``LioPipeline(LioConfig.indoor(), device="cuda")`` in
   float32 over a simulated 90-sweep indoor sequence (the ``cli simulate``
   defaults), from a cold start through INITED, each bootstrap sweep (front
   end and odometry, with or without the init window's push) one CUDA
   graph, each consumed INITED sweep one and each skipped one another (the
   default on the card, ``models/step_graph.py``; the GNs' and the LM's
   early exits are conditional nodes). The bootstrap's times are printed
   apart: ordinary sweeps, init-attempt sweeps and capture sweeps. Fails
   unless it ends INITED with ATE RMSE <= 0.35 m, the KNN kernel ran on the
   INITED sweeps, graphs replayed, no decision was read on the host,
   ``torch.linalg.eigh`` never ran on the card, the eigh kernel ran
   three times a consumed sweep and the LU kernel in every consumed sweep.
   Then a few more sweeps (a
   consumed and a skipped one each) under ``torch.profiler``, under the
   CUDA sync-debug mode and under per-stage timers (those on the eager
   step: ``graphs=False`` for that sweep) count launch calls, host syncs
   and stage times (and the device ms of the eigh and LU kernels beside
   the sweep's LM iterations and mini-GN rounds). Phase 17 follows it. Then the same 90 sweeps once
   more with the estimator's searches on the plain version (``make_knn5``
   patched here to ``force_tiled``), and once more, eagerly, with the
   step's ``eigh`` on its plain version (float64 cuSOLVER): their INITED
   sweep, ATE and each consumed sweep's LM iterations and mini-GN rounds
   are printed beside the kernels', not held;
5. the CLI in lio mode, each step a subprocess of ``python -m
   lio_mapping_tpu_torch.cli`` in a temporary directory: ``simulate`` 90
   sweeps, ``run --profile indoor`` with ``--map-out`` and
   ``--stats-json``, ``evaluate``. Fails unless the run ends INITED with
   ATE RMSE <= 0.35 m, a non-empty map and 89 pairs;
6. ``run --two-phase --timing`` on the same log: the same poses as phase 5
   (within 1e-4 m, |q.q'| > 1 - 1e-6), the same map voxel count, and the
   kernel launched in phase B;
7. ``run --mode loam`` on the same log, in this process so that the
   kernel's launches are counted by path, then ``evaluate``; graphed (a
   mapped and an associated sweep one CUDA graph each), then again with
   ``graphs=False``, each sweep timed and the host syncs of six steady
   sweeps counted. Fails above 0.05 m ATE RMSE, if the kernel did not run
   in the scan-to-map search, if a steady graphed sweep made a host sync,
   or unless both runs' poses and final states (sha256) are equal;
8. ``LioPipeline(LioConfig.outdoor_64())`` (KITTI HDL-64 profile, shipped
   capacities; identity ``extrinsic_rotation`` and zero
   ``extrinsic_translation``, the synthetic rig's truth) over 60 simulated
   64-ring sweeps of ``bench.py``'s trajectory. Fails unless it ends
   INITED no later than one consumed sweep after the JAX package's run on
   the CPU, with ATE RMSE <= twice that run's, and the kernel ran at 8192 x
   32768; then launches, host syncs and stage times of a consumed sweep;
9. the ``use_corner`` and ``use_corner`` + ``fix_map`` estimator variants
   of the indoor profile over phase 4's sequence. Each fails unless it ends
   INITED with ATE RMSE <= twice the JAX package's on the CPU, the surf
   searches launched the kernel, and the corner searches launched it never
   while the plain version ran for them;
10. ``run --enable-4d --out-4d --timing`` on phase 5's log, in this
   process: the LIO poses equal phase 5's, one 4D pose per consumed INITED
   sweep, 4D ATE RMSE < max(2 x the LIO ATE, 0.3 m) (the reference's rule),
   and the builder's searches, corner and surf, launched the kernel (its
   launches counted by shape too) and never the plain version. The builder's steps
   (one CUDA graph each) are timed, four of them with their host syncs
   counted (0 expected), and run once more on a ``graphs=False`` builder on
   the same inputs: poses and final state bit for bit;
11. the outdoor (KAIST rig) profile through the CLI as subprocesses:
   ``simulate --extrinsic-translation -2.4 0 0.7``, ``run --profile
   outdoor``, ``evaluate``, held as phase 5 is, against the JAX package's
   CLI on the CPU on the same log;
12. the ROS bag round trip of phase 5's log as subprocesses: ``export-bag``
   (bz2), ``bag-info`` (both topics, 90 sweeps and phase 5's IMU count),
   ``convert-bag`` (the converted log equals phase 5's item by item: points
   and IMU bit-equal, stamps within 1e-9 s, rel times equal; a second
   round trip leaves it byte-identical), then ``run --profile indoor
   --map-out --stats-json --timing`` on it: INITED, ATE RMSE <= 0.35 m, 89
   pairs. Its poses beside phase 5's are printed, not held: the bag stores
   ROS time in integer nanoseconds, which puts some IMU samples exactly on
   a pair's boundary (t + 0.05 s), and the float32 estimator amplifies
   that extra row;
13. the ring-annotated RS-LiDAR-32 rig (``SensorConfig.rs32_uneven()``'s
   fields as the ``sensor`` block of a YAML over the indoor estimator) at
   full width: 90 sweeps of 32 rings from -25 to 15 deg at 1800 azimuth
   steps (57,600 rays), each point's ``ring`` from the simulator's
   firing-major order, written as a bag with the port's ``BagWriter``;
   ``convert-bag``, then ``run --config rs32.yaml`` in this process (the
   kernel's launches counted by path) and ``evaluate``. Fails unless it
   ends INITED with ATE RMSE <= twice the JAX package's CLI on the same
   bag on the CPU; the same profile over phase 5's log (no rings) must
   raise the ring error;
14. ``viz-normals`` on phase 5's log and ground truth (``--frames 10``, the
   last sweep): once as a subprocess (feature and map PLYs written,
   normals of unit length), and in this process through
   ``cli.normals_view`` with the kernel and with the plain search forced.
   Fails unless the kernel was launched and at most 0.5% of the accepted
   rows differ (accepted by one only, or normals apart by more than 1e-4:
   KNN near-ties);
15. the distributed estimator, 2 ranks sharing the one card over gloo, on
   phase 5's log: ``run --mesh 2`` and ``run --mesh 2 --map-shard
   --ingest-shard`` as subprocesses, then ``run --mesh 2 --map-shard`` with
   ``use_corner`` on, its 2 ranks spawned from this script so that their
   searches are counted by path. Each fails unless it ends INITED with ATE
   RMSE <= 0.35 m, every rank ran on the card, the estimator's surf searches
   launched the kernel on both ranks, and the ranks' final states are
   bit-identical; the corner run also unless its corner searches launched
   the kernel never while the plain version ran for them. Printed beside
   phase 5's: the backend, the bytes copied through the host, the ATE, the
   median step and the collectives per consumed sweep;
16. the measurement tools (``lio_mapping_tpu_torch/tools``), each once as a
   ``python -m`` subprocess on the card, five at a time, at cut depths:
   ``bench`` (both profiles, 2 chunks of 6 sweeps, no warm-up step, no
   legacy companion), ``bench_cli`` (40 sweeps, the small config),
   ``profile_step``, ``ab_flags`` (the four variants over 56 sweeps),
   ``bench_scaling`` (1 and 2 ranks sharing the card, 5 steps) and
   ``debug_corner`` (its four modes). Fails unless every tool exits 0 and
   names the card, ``bench``'s indoor and outdoor_64 frames/s are above 0
   with their ``dispatch_floor_ms``, ``profile_step``'s KNN row launched
   the kernel, ``bench_scaling`` ran 1 and 2 ranks, and each
   ``debug_corner`` RMSE is at most twice the JAX tool's on the CPU. Their
   times are printed, not held: five tools share the card and the cores;
17. phase 4's 90 sweeps on a ``graphs=False`` pipeline, run right after
   phase 4: fails unless its poses (bit for bit), INITED sweep, ATE and
   final-state sha256 equal phase 4's graphed run. The same extra sweeps
   are counted, and both paths' launch calls, graph launches, host syncs,
   wall and device-busy ms per consumed sweep, the graphs' memory, and
   phase 4's captures and steady mean are printed; fails unless a steady
   graphed consumed sweep made 0 host syncs and 1 graph launch. Then a
   fresh graphed and a fresh ``graphs=False`` pipeline take the sequence's
   first 18 sweeps, the last 6 (a push among them, no init attempt)
   counted: launch calls, graph launches, host syncs and device busy ms;
   fails unless each graphed one made 1 graph launch and 0 host syncs.

The counters and timers (``timed``, ``count_launches``, ...) are
``lio_mapping_tpu_torch/utils/profiling.py``'s; those that know the
estimator's stages and the KNN's paths (``stage_breakdown``,
``launches_by_path``, ...) are ``lio_mapping_tpu_torch/tools/profiling.py``'s.
The sweeps of phases 4, 8 and 13 are simulated in worker processes, and
phases 5 and 11's ``simulate`` subprocesses run side by side, before any
timed work of their phases.

The line before the last is the kernel table as one JSON object (``knn``,
``eigh`` and ``lu_solve``, each with its launches by path); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from lio_mapping_tpu_torch import cli, native  # noqa: E402
from lio_mapping_tpu_torch.config import LioConfig  # noqa: E402
from lio_mapping_tpu_torch.io import evaluation, synthetic  # noqa: E402
from lio_mapping_tpu_torch.io import rosbag as RB  # noqa: E402
from lio_mapping_tpu_torch.models import estimator as EST  # noqa: E402
from lio_mapping_tpu_torch.models import map_builder as MB  # noqa: E402
from lio_mapping_tpu_torch.models import mapping as MAP  # noqa: E402
from lio_mapping_tpu_torch.models import odometry as ODO  # noqa: E402
from lio_mapping_tpu_torch.models import pipeline as PL  # noqa: E402
from lio_mapping_tpu_torch.models.pipeline import LioPipeline  # noqa: E402
from lio_mapping_tpu_torch.models.point_processor import process_sweep  # noqa: E402
from lio_mapping_tpu_torch.models import step_graph as SG  # noqa: E402
from lio_mapping_tpu_torch.ops import eigh as EIGH  # noqa: E402
from lio_mapping_tpu_torch.ops import gn as GN  # noqa: E402
from lio_mapping_tpu_torch.ops import knn as KNN  # noqa: E402
from lio_mapping_tpu_torch.ops import knn_kernel  # noqa: E402
from lio_mapping_tpu_torch.ops import lu_solve as LU  # noqa: E402
from lio_mapping_tpu_torch.ops import marginalization as MG  # noqa: E402
from lio_mapping_tpu_torch.ops import voxel as VX  # noqa: E402
from lio_mapping_tpu_torch.utils.profiling import (  # noqa: E402
    count_launches, count_syncs, cuda_ms, device_kernel_ms, timed)
from lio_mapping_tpu_torch.utils.se3 import Pose  # noqa: E402
from lio_mapping_tpu_torch.utils.tree import tree_leaves  # noqa: E402
from lio_mapping_tpu_torch.tools import last_json  # noqa: E402
from lio_mapping_tpu_torch.tools.profiling import (  # noqa: E402
    kernel_shapes, launches_by_path, plain_searches, stage_breakdown)

DEV = torch.device("cuda")
SEED = 0
N_SWEEPS = 90          # the verify recipe's sequence length
N_EXTRA = 6            # sweeps after the main run: launches, syncs, stage times
N_BOOT_WARM = 12       # bootstrap sweeps before the counted ones (both graphs captured)
N_BOOT_COUNTED = 6     # bootstrap sweeps counted (launches and syncs), a push among them
SCAN_DT = 0.1
IMU_RATE = 200.0
ATE_LIMIT = 0.35       # m: twice the reference's 0.1765 m on this sequence
LOAM_ATE_LIMIT = 0.05  # m: 2.4x the reference's 0.021 m (LOAM) on this sequence
LOAM_SYNC_SWEEPS = range(20, 26)   # phase 7's sweeps whose host syncs are counted
BUILDER_SYNC_STEPS = range(2, 6)   # phase 10's builder steps whose host syncs are counted
# the JAX package on the CPU in float32 on exactly these sequences
# (tools/reference_ate_cpu.py); each limit is twice the reference's ATE
N_O64 = 60             # outdoor_64 sweeps: 24 fill the window, ~12 consumed INITED after
N_O64_EXTRA = 9        # sweeps after it: three consumed ones to count on
O64_REF_INITED_AT = 21
O64_REF_ATE = 0.20191269725271987
CORNER_REF_ATE = {"corner": 0.1361345035297154, "corner_fixmap": 0.13884461462875794}
# the KAIST-rig CLI run (`--cli-outdoor`): INITED, but 2.04 m; the outdoor
# profile (window 7, every third sweep consumed, a 2.4 m lever arm) drifts
# in the simulated box room
OUTDOOR_REF_ATE = 2.0356583933705297
FOUR_D_FLOOR = 0.3     # m: 4D ATE < max(2 x LIO ATE, 0.3) (tests/test_cli_e2e.py:99-101)
# the JAX package's CLI on the CPU in float32 (`--cli-bag`, `--cli-rs32`):
# both INITED on the 50th measurement pair
BAG_REF_ATE = 0.18229904947049347   # phase 5's log after export-bag + convert-bag
RS32_REF_ATE = 0.576324505536864    # the RS-32 bag of phase 13
REF_INITED_AT_PAIR = 50
# SensorConfig.rs32_uneven() as a YAML sensor block, and the rig's scan:
# 0.2 deg azimuth steps at 10 Hz
RS32_SENSOR = {"n_rings": 32, "lower_bound_deg": -25.0, "upper_bound_deg": 15.0,
               "max_points_per_ring": 2304, "uneven": True}
RS32_AZIMUTH = 1800
VIZ_FRAMES = 10
VIZ_MAX_DIFF_ROWS = 0.005  # of the accepted rows: KNN near-ties
SIM_WORKERS = 6            # processes that simulate sweeps (the machine has 8 cores)
# the JAX package's tools/debug_corner.py on the CPU in float64 (RMSE of each
# mode over its INITED sweeps); phase 16 holds the port's within twice these
DEBUG_CORNER_REF_RMSE = {"default": 0.01761344168616935, "fixmap": 0.019836333978583375,
                         "corner": 0.016772006869240512, "both": 0.01888650206216301}
TOOL_LANES = 5             # phase 16's tools run this many at a time
TOOL_TIMEOUT_S = 600
GATE = 1.0             # estimator min_match_sq_dis (m^2), the kernel's prune gate
# H100 SXM data-sheet peaks (at 700 W): HBM rate, f32 rate outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
FLOP_PER_PAIR = 9      # 3 FMAs for q.p, one add, one FMA: 9 flops
DEVICE_KERNELS_PER_SEARCH = 2  # bounds, search (csrc/knn.cu; the search merges)
# the whole search (``wrapper_ms``) of the first version of csrc/knn.cu (one
# thread per query, prune flags in PyTorch) at these shapes, on an NVIDIA
# H100 80GB HBM3 at 700 W, printed beside the current one
ONE_THREAD_PER_QUERY_WRAPPER_MS = {"estimator_5nn": 0.9564, "estimator_5nn_gated": 0.6979,
                                   "odometry_surf_1nn": 0.1635, "odometry_corner_1nn": 0.0848}
F32_EPS = float(np.finfo(np.float32).eps)
# the eigh kernel against float64 torch.linalg.eigh (tests/test_torch_cuda.py):
# eigenvalues within this many ulps of max |lambda|, reconstruction
# (relative, Frobenius) and orthogonality within EIGH_VEC_TOL (float32) and
# EIGH_VEC_TOL64 (the float64 kernel); on Wishart and graded matrices each
# float32 eigenvalue within EIGH_SELF_REL of the float64 kernel's, relative
# to itself; on the matrices of a real sweep, what the step makes of the
# decomposition within EIGH_STEP_TOL of what it makes of the plain
# version's (tests/test_torch_eigh.py's tolerances, relative to the largest
# entry)
EIGH_VAL_ULPS = 64
EIGH_VEC_TOL = 2e-4
EIGH_VEC_TOL64 = 1e-12
EIGH_SELF_REL = 1e-4
EIGH_STEP_TOL = {"proj": 1e-4, "pinv": 1e-3, "jtj": 64 * F32_EPS, "jtr": 1e-3}
# the orders the step decomposes: the mini-GN's A^T A, the equilibrated
# A_mm, the Schur complement (indoor 15 x 7 + 6; outdoor_64 15 x 5 + 6; the
# tests' small config 15 x 3 + 6) and the kernel's limit
EIGH_ORDERS = (6, 15, 51, 81, 111, 128)
# the orders the step solves: the mini-GN's 6x6, the window LM's damped
# system (outdoor_64 15 x 6 + 6, indoor 15 x 8 + 6) and the kernel's limit
SOLVE_ORDERS = (6, 96, 126, 128)
# the profiler's names of the eigh and LU kernels (csrc/eigh.cu, csrc/lu_solve.cu)
LINALG_KERNELS = ("tridiag_eigh_kernel", "lu_solve_kernel")


def log(msg: str):
    print(msg, flush=True)


def sim_trajectory():
    return synthetic.Trajectory(pitch_amp=0.4, roll_amp=0.35, rp_freq=0.45)


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------


def rings_of(cfg):
    """``simulate_sweep``'s ring arguments for a profile's sensor."""
    s = cfg.sensor
    return dict(n_rings=s.n_rings, lower_deg=s.lower_bound_deg, upper_deg=s.upper_bound_deg)


def window_feats(traj, cfg, n: int):
    """The port's front-end features of ``n`` consumed sweeps (``odom_io``
    sweeps apart), each with its ground-truth pose as (Rotation, p, Pose)."""
    from scipy.spatial.transform import Rotation

    feats = []
    for i in range(n):
        t0 = 0.5 + cfg.estimator.odom_io * SCAN_DT * i
        xyz, mask = synthetic.simulate_sweep(traj, t0, n_azimuth=900, **rings_of(cfg))
        f = process_sweep(torch.as_tensor(xyz[:, :3], dtype=torch.float32, device=DEV),
                          torch.as_tensor(mask, device=DEV), cfg)
        q, p = synthetic.gt_sensor_pose(traj, t0 + SCAN_DT)
        feats.append((f, Rotation.from_quat(np.roll(q, -1)), p,
                      Pose(torch.as_tensor(q, dtype=torch.float32, device=DEV),
                           torch.as_tensor(p, dtype=torch.float32, device=DEV))))
    return feats


def estimator_inputs(feats, cfg, rng):
    """The estimator's 5-NN search inputs: all but the newest voxel-filtered
    surf stack moved into one frame and voxel-filtered again (as
    models/estimator.local_map builds it), and the newest stack at a
    slightly wrong pose as the queries. Returns (queries, q_mask, map,
    map_mask, the wrong pose)."""
    from scipy.spatial.transform import Rotation

    e = cfg.estimator
    stacks = []
    for f, rot, p, _ in feats:
        sx, sm, _ = VX.voxel_downsample(f.surf_less_flat.xyz, f.surf_less_flat.mask,
                                        e.surf_filter_size, e.surf_stack_cap)
        r = torch.as_tensor(rot.as_matrix(), dtype=torch.float32, device=DEV)
        t = torch.as_tensor(p, dtype=torch.float32, device=DEV)
        stacks.append((sx @ r.T + t, sm))
    map_xyz, map_mask, _ = VX.voxel_downsample(
        torch.cat([s[0] for s in stacks[:-1]]), torch.cat([s[1] for s in stacks[:-1]]),
        e.surf_filter_size, e.local_map_filtered_cap)
    ang = rng.normal(size=3) * math.radians(0.5)
    dr = torch.as_tensor(Rotation.from_rotvec(ang).as_matrix(), dtype=torch.float32, device=DEV)
    dt = torch.as_tensor(rng.normal(size=3) * 0.03, dtype=torch.float32, device=DEV)
    q_xyz = (stacks[-1][0] @ dr.T + dt).contiguous()
    q_mask = stacks[-1][1].contiguous()
    wrong = Pose(torch.as_tensor(np.roll(Rotation.from_rotvec(ang).as_quat(), 1),
                                 dtype=torch.float32, device=DEV), dt)
    return q_xyz, q_mask, map_xyz.contiguous(), map_mask.contiguous(), wrong


def knn_cases(traj, cfg):
    """Main-path KNN inputs, made by the port's front end, voxel filter and
    map store: ([(name, queries, q_mask, db, db_mask, k, prune_beyond)],
    the scan-to-map corner search's (queries, q_mask, db, db_mask)), on the
    card."""
    e, m = cfg.estimator, cfg.mapping
    feats = window_feats(traj, cfg, e.window_size + 1)
    q_xyz, q_mask, map_xyz, map_mask, wrong = estimator_inputs(
        feats, cfg, np.random.default_rng(SEED))

    # LOAM scan-to-map: the map stores (65536 rows) filled by insert_into_map
    # with 12 sweeps' feature clouds at their poses, and the newest sweep's
    # voxel-filtered stacks at a slightly wrong pose (mapping.py:164, :153)
    stores = {}
    for kind, leaf, cap in (("surf", m.surf_filter_size, e.surf_stack_cap),
                            ("corner", m.corner_filter_size, e.corner_stack_cap)):
        vm = MAP.VoxelMapStore.empty(m.map_cloud_cap, torch.float32, DEV)
        for f, _, _, pose in feats[:-1]:
            c = f.surf_less_flat if kind == "surf" else f.corner_less_sharp
            cx, cm, _ = VX.voxel_downsample(c.xyz, c.mask, leaf, cap)
            vm = MAP.insert_into_map(vm, cx, cm, pose, leaf, cfg)
        c = feats[-1][0].surf_less_flat if kind == "surf" else feats[-1][0].corner_less_sharp
        cx, cm, _ = VX.voxel_downsample(c.xyz, c.mask, leaf, cap)
        stores[kind] = ((wrong @ feats[-1][3]).apply(cx).contiguous(), cm.contiguous(),
                        vm.xyz.contiguous(), vm.mask.contiguous())

    f_a, f_b = feats[0][0], feats[1][0]
    cases = [
        ("estimator_5nn", q_xyz, q_mask, map_xyz, map_mask, 5, None),
        ("estimator_5nn_gated", q_xyz, q_mask, map_xyz, map_mask, 5, GATE),
        ("odometry_surf_1nn", f_b.surf_flat.xyz.contiguous(), f_b.surf_flat.mask.contiguous(),
         f_a.surf_less_flat.xyz.contiguous(), f_a.surf_less_flat.mask.contiguous(), 1, None),
        ("odometry_corner_1nn", f_b.corner_sharp.xyz.contiguous(),
         f_b.corner_sharp.mask.contiguous(), f_a.corner_less_sharp.xyz.contiguous(),
         f_a.corner_less_sharp.mask.contiguous(), 1, None),
        ("mapping_5nn_gated", *stores["surf"], 5, cfg.mapping.min_match_sq_dis),
        # the 4D builder's corner search (LOAM's stays on the plain version)
        ("builder_corner_5nn_gated", *stores["corner"], 5, cfg.mapping.min_match_sq_dis),
        # a rank of phase 15's 2-rank mesh: its half of the stack's rows
        # against the whole map, and against its half of the map's rows
        # (one ring step of the map-sharded search)
        ("estimator_mesh2_5nn_gated", q_xyz[:len(q_xyz) // 2], q_mask[:len(q_xyz) // 2],
         map_xyz, map_mask, 5, GATE),
        ("estimator_mesh2_block_5nn_gated", q_xyz[:len(q_xyz) // 2], q_mask[:len(q_xyz) // 2],
         map_xyz[:len(map_xyz) // 2], map_mask[:len(map_xyz) // 2], 5, GATE),
    ]
    return cases, stores["corner"]


def outdoor64_cfg():
    """``LioConfig.outdoor_64()`` at its shipped capacities, with
    ``bench.py``'s two synthetic-rig concessions: the simulated rig's
    laser and body frames coincide."""
    base = LioConfig.outdoor_64()
    return dataclasses.replace(base, estimator=dataclasses.replace(
        base.estimator, extrinsic_rotation=(1, 0, 0, 0, 1, 0, 0, 0, 1),
        extrinsic_translation=(0.0, 0.0, 0.0)))


def outdoor64_case():
    """The outdoor_64 estimator's search: 8192 queries (one surf stack of
    simulated HDL-64 sweeps) against the 32768-row local map of the 7 frames
    before it, gated at 1 m^2."""
    cfg = outdoor64_cfg()
    feats = window_feats(synthetic.Trajectory(g_norm=cfg.estimator.imu.g_norm), cfg,
                         cfg.estimator.window_size + 1)
    q_xyz, q_mask, map_xyz, map_mask, _ = estimator_inputs(
        feats, cfg, np.random.default_rng(SEED + 1))
    return ("estimator64_5nn_gated", q_xyz, q_mask, map_xyz, map_mask, 5, GATE)


def corner_plain(q, qm, db, dbm):
    """LOAM's scan-to-map corner search, pinned to the plain version on the
    card as the reference pins it: its time, beside the kernel's on the
    same inputs (the 4D builder's path: ``builder_corner_5nn_gated``) and
    the library yardstick."""
    row = {"case": "mapping_corner_5nn_plain", "Q": q.shape[0], "M": db.shape[0], "k": 5,
           "valid_q": int(qm.sum()), "valid_m": int(dbm.sum()),
           "plain_ms": cuda_ms(lambda: KNN.knn_tiled(q, qm, db, dbm, k=5), DEV, reps=5),
           "kernel_wrapper_ms": cuda_ms(lambda: knn_kernel.knn_cuda(q, qm, db, dbm, k=5,
                                                                    prune_beyond=GATE), DEV),
           "library_ms": cuda_ms(lambda: library_knn(q, qm, db, dbm, 5), DEV, reps=5)}
    log("corner_plain " + json.dumps(row))
    return row


def library_knn(q, qm, db, dbm, k):
    """Yardstick only (the port never calls it): torch.cdist + topk."""
    d = torch.cdist(q, db).square()
    d = d.masked_fill(~dbm[None, :], math.inf)
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    return torch.where(qm[:, None], vals, math.inf), idx


def check_case(name, q, qm, db, dbm, k, gate):
    """Kernel against the plain version on one input; returns the row of
    the kernel table for this shape."""
    got_d, got_i, flags = knn_kernel.search(q, qm, db, dbm, k=k, prune_beyond=gate)
    ref_d, ref_i = KNN.knn_tiled(q, qm, db, dbm, k=k)
    torch.cuda.synchronize()
    flags = flags.cpu().numpy()
    if gate is not None:
        want = knn_kernel.prune_flags(q, qm, db, dbm, gate).cpu().numpy()
        if not np.array_equal(flags, want):
            raise AssertionError(f"{name}: the kernel's tile flags differ from prune_flags "
                                 f"({int(np.sum(flags != want))} of {flags.size})")
    got_d, got_i = got_d.cpu().numpy(), got_i.cpu().numpy().astype(np.int64)
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy().astype(np.int64)
    qn, dn = q.cpu().numpy().astype(np.float64), db.cpu().numpy().astype(np.float64)
    qmn, dmn = qm.cpu().numpy(), dbm.cpu().numpy()
    # f32 tolerance: |q|^2 + |p|^2 - 2 q.p cancels; a few ulps of the
    # largest term bound both versions' rounding
    scale = float((qn[qmn] ** 2).sum(1).max() + (dn[dmn] ** 2).sum(1).max())
    tol = 8 * F32_EPS * scale
    if gate is None:
        rows = qmn
    else:
        # gated exactness: rows whose true k-th neighbour is within the gate
        # are exact; the others must test beyond the gate
        rows = qmn & (ref_d[:, k - 1] < gate - tol)
        beyond = qmn & (ref_d[:, k - 1] >= gate + tol)
        if np.any(got_d[beyond, k - 1] < gate - tol):
            raise AssertionError(f"{name}: a beyond-gate row reports a k-th distance inside")
    if not np.all(np.isinf(got_d[~qmn])):
        raise AssertionError(f"{name}: masked queries must report +inf")
    fin = rows[:, None] & np.isfinite(ref_d)
    if not np.array_equal(np.isfinite(got_d[rows]), np.isfinite(ref_d[rows])):
        raise AssertionError(f"{name}: finite pattern differs from the plain version")
    err = float(np.max(np.abs(got_d[fin] - ref_d[fin]), initial=0.0))
    if err > tol:
        raise AssertionError(f"{name}: max |d_kernel - d_plain| = {err:.3e} > {tol:.3e}")
    # tie-robust index check: the chosen points' exact distances agree rank
    # by rank (equal up to f32 near-ties)
    d_got = np.sum((qn[:, None] - dn[got_i]) ** 2, axis=-1)
    d_ref = np.sum((qn[:, None] - dn[ref_i]) ** 2, axis=-1)
    idx_err = float(np.max(np.abs(d_got[fin] - d_ref[fin]), initial=0.0))
    if idx_err > 2 * tol:
        raise AssertionError(f"{name}: neighbour sets differ ({idx_err:.3e} > {2 * tol:.3e})")
    same_idx = float(np.mean(np.all(got_i[rows] == ref_i[rows], axis=1))) if rows.any() else 1.0

    # timings: the kernel's device work (buffers made once), the wrapper, an
    # empty launch, the plain version, and the library yardstick
    lib = knn_kernel._load()
    q_n, m_n = q.shape[0], db.shape[0]
    n_qb, n_ch = flags.shape
    out_d = torch.empty((q_n, k), dtype=torch.float32, device=DEV)
    out_i = torch.empty((q_n, k), dtype=torch.int32, device=DEV)
    n_scratch = knn_kernel.scratch_bytes(q_n, m_n, k)
    if n_scratch != lib.lio_knn_scratch_bytes(q_n, m_n, k):
        raise AssertionError(f"{name}: scratch size differs between the wrapper and knn.cu")
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    gate_f = math.inf if gate is None else gate

    def raw():
        err_code = lib.lio_knn_f32(q.data_ptr(), qm.data_ptr(), db.data_ptr(), dbm.data_ptr(),
                                   q_n, m_n, k, gate_f, out_d.data_ptr(), out_i.data_ptr(),
                                   scratch.data_ptr(), n_scratch, stream)
        if err_code:
            raise RuntimeError(f"{name}: kernel launch failed, cudaError {err_code}")

    def noop():
        err_code = lib.lio_noop(stream)
        if err_code:
            raise RuntimeError(f"empty launch failed, cudaError {err_code}")

    ms, raw_host_ms = timed(raw, DEV)
    empty_launch_ms = cuda_ms(noop, DEV)
    wrapper_ms, wrapper_host_ms = timed(
        lambda: knn_kernel.knn_cuda(q, qm, db, dbm, k=k, prune_beyond=gate), DEV)
    plain_ms = cuda_ms(lambda: KNN.knn_tiled(q, qm, db, dbm, k=k), DEV, reps=5)
    library_ms = cuda_ms(lambda: library_knn(q, qm, db, dbm, k), DEV, reps=5)

    # bound: pairs this data needs (valid queries x valid points, in the
    # chunks the gate keeps), and each input byte read / output written once
    qb = np.zeros(-(-q_n // knn_kernel.BQ) * knn_kernel.BQ, bool)
    qb[:q_n] = qmn
    cb = np.zeros(-(-m_n // knn_kernel.BM) * knn_kernel.BM, bool)
    cb[:m_n] = dmn
    per_qb = qb.reshape(-1, knn_kernel.BQ).sum(1).astype(np.float64)
    per_cb = cb.reshape(-1, knn_kernel.BM).sum(1).astype(np.float64)
    # flagged tiles: pruned by the gate, or without a valid pair
    keep = 1.0 - flags.astype(np.float64)
    pairs = float(per_qb @ keep @ per_cb)
    # CTAs: bounds (one per block and chunk), search (one per 32-query group
    # and chunk; those of a kept tile with a live query search, and one per
    # group merges)
    n_groups = -(-q_n // knn_kernel.QPC)
    qg = np.zeros(n_groups * knn_kernel.QPC, bool)
    qg[:q_n] = qmn
    live_group = qg.reshape(n_groups, knn_kernel.QPC).any(1)
    kept = ~flags.astype(bool)[np.arange(n_groups) * knn_kernel.QPC // knn_kernel.BQ]
    ctas = {"bounds": n_qb + n_ch, "search": n_groups * n_ch,
            "search_working": int((kept & live_group[:, None]).sum()), "merging": n_groups}
    flops = FLOP_PER_PAIR * pairs
    n_bytes = q_n * (12 + 1) + m_n * (12 + 1) + q_n * k * 8
    t_ops, t_bytes = flops / PEAK_F32_FLOP_S, n_bytes / PEAK_BYTES_S
    row = {
        "case": name, "Q": q_n, "M": m_n, "k": k, "prune_beyond": gate,
        "valid_q": int(qmn.sum()), "valid_m": int(dmn.sum()),
        "pairs": pairs, "max_abs_err": err, "tol": tol, "idx_dist_err": idx_err,
        "rows_checked": int(rows.sum()), "same_idx_rows": same_idx,
        "tiles_skipped": int(flags.sum()), "tiles": int(flags.size), "ctas": ctas,
        "device_kernels_per_search": DEVICE_KERNELS_PER_SEARCH,
        "kernel_ms": ms, "kernel_host_ms": raw_host_ms, "wrapper_ms": wrapper_ms,
        "wrapper_host_ms": wrapper_host_ms,
        "one_thread_per_query_wrapper_ms": ONE_THREAD_PER_QUERY_WRAPPER_MS.get(name),
        "empty_launch_ms": empty_launch_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    log("knn_check " + json.dumps(row))
    return row, raw


def eigh_synthetic(n: int, seed: int):
    """(name, float32 matrix on the card) cases of order ``n``: a Wishart
    matrix, a graded one (column scales over six decades: bias-like blocks
    near 1e12, as the Schur complements carry) and a degenerate one with
    repeated eigenvalues (half zero, the rest in pairs)."""
    rng = np.random.default_rng(seed)
    j = rng.normal(size=(2 * n, n))
    wish = j.T @ j
    jg = j * 10.0 ** rng.uniform(0.0, 6.0, size=n)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.zeros(n)
    ev[n // 2:] = (np.arange(n - n // 2) // 2 + 1).astype(np.float64)
    return [(f"wishart_{n}", wish), (f"graded_{n}", jg.T @ jg),
            (f"degenerate_{n}", q @ np.diag(ev) @ q.T)]


def _eigh_errors(a, vals, vecs, ref_vals):
    """(eigenvalue error, scale, reconstruction, orthogonality, ascending)
    of (vals, vecs) of ``a`` against ``ref_vals`` (float64)."""
    n = a.shape[-1]
    a64, v64, w64 = a.double(), vals.double(), vecs.double()
    scale = float(ref_vals.abs().max())
    err = float((v64 - ref_vals).abs().max())
    rec = float(torch.linalg.norm(w64 @ torch.diag(v64) @ w64.T - a64)
                / max(float(torch.linalg.norm(a64)), 1e-30))
    orth = float((w64.T @ w64 - torch.eye(n, dtype=torch.float64, device=DEV)).abs().max())
    return err, scale, rec, orth, bool((vals[1:] >= vals[:-1]).all())


def eigh_step_invariants(kind, extra, vals, vecs):
    """What the step makes of (vals, vecs), in float64: the mini-GN's
    degeneracy projector (``gn``), the marginalization's pseudo-inverse of
    the equilibrated block (``pinv``, ``extra`` its scales) or J^T J, J^T r
    of the prior's factor (``factor``, ``extra`` the right-hand side)."""
    vals, vecs = vals.double(), vecs.double()
    if kind == "gn":
        g = GN.projection_from_eigh(vals, vecs, 100.0)
        return {"proj": g.proj, "degenerate": bool(g.is_degenerate)}
    extra = extra.double()
    if kind == "pinv":
        return {"pinv": MG.pinv_from_eigh(vals, vecs, extra, MG.EPS)}
    jac, res = MG.factor_from_eigh(vals, vecs, extra)
    return {"jtj": jac.T @ jac, "jtr": jac.T @ res}


def check_eigh(name, a, step=None):
    """The eigh kernel on one float32 matrix on the card, against its
    plain version (``eigh_plain``: float64 ``torch.linalg.eigh``); its bits
    against ``eigh_tridiag_reference`` run on the card (the same operations);
    the float64 kernel against the plain version; on Wishart and graded
    matrices each eigenvalue against the float64 kernel's; with ``step``
    ((kind, extra), a real sweep's matrix) what the step makes of it
    (:func:`eigh_step_invariants`). Fails outside the stated tolerances.
    Returns its row: errors, QL iterations, times (kernel, plain, library:
    ``torch.linalg.eigh`` in float32) and bound."""
    n = a.shape[-1]
    vals, vecs, iters = EIGH.eigh_cuda(a, with_sweeps=True)
    v2, w2 = EIGH.eigh_cuda(a)
    pv, pw = EIGH.eigh_plain(a.double())
    rv, rw, r_iters = EIGH.eigh_tridiag_reference(a)
    torch.cuda.synchronize()
    iters = int(iters)
    deterministic = torch.equal(vals, v2) and torch.equal(vecs, w2)
    reference_bits = torch.equal(vals, rv) and torch.equal(vecs, rw) and r_iters == iters
    err, scale, rec, orth, ascending = _eigh_errors(a, vals, vecs, pv)
    failed = []
    if not (err <= EIGH_VAL_ULPS * F32_EPS * scale and rec <= EIGH_VEC_TOL
            and orth <= EIGH_VEC_TOL and ascending and deterministic and reference_bits):
        failed.append(f"eigenvalue error {err:.3e} (scale {scale:.3e}), reconstruction "
                      f"{rec:.3e}, orthogonality {orth:.3e}, ascending {ascending}, "
                      f"deterministic {deterministic}, reference bits {reference_bits}")
    row = {"case": name, "n": n, "ql_iterations": iters, "max_abs_err": err, "scale": scale,
           "rel_err": err / max(scale, 1e-30), "reconstruction": rec, "orthogonality": orth,
           "reference_bits": reference_bits}
    if n <= EIGH.MAX_N_F64:
        v64, w64 = EIGH.eigh_cuda(a.double())
        err64, _, rec64, orth64, asc64 = _eigh_errors(a, v64, w64, pv)
        row.update(f64_max_abs_err=err64, f64_reconstruction=rec64, f64_orthogonality=orth64)
        if not (err64 <= EIGH_VAL_ULPS * 2.0 ** -52 * scale and rec64 <= EIGH_VEC_TOL64
                and orth64 <= EIGH_VEC_TOL64 and asc64):
            failed.append(f"float64 kernel: eigenvalue error {err64:.3e}, reconstruction "
                          f"{rec64:.3e}, orthogonality {orth64:.3e}, ascending {asc64}")
        if name.split("_")[0] in ("wishart", "graded"):
            row["self_rel_err"] = float(((vals.double() - v64).abs() / v64.abs()).max())
            if not row["self_rel_err"] <= EIGH_SELF_REL:
                failed.append(f"eigenvalues relative to the float64 kernel's "
                              f"{row['self_rel_err']:.3e}")
    if step is not None:
        mine = eigh_step_invariants(*step, vals, vecs)
        plain = eigh_step_invariants(*step, pv, pw)
        row["step_rel_err"] = {}
        for key, value in mine.items():
            if isinstance(value, bool):
                row["step_rel_err"][key] = value == plain[key]
                ok = value == plain[key]
            else:
                rel = float((value - plain[key]).abs().max()
                            / max(float(plain[key].abs().max()), 1e-300))
                row["step_rel_err"][key] = rel
                ok = rel <= EIGH_STEP_TOL[key]
            if not ok:
                failed.append(f"the step's {key}: {row['step_rel_err'][key]}")
    if failed:
        raise AssertionError(f"eigh {name}: " + "; ".join(failed))
    ms = cuda_ms(lambda: EIGH.eigh_cuda(a), DEV, reps=50)
    plain_ms = cuda_ms(lambda: EIGH.eigh_plain(a), DEV, reps=20)
    library_ms = cuda_ms(lambda: torch.linalg.eigh(a), DEV, reps=20)
    # bound: the matrix read once, the values and vectors written once;
    # ~9 n^3 flops, what a tridiagonal eigh with vectors needs
    flops = 9.0 * n ** 3
    n_bytes = 4.0 * (n * n + n + n * n)
    t_ops, t_bytes = flops / PEAK_F32_FLOP_S, n_bytes / PEAK_BYTES_S
    row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log("eigh_check " + json.dumps(row))
    return row


def sweep_eigh_step(n, mats):
    """(kind, extra) of the step's order-``n`` matrix of a real sweep: the
    mini-GN's A^T A (6), the equilibrated A_mm (15, scales 1) or the Schur
    complement (the prior's right-hand side, recorded beside it)."""
    if n == 6:
        return "gn", None
    if n == 15:
        return "pinv", torch.ones(n, dtype=torch.float64, device=DEV)
    return "factor", mats["prior"][n][1]


@contextlib.contextmanager
def last_inputs(module, attr: str, last: dict):
    """Inside the block ``module.attr`` keeps a copy of the last arguments
    it was given for each order (``last[n]``): the matrices of the sweeps
    run inside it."""
    orig = getattr(module, attr)

    def record(*args):
        last[args[0].shape[-1]] = tuple(a.detach().clone() for a in args)
        return orig(*args)

    setattr(module, attr, record)
    try:
        yield last
    finally:
        setattr(module, attr, orig)


def check_solve(name, a, b):
    """The LU kernel against its plain version (``torch.linalg.solve_ex``,
    cuSOLVER) and float64 ``torch.linalg.solve`` on one float32 system on
    the card; fails unless its residual is within 64 ulps of |A| |x| and
    its error within 4x the plain version's. Returns its row."""
    n = a.shape[-1]
    x = LU.solve_cuda(a, b)
    x2 = LU.solve_cuda(a, b)
    plain = LU.solve_plain(a, b)
    ref = torch.linalg.solve(a.double(), b.double())
    torch.cuda.synchronize()
    a64, x64 = a.double(), x.double()
    res = float((a64 @ x64 - b.double()).abs().max())
    scale = float((a64.abs() @ x64.abs()).max())
    err = float((x64 - ref).abs().max())
    err_plain = float((plain.double() - ref).abs().max())
    if not (res <= 64 * F32_EPS * scale and torch.equal(x, x2)
            and err <= max(4 * err_plain, 64 * F32_EPS * float(ref.abs().max()))):
        raise AssertionError(f"solve {name}: residual {res:.3e} (scale {scale:.3e}), error "
                             f"{err:.3e} against the plain version's {err_plain:.3e}")
    ms = cuda_ms(lambda: LU.solve_cuda(a, b), DEV, reps=50)
    plain_ms = cuda_ms(lambda: LU.solve_plain(a, b), DEV, reps=50)
    library_ms = cuda_ms(lambda: torch.linalg.solve(a, b), DEV, reps=20)
    # bound: A and b read once, x written once; (2/3) n^3 + 2 n^2 flops
    flops = 2.0 * n ** 3 / 3.0 + 2.0 * n * n
    n_bytes = 4.0 * (n * n + 2 * n)
    t_ops, t_bytes = flops / PEAK_F32_FLOP_S, n_bytes / PEAK_BYTES_S
    row = {"case": name, "n": n, "max_abs_err": err, "plain_err": err_plain, "residual": res,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": 1e3 * max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log("solve_check " + json.dumps(row))
    return row


def solve_synthetic(n: int, seed: int):
    """An LM-like damped system of order ``n`` on the card (float32)."""
    rng = np.random.default_rng(seed)
    j = rng.normal(size=(3 * n, n)) * 10.0 ** rng.uniform(0.0, 3.0, size=n)
    a = j.T @ j
    a += 1e-4 * np.diag(np.diag(a))
    return (torch.as_tensor(a, dtype=torch.float32, device=DEV),
            torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=DEV))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def simulate_sweeps(pool, traj, n_sweeps: int, n_azimuth: int, rings=None):
    """``simulate_sweep`` of the sweeps starting at 0, 0.1, ... in the
    worker processes of ``pool``: the arrays a serial loop gives."""
    futs = [pool.submit(synthetic.simulate_sweep, traj, i * SCAN_DT, n_azimuth=n_azimuth,
                        **(rings or {})) for i in range(n_sweeps)]
    return [f.result() for f in futs]


def simulate_sequence(pool, traj, n_sweeps: int, rings=None):
    """(xyz, mask, dts, acc, gyr, acc0, gyr0, t_end) per sweep; the IMU
    interval is (t0, t0 + dt], the sweep's own span. ``rings``: the
    sensor's ring arguments (default: the 16-beam rig)."""
    seq = []
    for i, (xyz, mask) in enumerate(simulate_sweeps(pool, traj, n_sweeps, 900, rings)):
        t0 = i * SCAN_DT
        ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t0 + SCAN_DT, IMU_RATE)
        a0, w0 = traj.imu(t0)
        dts = np.diff(np.concatenate([[t0], ts]))
        seq.append((xyz, mask, dts, acc, gyr, a0, w0, t0 + SCAN_DT))
    return seq


def feed(pipe, item):
    xyz, mask, dts, acc, gyr, a0, w0, _ = item
    return pipe.process(xyz, mask, pipe.make_samples(dts, acc, gyr, a0, w0))


@contextlib.contextmanager
def library_eigh_calls(counts: dict):
    """Count ``torch.linalg.eigh`` calls on CUDA tensors inside the block
    (``counts["cuda"]``): the port's step makes none (its ``eigh`` is the
    port's kernel, ``csrc/eigh.cu``)."""
    orig = torch.linalg.eigh

    def counted(a, *args, **kwargs):
        if a.is_cuda:
            counts["cuda"] = counts.get("cuda", 0) + 1
        return orig(a, *args, **kwargs)

    torch.linalg.eigh = counted
    try:
        yield counts
    finally:
        torch.linalg.eigh = orig


def drive(pipe, seq, paths, plain=None, eigh_by_path=None, solve_by_path=None):
    """Feed ``seq`` to ``pipe`` sweep by sweep, each synchronised and timed,
    with the KNN kernel's launches counted by path (``paths``; the
    ``eigh`` kernel's and the LU kernel's too, into ``eigh_by_path`` and
    ``solve_by_path``), the plain version's searches by path (``plain``)
    and the kernel's searches by shape. Returns (per-sweep records, laser
    poses, launches by path, plain searches by path, searches by shape, run
    seconds)."""
    poses, recs = [], []
    by_path, plain_counts, shapes = {}, {}, {}
    # the eigh and solve launches add up by path only where the caller asks
    # for them (its paths then hold every caller of both kernels)
    held = eigh_by_path is not None
    eigh_by_path = {} if eigh_by_path is None else eigh_by_path
    solve_by_path = {} if solve_by_path is None else solve_by_path
    knn_kernel.reset_launches()
    EIGH.reset_launches()
    LU.reset_launches()
    # the bootstrap's init attempts (host float64 numpy, reads the window back)
    attempts = [0]
    try_init = pipe._try_initialize

    def counted_try():
        attempts[0] += 1
        return try_init()

    pipe._try_initialize = counted_try
    t_run = time.perf_counter()
    with launches_by_path(by_path, paths), plain_searches(plain_counts, plain or {}), \
            kernel_shapes(shapes), launches_by_path(eigh_by_path, paths, kind="eigh"), \
            launches_by_path(solve_by_path, paths, kind="solve"):
        for i, item in enumerate(seq):
            before = knn_kernel.launches()
            a0, c0 = attempts[0], captures(pipe)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = feed(pipe, item)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            poses.append(out["laser_pose"])
            recs.append({"i": i, "stage": out["stage"], "consumed": "body_pose" in out,
                         "predicted": bool(out.get("predicted", False)), "s": dt,
                         "attempt": attempts[0] > a0, "captured": captures(pipe) - c0,
                         "knn": knn_kernel.launches() - before,
                         "lm": int(out["solver_iterations"]) if "solver_iterations" in out
                         else None,
                         "gn": int(out["newest_rounds"]) if "newest_rounds" in out else None})
    run_s = time.perf_counter() - t_run
    del pipe._try_initialize
    if sum(by_path.values()) != knn_kernel.launches():
        raise AssertionError(f"launches by path {by_path} do not add up to {knn_kernel.launches()}")
    for kind, counted, total in (("eigh", eigh_by_path, EIGH.launches()),
                                 ("solve", solve_by_path, LU.launches())):
        if held and sum(counted.values()) != total:
            raise AssertionError(f"{kind} launches by path {counted} do not add up to {total}")
    return recs, poses, by_path, plain_counts, shapes, run_s


def summarize(recs, poses, seq, traj, by_path, run_s):
    """The run's end stage, INITED sweep, ATE/RPE against ground truth and
    its times per sweep kind (steady: past the first 3 consumed INITED
    sweeps)."""
    inited_at = next((r["i"] for r in recs if r["stage"] == "INITED"), None)
    est_q = np.stack([p.q.detach().cpu().double().numpy() for p in poses])
    est_t = np.stack([p.t.detach().cpu().double().numpy() for p in poses])
    gt = [synthetic.gt_sensor_pose(traj, item[-1]) for item in seq]
    m = evaluation.evaluate_trajectory(est_q, est_t, np.stack([g[0] for g in gt]),
                                       np.stack([g[1] for g in gt]))
    consumed = [r for r in recs if r["stage"] == "INITED" and r["consumed"]]
    knn_inited = sum(r["knn"] for r in consumed)
    steady = consumed[3:]  # past the first INITED steps
    steady_all = [r for r in recs if r["stage"] == "INITED" and r["i"] >= steady[0]["i"]] \
        if steady else []
    return {
        "stage": recs[-1]["stage"], "inited_at_sweep": inited_at, "ate_rmse_m": m.ate_rmse,
        "rpe_trans_rmse_m": m.rpe_trans_rmse, "n_poses": m.n_poses,
        "knn_launches": sum(by_path.values()), "knn_launches_by_path": by_path,
        "knn_launches_inited": knn_inited,
        "consumed_inited_sweeps": len(consumed),
        "knn_per_consumed_inited_sweep": knn_inited / max(len(consumed), 1),
        "steady_consumed_sweeps": len(steady),
        "steady_consumed_ms_mean": 1e3 * float(np.mean([r["s"] for r in steady])) if steady
        else None,
        "steady_consumed_sweeps_per_s": len(steady) / sum(r["s"] for r in steady_all)
        if steady else None,
        "steady_sweeps_per_s": len(steady_all) / sum(r["s"] for r in steady_all)
        if steady_all else None,
        "predicted_ms_mean": 1e3 * float(np.mean([r["s"] for r in steady_all
                                                  if r["predicted"]]))
        if any(r["predicted"] for r in steady_all) else None,
        "bootstrap_ms_mean": 1e3 * float(np.mean([r["s"] for r in recs
                                                  if r["stage"] == "NOT_INITED"])),
        **bootstrap_split(recs),
        "lm_iterations_mean": float(np.mean([r["lm"] for r in consumed])) if consumed else None,
        "gn_rounds_mean": float(np.mean([r["gn"] for r in consumed])) if consumed else None,
        "lm_iterations": [r["lm"] for r in consumed], "gn_rounds": [r["gn"] for r in consumed],
        "run_s": run_s,
    }


def bootstrap_split(recs) -> dict:
    """The bootstrap sweeps (up to the one that reaches INITED) apart: those
    that capture a graph, those that make an init attempt (host float64
    numpy, which reads the window back), and the ordinary rest."""
    boot = recs[:next((r["i"] + 1 for r in recs if r["stage"] == "INITED"), len(recs))]

    def ms(rows):
        return 1e3 * float(np.mean([r["s"] for r in rows])) if rows else None

    ordinary = [r for r in boot if not r["attempt"] and not r["captured"]]
    attempts = [r for r in boot if r["attempt"] and not r["captured"]]
    return {"bootstrap_sweeps": len(boot), "bootstrap_ordinary_ms_mean": ms(ordinary),
            "bootstrap_ordinary_sweeps": len(ordinary),
            "bootstrap_attempt_ms_mean": ms(attempts), "bootstrap_attempts": len(attempts),
            "bootstrap_capture_ms": [1e3 * r["s"] for r in boot if r["captured"]]}


def eager_stages(pipe, sweep):
    """``stage_breakdown`` of one sweep: on the eager step (a graphed
    pipeline runs that sweep with ``graphs=False``; its state goes back
    into the graphs' buffers at the next graphed sweep)."""
    graphs, pipe.graphs = pipe.graphs, False
    try:
        return stage_breakdown(sweep, DEV)
    finally:
        pipe.graphs = graphs


def captures(pipe) -> int:
    return pipe.graph_captures()


def extra_counts(pipe, seq, stages: bool = True):
    """Launches (and device busy time), host syncs and (``stages``) stage
    times of the sweeps after the measured run: two sweeps each;
    ``captured``: CUDA graphs captured during the sweep."""
    counts = []
    for j, item in enumerate(seq[N_SWEEPS:N_SWEEPS + (N_EXTRA if stages else 4)]):
        sweep = lambda: feed(pipe, item)  # noqa: E731
        c0 = captures(pipe)
        if j < 2:
            out, c = count_launches(sweep, DEV, match=LINALG_KERNELS)
        elif j < 4:
            out, n_sync = count_syncs(sweep, DEV)
            c = {"host_syncs": n_sync}
        else:
            out, c = eager_stages(pipe, sweep)
        c["consumed"] = "body_pose" in out
        c["captured"] = captures(pipe) - c0
        if "solver_iterations" in out:
            c["lm"] = int(out["solver_iterations"])
            c["gn"] = int(out["newest_rounds"])
        counts.append(c)
    return counts


def timed_extras(pipe, seq):
    """Wall ms of each sweep after the measured run (synchronised, no
    profiler yet in this process), with its kind and captures."""
    rows = []
    for item in seq[N_SWEEPS:N_SWEEPS + N_EXTRA]:
        c0 = captures(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = feed(pipe, item)
        torch.cuda.synchronize()
        rows.append({"ms": 1e3 * (time.perf_counter() - t0), "consumed": "body_pose" in out,
                     "captured": captures(pipe) - c0})
    return rows


def main_path(seq, traj, eigh_by_path, solve_by_path):
    """Phase 4 on the default (graphed) pipeline; returns (summary, launches
    by path, the pipeline, its poses). Also fails if ``torch.linalg.eigh``
    ran on the card, if a host decision was read or if the eigh kernel
    did not run in the estimator's steps."""
    pipe = LioPipeline(LioConfig.indoor(), device=DEV, dtype=torch.float32)
    if not pipe.graphs:
        raise AssertionError("the pipeline on the card does not default to CUDA graphs")
    paths = {"lio_estimator": (EST, "step_program"), "lio_odometry": (ODO, "odometry_program")}
    with library_eigh_calls({}) as lib_eigh:
        recs, poses, by_path, _, _, run_s = drive(pipe, seq[:N_SWEEPS], paths,
                                                  eigh_by_path=eigh_by_path,
                                                  solve_by_path=solve_by_path)
    summary = summarize(recs, poses, seq[:N_SWEEPS], traj, by_path, run_s)
    summary["state_sha256"] = cli._state_digest(pipe)
    summary["graphs"] = {**pipe._step_graphs.stats, **pipe._step_graphs.memory_bytes()}
    summary["eigh_launches_by_path"] = dict(eigh_by_path)
    summary["solve_launches_by_path"] = dict(solve_by_path)
    summary["torch_linalg_eigh_cuda_calls"] = lib_eigh.get("cuda", 0)
    log("main_path " + json.dumps(summary))
    if summary["torch_linalg_eigh_cuda_calls"]:
        raise AssertionError("torch.linalg.eigh ran on the card in the main path")
    if summary["graphs"]["decisions"]:
        raise AssertionError("the graphed step read a decision on the host")
    if eigh_by_path.get("lio_estimator", 0) < 3 * summary["consumed_inited_sweeps"]:
        raise AssertionError(f"the eigh kernel did not run 3 times a consumed sweep: "
                             f"{eigh_by_path}")
    if solve_by_path.get("lio_estimator", 0) < 2 * summary["consumed_inited_sweeps"]:
        raise AssertionError(f"the LU kernel did not run in every consumed sweep: "
                             f"{solve_by_path}")
    if summary["stage"] != "INITED":
        raise AssertionError(f"the pipeline ended {summary['stage']}, not INITED")
    if not summary["ate_rmse_m"] <= ATE_LIMIT:
        raise AssertionError(f"ATE RMSE {summary['ate_rmse_m']:.4f} m > {ATE_LIMIT} m")
    if summary["knn_launches_inited"] <= 0:
        raise AssertionError("the CUDA KNN kernel was not launched on the INITED sweeps")
    if summary["graphs"]["replays"] <= 0:
        raise AssertionError("the INITED sweeps replayed no CUDA graph")
    return summary, by_path, pipe, poses


def _same_poses(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(p.q, r.q) and torch.equal(p.t, r.t)
                                    for p, r in zip(a, b))


def eager_replay(seq, traj, workdir, graphed, g_summary, g_poses):
    """Phase 17: phase 4's sequence on a ``graphs=False`` pipeline. Fails
    unless its poses, INITED sweep, ATE and final state (sha256) equal
    phase 4's graphed run. Then both pipelines take the extra sweeps from
    their states after the 90 (a checkpoint each): the graphed one once to
    capture what they need, then each timed with no profiler yet in this
    process, then counted (launches, syncs, stage times); printed per
    consumed sweep beside the graphs' memory."""
    pipe = LioPipeline(LioConfig.indoor(), device=DEV, dtype=torch.float32, graphs=False)
    eigh_by_path, solve_by_path = {}, {}
    matrices = {"eigh": {}, "solve": {}, "prior": {}}
    with last_inputs(EIGH, "eigh", matrices["eigh"]), last_inputs(LU, "solve", matrices["solve"]), \
            last_inputs(MG, "factorize_prior", matrices["prior"]):
        recs, poses, by_path, _, _, run_s = drive(
            pipe, seq[:N_SWEEPS], {"lio_estimator_eager": (EST, "step_program"),
                                   "lio_odometry_eager": (ODO, "odometry_program")},
            eigh_by_path=eigh_by_path, solve_by_path=solve_by_path)
    summary = summarize(recs, poses, seq[:N_SWEEPS], traj, by_path, run_s)
    summary["state_sha256"] = cli._state_digest(pipe)
    same = {"poses": _same_poses(poses, g_poses),
            "inited_at_sweep": summary["inited_at_sweep"] == g_summary["inited_at_sweep"],
            "ate_rmse_m": summary["ate_rmse_m"] == g_summary["ate_rmse_m"],
            "state_sha256": summary["state_sha256"] == g_summary["state_sha256"]}
    log("eager_replay " + json.dumps({**summary, "equal_to_graphed": same}))
    if not all(same.values()):
        raise AssertionError(f"the eager step differs from the graphed one: {same}")

    paths = {"graphed": graphed, "eager": pipe}
    ckpt = {name: os.path.join(workdir, f"phase17_{name}.npz") for name in paths}
    for name, p in paths.items():
        p.save(ckpt[name])
    warm = timed_extras(graphed, seq)  # captures what the extra sweeps need
    log("phase17_warm_graphed " + json.dumps(warm))
    timed, counts = {}, {}
    for name, p in paths.items():
        p.load(ckpt[name])
        timed[name] = timed_extras(p, seq)
    for name, p in paths.items():
        p.load(ckpt[name])
        # stage times exist for the eager step only
        counts[name] = extra_counts(p, seq, stages=name == "eager")
        log(f"per_sweep_counts_{name} " + json.dumps(counts[name]))

    def per_consumed(name):
        cs = counts[name]
        launch = next(c for c in cs if "runtime_launches" in c and c["consumed"])
        sync = next(c for c in cs if "host_syncs" in c and c["consumed"])
        walls = [r["ms"] for r in timed[name] if r["consumed"]]
        return {"launch_calls": launch["runtime_launches"],
                "graph_launches": launch["graph_launches"],
                "device_kernels": launch["device_kernels"],
                "device_busy_ms": launch["device_busy_ms"],
                "linalg_device_ms": {k: ms for k, (_, ms)
                                     in launch["matched_device_kernels"].items()},
                "host_syncs": sync["host_syncs"],
                "wall_ms": walls, "wall_ms_mean": float(np.mean(walls)),
                "skipped_wall_ms": [r["ms"] for r in timed[name] if not r["consumed"]],
                "captured": sum(r["captured"] for r in timed[name])
                + launch["captured"] + sync["captured"],
                "lm": launch.get("lm"), "gn": launch.get("gn"),
                "steady_run_ms_mean": (g_summary if name == "graphed" else summary)[
                    "steady_consumed_ms_mean"]}

    row = {"graphed": {**per_consumed("graphed"),
                       "graphs_memory_bytes": graphed._step_graphs.memory_bytes(),
                       "phase4_captures": g_summary["graphs"]["captures"],
                       "phase4_steady_consumed_ms_mean": g_summary["steady_consumed_ms_mean"]},
           "eager": per_consumed("eager")}
    log("per_consumed_sweep_paths " + json.dumps(row))
    g_row = row["graphed"]
    if g_row["host_syncs"] != 0 or g_row["graph_launches"] != 1:
        raise AssertionError(f"a steady graphed consumed sweep made {g_row['host_syncs']} host "
                             f"syncs and {g_row['graph_launches']} graph launches (0 and 1 "
                             "expected)")
    row["bootstrap"] = bootstrap_counts(seq, {"graphed": g_summary, "eager": summary})
    return row, by_path, {"eigh": eigh_by_path, "solve": solve_by_path}, matrices


def bootstrap_counts(seq, summaries):
    """Launch calls, graph launches, host syncs and device busy ms of
    bootstrap sweeps (none makes an init attempt) on a fresh graphed
    pipeline and a ``graphs=False`` one: the first N_BOOT_WARM sweeps
    capture what the rest need, then N_BOOT_COUNTED sweeps are counted
    (profiler and sync-debug mode on the same call). Printed beside each
    path's bootstrap times from phases 4 and 17; fails unless every counted
    graphed sweep made 1 graph launch and 0 host syncs."""
    rows = {}
    for name, graphs in (("graphed", True), ("eager", False)):
        pipe = LioPipeline(LioConfig.indoor(), device=DEV, dtype=torch.float32, graphs=graphs)
        for item in seq[:N_BOOT_WARM]:
            feed(pipe, item)
        counted = []
        for item in seq[N_BOOT_WARM:N_BOOT_WARM + N_BOOT_COUNTED]:
            n0, c0 = len(pipe._init_odom_poses), captures(pipe)
            (out, n_sync), c = count_launches(lambda: count_syncs(lambda: feed(pipe, item), DEV),
                                              DEV)
            counted.append({"pushed": len(pipe._init_odom_poses) != n0,
                            "captured": captures(pipe) - c0, "stage": out["stage"],
                            "host_syncs": n_sync,
                            **{k: c[k] for k in ("runtime_launches", "graph_launches",
                                                 "kernel_launch_calls", "device_kernels",
                                                 "device_busy_ms")}})
        s = summaries[name]
        rows[name] = {"counted": counted,
                      **{k: s[k] for k in s if k.startswith("bootstrap")},
                      "graphs": pipe._step_graphs.memory_bytes() if graphs else None}
    log("bootstrap_counts " + json.dumps(rows))
    bad = [c for c in rows["graphed"]["counted"]
           if c["stage"] != "NOT_INITED" or c["captured"] or c["host_syncs"] != 0
           or c["graph_launches"] != 1]
    if bad or not any(c["pushed"] for c in rows["graphed"]["counted"]):
        raise AssertionError(f"graphed bootstrap sweeps must make 1 graph launch and 0 host "
                             f"syncs (a push among them): {rows['graphed']['counted']}")
    return rows


def plain_closed_loop(seq, traj, kernel_summary, part: str):
    """Phase 4's sequence once more with one kernel's calls on its plain
    version: ``knn``, every estimator search (``make_knn5`` patched to
    ``force_tiled``), or ``eigh``, the step's three decompositions
    (``ops/eigh.eigh`` patched to ``eigh_plain``: float64 cuSOLVER, whose
    status check reads back, so that pipeline runs eagerly). The closed
    loop without the kernel, printed beside the kernel's, not held."""
    if part == "knn":
        module, attr = EST, "make_knn5"
        orig = EST.make_knn5

        def plain_fn(map_xyz, map_mask, cfg, axis=None, force_tiled=False):
            return orig(map_xyz, map_mask, cfg, axis=axis, force_tiled=True)
    else:
        module, attr, plain_fn = EIGH, "eigh", EIGH.eigh_plain
    orig_attr = getattr(module, attr)
    est_path = f"lio_estimator_plain_{part}"
    setattr(module, attr, plain_fn)
    try:
        pipe = LioPipeline(LioConfig.indoor(), device=DEV, dtype=torch.float32,
                           graphs=part == "knn")
        recs, poses, by_path, plain, _, run_s = drive(
            pipe, seq[:N_SWEEPS], {est_path: (EST, "step_program"),
                                   f"lio_odometry_plain_{part}": (ODO, "odometry_program")},
            plain={est_path: (EST, "step_program")} if part == "knn" else None)
    finally:
        setattr(module, attr, orig_attr)
    summary = summarize(recs, poses, seq[:N_SWEEPS], traj, by_path, run_s)
    row = {"stage": summary["stage"], "inited_at_sweep": summary["inited_at_sweep"],
           "ate_rmse_m": summary["ate_rmse_m"],
           "kernel_inited_at_sweep": kernel_summary["inited_at_sweep"],
           "kernel_ate_rmse_m": kernel_summary["ate_rmse_m"],
           "lm_iterations": summary["lm_iterations"], "gn_rounds": summary["gn_rounds"],
           "kernel_lm_iterations": kernel_summary["lm_iterations"],
           "kernel_gn_rounds": kernel_summary["gn_rounds"],
           "steady_consumed_ms_mean": summary["steady_consumed_ms_mean"], "run_s": run_s}
    if part == "knn":
        row.update(estimator_kernel_launches=by_path.get(est_path, 0),
                   estimator_plain_searches=plain.get(est_path, 0))
    log(f"plain_{part}_closed_loop " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phases 8-9: the outdoor_64 profile and the estimator variants
# ---------------------------------------------------------------------------


def outdoor64_path(pool):
    """Phase 8: ``LioPipeline(outdoor_64)`` in-process over 60 HDL-64
    sweeps, then a consumed sweep's launches, host syncs and stage times (and
    a skipped sweep's launches) on the sweeps after it."""
    cfg = outdoor64_cfg()
    traj = synthetic.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    t0 = time.perf_counter()
    seq = simulate_sequence(pool, traj, N_O64 + N_O64_EXTRA, rings_of(cfg))
    log(f"simulated {len(seq)} HDL-64 sweeps in {time.perf_counter() - t0:.1f} s")
    pipe = LioPipeline(cfg, device=DEV, dtype=torch.float32)
    recs, poses, by_path, _, shapes, run_s = drive(
        pipe, seq[:N_O64], {"lio_estimator_outdoor64": (EST, "step_program"),
                            "lio_odometry_outdoor64": (ODO, "odometry_program")})
    summary = summarize(recs, poses, seq[:N_O64], traj, by_path, run_s)
    e = cfg.estimator
    shape = f"{e.surf_stack_cap}x{e.local_map_filtered_cap}x5"
    summary.update(kernel_searches_by_shape=shapes, inited_at_limit=O64_REF_INITED_AT + e.odom_io,
                   ate_limit_m=2 * O64_REF_ATE)
    log("outdoor64_path " + json.dumps(summary))
    if summary["stage"] != "INITED":
        raise AssertionError(f"outdoor_64 ended {summary['stage']}, not INITED")
    if summary["inited_at_sweep"] > summary["inited_at_limit"]:
        raise AssertionError(f"outdoor_64 went INITED at sweep {summary['inited_at_sweep']}, "
                             f"later than {summary['inited_at_limit']}")
    if not summary["ate_rmse_m"] <= summary["ate_limit_m"]:
        raise AssertionError(f"outdoor_64 ATE RMSE {summary['ate_rmse_m']:.4f} m > "
                             f"{summary['ate_limit_m']:.4f} m")
    if shapes.get(shape, 0) <= 0 or summary["knn_launches_inited"] <= 0:
        raise AssertionError(f"the kernel did not run at {shape} on the INITED sweeps: {shapes}")

    counts, todo = [], ["launches", "syncs", "stages"]
    skipped_done = False
    for item in seq[N_O64:]:
        consumed = pipe.will_consume()
        if consumed and todo:
            kind = todo.pop(0)
        elif not consumed and not skipped_done:
            kind, skipped_done = "launches", True
        else:
            feed(pipe, item)
            continue
        sweep = lambda: feed(pipe, item)  # noqa: E731
        if kind == "launches":
            out, c = count_launches(sweep, DEV)
        elif kind == "syncs":
            out, n_sync = count_syncs(sweep, DEV)
            c = {"host_syncs": n_sync}
        else:
            out, c = eager_stages(pipe, sweep)
        c["consumed"] = "body_pose" in out
        counts.append(c)
    log("outdoor64_per_sweep_counts " + json.dumps(counts))
    return summary, by_path


def corner_paths(seq, traj):
    """Phase 9: ``use_corner`` and ``use_corner`` + ``fix_map`` on the
    indoor profile over phase 4's sequence, the corner searches' kernel
    launches and plain searches counted by path."""
    all_paths = {}
    for tag, flags in (("corner", dict(use_corner=True)),
                       ("corner_fixmap", dict(use_corner=True, fix_map=True))):
        base = LioConfig.indoor()
        cfg = dataclasses.replace(base, estimator=dataclasses.replace(base.estimator, **flags))
        pipe = LioPipeline(cfg, device=DEV, dtype=torch.float32)
        corner = f"lio_estimator_{tag}"
        recs, poses, by_path, plain, _, run_s = drive(
            pipe, seq[:N_SWEEPS],
            {corner: (EST, "_calculate_corner_features"),
             f"{corner}_surf": (EST, "_calculate_features"),
             f"lio_odometry_{tag}": (ODO, "odometry_program")},
            plain={corner: (EST, "_calculate_corner_features")})
        summary = summarize(recs, poses, seq[:N_SWEEPS], traj, by_path, run_s)
        summary.update(variant=tag, plain_searches_by_path=plain,
                       ate_limit_m=2 * CORNER_REF_ATE[tag])
        log("corner_path " + json.dumps(summary))
        if summary["stage"] != "INITED":
            raise AssertionError(f"{tag} ended {summary['stage']}, not INITED")
        if not summary["ate_rmse_m"] <= summary["ate_limit_m"]:
            raise AssertionError(f"{tag} ATE RMSE {summary['ate_rmse_m']:.4f} m > "
                                 f"{summary['ate_limit_m']:.4f} m")
        if by_path.get(f"{corner}_surf", 0) <= 0:
            raise AssertionError(f"{tag}: the surf searches did not launch the kernel")
        if by_path.get(corner, 0) != 0 or plain.get(corner, 0) <= 0:
            raise AssertionError(f"{tag}: the corner searches must run the plain version only "
                                 f"(kernel {by_path.get(corner, 0)}, plain "
                                 f"{plain.get(corner, 0)})")
        all_paths.update(by_path)
    return all_paths


# ---------------------------------------------------------------------------
# phases 5-7: the CLI
# ---------------------------------------------------------------------------


def cli_start(workdir, *args):
    """Start ``python -m lio_mapping_tpu_torch.cli <args>`` as a subprocess
    in ``workdir``, this checkout on its path; ``cli_finish`` waits for it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(x for x in (ROOT, env.get("PYTHONPATH")) if x)
    proc = subprocess.Popen([sys.executable, "-m", "lio_mapping_tpu_torch.cli", *args],
                            cwd=workdir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, args, time.perf_counter()


def cli_finish(started, timeout=900):
    """Wait for a ``cli_start`` subprocess; returns its stdout, raises on a
    non-zero exit (and kills it past ``timeout`` s)."""
    proc, args, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for line in out.splitlines():
        log(f"  cli {args[0]}: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} exited {proc.returncode}:\n{err[-4000:]}")
    log(f"  cli {args[0]} took {time.perf_counter() - t0:.1f} s")
    return out


def cli_call(workdir, *args, timeout=900):
    """``cli_start`` and ``cli_finish``: one CLI subprocess, waited for."""
    return cli_finish(cli_start(workdir, *args), timeout)


def _grab(pattern, text, what):
    m = re.search(pattern, text)
    if not m:
        raise AssertionError(f"no {what} in the output:\n{text}")
    return m.group(1)


def cli_lio(workdir, simulating):
    """Phase 5: simulate (started by the caller), run (lio), evaluate, each
    a subprocess."""
    cli_finish(simulating)
    out = cli_call(workdir, "run", "--log", "seq.liol", "--profile", "indoor",
                   "--out", "traj.tum", "--map-out", "map.pcd", "--stats-json", "stats.json")
    ev = cli_call(workdir, "evaluate", "--est", "traj.tum", "--gt", "gt.tum")
    with open(os.path.join(workdir, "stats.json")) as f:
        stats = json.load(f)
    row = {"stage": _grab(r"\(stage: (\w+)\)", out, "stage"),
           "ate_rmse_m": float(_grab(r"ATE RMSE: ([0-9.]+) m", ev, "ATE")),
           "map_voxels": int(_grab(r"wrote (\d+) map voxels", out, "map size")),
           "stats": stats}
    log("cli_lio " + json.dumps(row))
    if row["stage"] != "INITED":
        raise AssertionError(f"cli run ended {row['stage']}, not INITED")
    if not row["ate_rmse_m"] <= ATE_LIMIT:
        raise AssertionError(f"cli run ATE RMSE {row['ate_rmse_m']} m > {ATE_LIMIT} m")
    if row["map_voxels"] <= 0:
        raise AssertionError("cli run wrote an empty map")
    if stats["n_pairs"] != N_SWEEPS - 1:
        raise AssertionError(f"cli run paired {stats['n_pairs']} sweeps, not {N_SWEEPS - 1}")
    return row


def cli_two_phase(workdir, single):
    """Phase 6: ``run --two-phase`` equals phase 5's single-process run.
    ``--timing`` makes phase B print its KNN kernel launches and the
    tracer's report (host spans, device stamps, captures and replays per
    graph key)."""
    out = cli_call(workdir, "run", "--log", "seq.liol", "--profile", "indoor",
                   "--out", "traj_tp.tum", "--map-out", "map_tp.pcd", "--two-phase", "--timing")
    t_sp, q_sp, p_sp = evaluation.load_tum(os.path.join(workdir, "traj.tum"))
    t_tp, q_tp, p_tp = evaluation.load_tum(os.path.join(workdir, "traj_tp.tum"))
    if len(t_tp) != len(t_sp):
        raise AssertionError(f"two-phase wrote {len(t_tp)} poses, single {len(t_sp)}")
    row = {"poses": len(t_tp), "max_dt_s": float(np.max(np.abs(t_tp - t_sp))),
           "max_dp_m": float(np.max(np.abs(p_tp - p_sp))),
           "min_abs_qdot": float(np.min(np.abs(np.sum(q_tp * q_sp, axis=-1)))),
           "map_voxels": int(_grab(r"wrote (\d+) map voxels", out, "map size")),
           "map_voxels_single": single["map_voxels"],
           "phase_b_knn_launches": int(_grab(r"knn kernel launches: (\d+)", out, "launches"))}
    log("cli_two_phase " + json.dumps(row))
    if row["phase_b_knn_launches"] <= 0:
        raise AssertionError("the CUDA KNN kernel was not launched in the CLI's phase B")
    if row["max_dt_s"] > 1e-6 or row["max_dp_m"] > 1e-4 or row["min_abs_qdot"] <= 1 - 1e-6:
        raise AssertionError(f"two-phase trajectory differs from the single run: {row}")
    if row["map_voxels"] != single["map_voxels"]:
        raise AssertionError(f"two-phase map has {row['map_voxels']} voxels, single "
                             f"{single['map_voxels']}")
    return row


def cli_inprocess(*args):
    """``cli.main(args)`` in this process; returns its stdout, raises on a
    non-zero return."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    for line in buf.getvalue().splitlines():
        log(f"  cli {args[0]}: {line}")
    if rc != 0:
        raise AssertionError(f"cli {' '.join(args)} returned {rc}")
    return buf.getvalue()


def tree_digest(tree) -> str:
    """sha256 of every tensor of ``tree`` (its bytes on the host)."""
    import hashlib

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def recording_loam(graphs: bool, made: list):
    """A ``LoamPipeline`` class for ``cli run --mode loam`` in this process:
    ``graphs`` as given, each sweep synchronised and timed with its pose
    kept, and the host syncs of sweeps LOAM_SYNC_SWEEPS counted (those are
    left out of the times); each pipeline made is appended to ``made``."""
    class Recording(PL.LoamPipeline):
        def __init__(self, cfg, device=None, dtype=torch.float32):
            super().__init__(cfg, device=device, dtype=dtype, graphs=graphs)
            self.recs, self.poses = [], []
            made.append(self)

        def process(self, xyz, mask, ring_ids=None):
            mapped = (self.frame_count + 1) % self.cfg.odometry.io_ratio == 0
            sweep = functools.partial(super().process, xyz, mask, ring_ids)
            c0 = self.graph_captures()
            counted = len(self.recs) in LOAM_SYNC_SWEEPS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, n_sync = count_syncs(sweep, DEV, synchronize=False) if counted else (sweep(), None)
            torch.cuda.synchronize()
            self.recs.append({"mapped": mapped, "ms": 1e3 * (time.perf_counter() - t0),
                              "host_syncs": n_sync, "captured": self.graph_captures() - c0})
            self.poses.append(out["laser_pose"])
            return out

    return Recording


def loam_times(recs) -> dict:
    def ms(mapped):
        rows = [r["ms"] for r in recs if r["mapped"] == mapped and not r["captured"]
                and r["host_syncs"] is None]
        return float(np.mean(rows)) if rows else None

    counted = [r for r in recs if r["host_syncs"] is not None]
    return {"mapped_ms_mean": ms(True), "associated_ms_mean": ms(False),
            "captured_ms": [r["ms"] for r in recs if r["captured"]],
            "counted_sweeps": [[r["mapped"], r["host_syncs"], r["captured"]] for r in counted],
            "host_syncs_steady": sum(r["host_syncs"] for r in counted if not r["captured"])}


def cli_loam(workdir):
    """Phase 7: ``run --mode loam`` in this process (the kernel's launches
    counted by path; graphed, the default on the card), ``evaluate``; then
    the same run with ``graphs=False``: poses and final states bit for bit
    the graphed run's, and a steady graphed sweep makes no host sync."""
    p = lambda name: os.path.join(workdir, name)  # noqa: E731
    runs = {}
    for name, graphs in (("graphed", True), ("eager", False)):
        by_path, made = {}, []
        suffix = "" if graphs else "_eager"
        knn_kernel.reset_launches()
        t0 = time.perf_counter()
        orig = PL.LoamPipeline
        PL.LoamPipeline = recording_loam(graphs, made)
        try:
            with launches_by_path(by_path, {f"loam_odometry{suffix}": (ODO, "odometry_program"),
                                            f"loam_scan_to_map{suffix}": (MAP, "mapping_program")}):
                out = cli_inprocess("run", "--log", p("seq.liol"), "--profile", "indoor",
                                    "--mode", "loam", "--out", p(f"traj_loam{suffix}.tum"),
                                    "--map-out", p(f"map_loam{suffix}.pcd"), "--stats-json",
                                    p(f"stats_loam{suffix}.json"))
        finally:
            PL.LoamPipeline = orig
        run_s = time.perf_counter() - t0
        launches = knn_kernel.launches()
        ev = cli_inprocess("evaluate", "--est", p(f"traj_loam{suffix}.tum"), "--gt", p("gt.tum"))
        with open(p(f"stats_loam{suffix}.json")) as f:
            stats = json.load(f)
        pipe = made[-1]
        runs[name] = (pipe, {
            "ate_rmse_m": float(_grab(r"ATE RMSE: ([0-9.]+) m", ev, "ATE")),
            "map_voxels": int(_grab(r"wrote (\d+) map voxels", out, "map size")),
            "knn_launches": launches, "knn_launches_by_path": by_path, "run_s": run_s,
            "state_sha256": tree_digest((pipe.map_state, pipe.odom_state)),
            "captures": pipe.graph_captures(),
            "graphs": pipe._step_graphs.memory_bytes() if graphs else None,
            **loam_times(pipe.recs), "stats": stats})
        if sum(by_path.values()) != launches:
            raise AssertionError(f"launches by path {by_path} do not add up to {launches}")
    (pg, row), (pe, eager) = runs["graphed"], runs["eager"]
    row["eager"] = {k: v for k, v in eager.items() if k != "stats"}
    row["equal_to_eager"] = same = {
        "poses": _same_poses(pg.poses, pe.poses),
        "state_sha256": row["state_sha256"] == eager["state_sha256"],
        "ate_rmse_m": row["ate_rmse_m"] == eager["ate_rmse_m"]}
    log("cli_loam " + json.dumps(row))
    if not all(same.values()):
        raise AssertionError(f"the graphed LOAM run differs from the eager one: {same}")
    if not row["ate_rmse_m"] <= LOAM_ATE_LIMIT:
        raise AssertionError(f"LOAM ATE RMSE {row['ate_rmse_m']} m > {LOAM_ATE_LIMIT} m")
    if row["knn_launches_by_path"].get("loam_scan_to_map", 0) <= 0:
        raise AssertionError("the CUDA KNN kernel was not launched in the scan-to-map search")
    if row["host_syncs_steady"] != 0 or not any(not c for _, _, c in row["counted_sweeps"]):
        raise AssertionError(f"steady graphed LOAM sweeps made host syncs: "
                             f"{row['counted_sweeps']}")
    return row, {**row["knn_launches_by_path"], **eager["knn_launches_by_path"]}


@contextlib.contextmanager
def counted_calls(calls: dict, targets: dict):
    """Inside the block each call of a (module or class, function) of
    ``targets[name]`` adds one to ``calls[name]``."""
    originals = [(owner, attr, getattr(owner, attr)) for pairs in targets.values()
                 for owner, attr in pairs]

    def wrap(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    for name, pairs in targets.items():
        for owner, attr in pairs:
            setattr(owner, attr, wrap(name, getattr(owner, attr)))
    try:
        yield calls
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)


def cli_4d(workdir):
    """Phase 10: ``run --enable-4d --out-4d --timing`` on phase 5's log in
    this process (launches and calls counted by path), ``evaluate`` of the
    LIO and the 4D trajectory."""
    p = lambda name: os.path.join(workdir, name)  # noqa: E731
    by_path, calls, steps, made, shapes, plain = {}, {}, [], [], {}, {}
    knn_kernel.reset_launches()
    t0 = time.perf_counter()
    orig = MB.MapBuilder
    MB.MapBuilder = recording_builder(steps, made)
    # an estimator step is a call of the graphed step (one graph replay) or
    # of the eager one
    try:
        with launches_by_path(by_path, {"map_builder": (MB, "map_builder_program"),
                                        "lio_estimator_4d": (EST, "step_program"),
                                        "lio_odometry_4d": (ODO, "odometry_program")}), \
                kernel_shapes(shapes), \
                plain_searches(plain, {"map_builder": (MB, "map_builder_program")}), \
                counted_calls(calls, {"estimator_steps": [(PL.LioPipeline, "_graphed_step"),
                                                          (EST, "lio_step_impl")]}):
            out = cli_inprocess("run", "--log", p("seq.liol"), "--profile", "indoor",
                                "--out", p("traj_4d_lio.tum"), "--enable-4d", "--out-4d",
                                p("traj_4d.tum"), "--timing")
    finally:
        MB.MapBuilder = orig
    run_s = time.perf_counter() - t0
    calls["map_builder"] = len(steps)
    if sum(by_path.values()) != knn_kernel.launches():
        raise AssertionError(f"launches by path {by_path} do not add up to {knn_kernel.launches()}")
    builder_pair = builder_against_eager(made[-1], steps)
    ate = float(_grab(r"ATE RMSE: ([0-9.]+) m", cli_inprocess(
        "evaluate", "--est", p("traj_4d_lio.tum"), "--gt", p("gt.tum")), "ATE"))
    ate_4d = float(_grab(r"ATE RMSE: ([0-9.]+) m", cli_inprocess(
        "evaluate", "--est", p("traj_4d.tum"), "--gt", p("gt.tum")), "ATE"))
    t_sp, q_sp, p_sp = evaluation.load_tum(p("traj.tum"))
    t_lio, q_lio, p_lio = evaluation.load_tum(p("traj_4d_lio.tum"))
    t_4d, _, _ = evaluation.load_tum(p("traj_4d.tum"))
    stage = re.search(r"\n(map_builder\s.*)", out)
    row = {"ate_rmse_m": ate, "ate_4d_rmse_m": ate_4d,
           "ate_4d_limit_m": max(2 * ate, FOUR_D_FLOOR), "poses_4d": len(t_4d),
           "builder_calls": calls.get("map_builder", 0),
           "estimator_steps": calls.get("estimator_steps", 0),
           "max_dp_vs_phase5_m": float(np.max(np.abs(p_lio - p_sp))) if len(t_lio) == len(t_sp)
           else None,
           "min_abs_qdot_vs_phase5": float(np.min(np.abs(np.sum(q_lio * q_sp, axis=-1))))
           if len(t_lio) == len(t_sp) else None,
           "map_builder_stage": stage.group(1).split() if stage else None,
           "builder": builder_pair, "knn_launches_by_path": by_path,
           "knn_launches_by_shape": shapes, "builder_plain_searches": plain, "run_s": run_s}
    log("cli_4d " + json.dumps(row))
    if not all(builder_pair["equal_to_eager"].values()) or builder_pair["host_syncs_steady"]:
        raise AssertionError(f"the graphed 4D builder differs from the eager one, or made host "
                             f"syncs: {builder_pair}")
    if len(t_lio) != len(t_sp) or np.max(np.abs(t_lio - t_sp)) > 1e-6 \
            or row["max_dp_vs_phase5_m"] > 1e-4 or row["min_abs_qdot_vs_phase5"] <= 1 - 1e-6:
        raise AssertionError(f"the LIO poses with --enable-4d differ from phase 5's: {row}")
    # the builder runs on every consumed INITED sweep: the init sweep and
    # each estimator step after it
    if not len(t_4d) == row["builder_calls"] == row["estimator_steps"] + 1:
        raise AssertionError(f"{len(t_4d)} 4D poses for {row['builder_calls']} builder calls "
                             f"and {row['estimator_steps']} estimator steps")
    if not ate_4d < row["ate_4d_limit_m"]:
        raise AssertionError(f"4D ATE RMSE {ate_4d} m >= {row['ate_4d_limit_m']} m")
    indoor = LioConfig.indoor()
    builder_shapes = [f"{n}x{indoor.mapping.map_cloud_cap}x5"
                      for n in (indoor.estimator.corner_stack_cap, indoor.estimator.surf_stack_cap)]
    if by_path.get("map_builder", 0) <= 0 or min(shapes.get(s, 0) for s in builder_shapes) <= 0:
        raise AssertionError(f"the 4D builder's searches did not launch the kernel at "
                             f"{builder_shapes}: {shapes}")
    if plain.get("map_builder", 0):
        raise AssertionError(f"the 4D builder made {plain['map_builder']} plain searches")
    return row, by_path


def recording_builder(steps: list, made: list):
    """A ``MapBuilder`` class for the CLI in this process: each step
    synchronised and timed, its inputs and pose kept, and its host syncs
    counted on steps BUILDER_SYNC_STEPS (the first captures the graph; those
    are left out of the times); each builder made is appended to ``made``."""
    class Recording(MB.MapBuilder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def step(self, corner_cloud, surf_cloud, odom_pose):
            step = functools.partial(super().step, corner_cloud, surf_cloud, odom_pose)
            c0 = self.graph_captures()
            counted = len(steps) in BUILDER_SYNC_STEPS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, n_sync = count_syncs(step, DEV, synchronize=False) if counted else (step(), None)
            torch.cuda.synchronize()
            steps.append({"inputs": (corner_cloud, surf_cloud, odom_pose), "pose": out["pose"],
                          "ms": 1e3 * (time.perf_counter() - t0), "host_syncs": n_sync,
                          "captured": self.graph_captures() - c0})
            return out

    return Recording


def builder_against_eager(graphed, steps) -> dict:
    """The graphed builder's steps (phase 10) once more on a ``graphs=False``
    builder, on the same inputs: poses and final state bit for bit, and
    both paths' ms per step (synchronised)."""
    eager = MB.MapBuilder(graphed.cfg, DEV, torch.float32, graphs=False)
    poses, ms = [], []
    for rec in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses.append(eager.step(*rec["inputs"])["pose"])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    counted = [r for r in steps if r["host_syncs"] is not None]
    timed = [r["ms"] for r in steps if r["host_syncs"] is None and not r["captured"]]
    return {"steps": len(steps), "graphed": graphed.graphs, "captures": graphed.graph_captures(),
            "graphs": graphed._step_graphs.memory_bytes() if graphed.graphs else None,
            "graphed_ms_mean": float(np.mean(timed)) if timed else None,
            "graphed_ms": [r["ms"] for r in steps],
            "eager_ms_mean": float(np.mean(ms[1:])) if len(ms) > 1 else None, "eager_ms": ms,
            "host_syncs_steady": sum(r["host_syncs"] for r in counted if not r["captured"]),
            "counted_steps": len(counted),
            "equal_to_eager": {"poses": _same_poses([r["pose"] for r in steps], poses),
                               "state_sha256": tree_digest(graphed.state) == tree_digest(
                                   eager.state)}}


def cli_outdoor(workdir, simulating):
    """Phase 11: the outdoor (KAIST rig) profile through the CLI as
    subprocesses: simulate with the rig's laser offset (started by the
    caller), run, evaluate."""
    cli_finish(simulating)
    out = cli_call(workdir, "run", "--log", "seq_o.liol", "--profile", "outdoor",
                   "--out", "traj_o.tum", "--map-out", "map_o.pcd", "--stats-json",
                   "stats_o.json", "--timing")
    ev = cli_call(workdir, "evaluate", "--est", "traj_o.tum", "--gt", "gt_o.tum")
    with open(os.path.join(workdir, "stats_o.json")) as f:
        stats = json.load(f)
    row = {"stage": _grab(r"\(stage: (\w+)\)", out, "stage"),
           "ate_rmse_m": float(_grab(r"ATE RMSE: ([0-9.]+) m", ev, "ATE")),
           "ate_limit_m": 2 * OUTDOOR_REF_ATE,
           "map_voxels": int(_grab(r"wrote (\d+) map voxels", out, "map size")),
           "knn_launches": int(_grab(r"knn kernel launches: (\d+)", out, "launches")),
           "stats": stats}
    log("cli_outdoor " + json.dumps(row))
    if row["stage"] != "INITED":
        raise AssertionError(f"outdoor cli run ended {row['stage']}, not INITED")
    if not row["ate_rmse_m"] <= row["ate_limit_m"]:
        raise AssertionError(f"outdoor ATE RMSE {row['ate_rmse_m']} m > {row['ate_limit_m']} m")
    if row["map_voxels"] <= 0 or stats["n_pairs"] != N_SWEEPS - 1:
        raise AssertionError(f"outdoor cli run: {row['map_voxels']} map voxels, "
                             f"{stats['n_pairs']} pairs")
    if row["knn_launches"] <= 0:
        raise AssertionError("the outdoor cli run did not launch the kernel")
    return row


# ---------------------------------------------------------------------------
# phases 12-14: the bag path, the RS-32 rig, viz-normals
# ---------------------------------------------------------------------------


def _same_items(got, want, what):
    """Two sequence logs' items equal: points, rel times, rings and IMU
    bit for bit, stamps within 1e-9 s (ROS time is integer nanoseconds).
    Returns the largest stamp difference."""
    if [x[0] for x in got] != [x[0] for x in want]:
        raise AssertionError(f"{what}: the item kinds differ")
    max_dt = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        max_dt = max(max_dt, abs(x[1] - y[1]))
        for u, v in zip(x[2:], y[2:]):
            if (u is None) != (v is None) or (u is not None and (
                    u.dtype != v.dtype or not np.array_equal(u, v))):
                raise AssertionError(f"{what}: item {i} ({x[0]}) differs")
    if max_dt > 1e-9:
        raise AssertionError(f"{what}: stamps differ by {max_dt} s")
    return max_dt


def cli_bag(workdir, single):
    """Phase 12: export-bag, bag-info, convert-bag and run on phase 5's log,
    each a subprocess; the converted log held against the original."""
    p = lambda name: os.path.join(workdir, name)  # noqa: E731
    cli_call(workdir, "export-bag", "--log", "seq.liol", "--out", "seq.bag")
    info = cli_call(workdir, "bag-info", "--bag", "seq.bag")
    topics = {m.group(1): (m.group(2), int(m.group(3)))
              for m in re.finditer(r"^(\S+)\s+(\S+)\s+(\d+) msgs$", info, re.M)}
    original = list(native.SequenceLog(p("seq.liol")))
    want = {"/imu/data": ("sensor_msgs/Imu", sum(x[0] == "imu" for x in original)),
            "/velodyne_points": ("sensor_msgs/PointCloud2", N_SWEEPS)}
    if topics != want:
        raise AssertionError(f"bag-info lists {topics}, not {want}")
    cli_call(workdir, "convert-bag", "--bag", "seq.bag", "--out", "seq_bag.liol")
    max_stamp_dt = _same_items(list(native.SequenceLog(p("seq_bag.liol"))), original,
                               "convert-bag of export-bag")
    # a log that went through a bag once is a fixed point of the round trip
    cli_inprocess("export-bag", "--log", p("seq_bag.liol"), "--out", p("seq_bag2.bag"),
                  "--compression", "none")
    cli_inprocess("convert-bag", "--bag", p("seq_bag2.bag"), "--out", p("seq_bag2.liol"))
    with open(p("seq_bag.liol"), "rb") as f1, open(p("seq_bag2.liol"), "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("a second bag round trip changed the log")

    out = cli_call(workdir, "run", "--log", "seq_bag.liol", "--profile", "indoor",
                   "--out", "traj_bag.tum", "--map-out", "map_bag.pcd",
                   "--stats-json", "stats_bag.json", "--timing")
    ev = cli_inprocess("evaluate", "--est", p("traj_bag.tum"), "--gt", p("gt.tum"))
    with open(p("stats_bag.json")) as f:
        stats = json.load(f)
    t_sp, q_sp, p_sp = evaluation.load_tum(p("traj.tum"))
    t_b, q_b, p_b = evaluation.load_tum(p("traj_bag.tum"))
    same_len = len(t_b) == len(t_sp)
    row = {"topics": topics, "max_stamp_dt_s": max_stamp_dt,
           "stage": _grab(r"\(stage: (\w+)\)", out, "stage"),
           "ate_rmse_m": float(_grab(r"ATE RMSE: ([0-9.]+) m", ev, "ATE")),
           "ate_rmse_phase5_m": single["ate_rmse_m"], "ref_ate_rmse_m": BAG_REF_ATE,
           "map_voxels": int(_grab(r"wrote (\d+) map voxels", out, "map size")),
           "map_voxels_phase5": single["map_voxels"],
           "max_dp_vs_phase5_m": float(np.max(np.abs(p_b - p_sp))) if same_len else None,
           "min_abs_qdot_vs_phase5": float(np.min(np.abs(np.sum(q_b * q_sp, axis=-1))))
           if same_len else None,
           "knn_launches": int(_grab(r"knn kernel launches: (\d+)", out, "launches")),
           "stats": stats}
    log("cli_bag " + json.dumps(row))
    if row["stage"] != "INITED":
        raise AssertionError(f"run on the converted log ended {row['stage']}, not INITED")
    if not row["ate_rmse_m"] <= ATE_LIMIT:
        raise AssertionError(f"run on the converted log: ATE RMSE {row['ate_rmse_m']} m > "
                             f"{ATE_LIMIT} m")
    if stats["n_pairs"] != N_SWEEPS - 1 or row["map_voxels"] <= 0 or not same_len:
        raise AssertionError(f"run on the converted log: {stats['n_pairs']} pairs, "
                             f"{row['map_voxels']} map voxels, {len(t_b)} poses")
    if row["knn_launches"] <= 0:
        raise AssertionError("the run on the converted log did not launch the kernel")
    return row


@contextlib.contextmanager
def stages_by_pair(stages):
    """Append the stage of each ``LioPipeline.process`` call to ``stages``."""
    orig = PL.LioPipeline.process

    def process(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        stages.append(out["stage"])
        return out

    PL.LioPipeline.process = process
    try:
        yield stages
    finally:
        PL.LioPipeline.process = orig


def rs32_path(workdir, pool):
    """Phase 13: the RS-32 ring-annotated rig: simulate, write the bag with
    the port's ``BagWriter``, convert-bag (a subprocess), then run and
    evaluate in this process, the kernel's launches counted by path."""
    p = lambda name: os.path.join(workdir, name)  # noqa: E731
    with open(p("rs32.yaml"), "w") as f:
        json.dump({"sensor": RS32_SENSOR}, f)  # JSON is a subset of YAML
    traj = sim_trajectory()
    t0 = time.perf_counter()
    sweeps = simulate_sweeps(pool, traj, N_SWEEPS, RS32_AZIMUTH,
                             dict(n_rings=RS32_SENSOR["n_rings"],
                                  lower_deg=RS32_SENSOR["lower_bound_deg"],
                                  upper_deg=RS32_SENSOR["upper_bound_deg"]))
    t_sim = time.perf_counter() - t0
    # firing-major order: ring r of every azimuth step
    rings = np.tile(np.arange(RS32_SENSOR["n_rings"], dtype=np.uint16), RS32_AZIMUTH)
    t_imu = 0.0
    with RB.BagWriter(p("rs32.bag"), compression="bz2") as w:
        for i, (xyz, mask) in enumerate(sweeps):
            t_start = i * SCAN_DT
            while t_imu < t_start + SCAN_DT:
                t_imu += 1.0 / IMU_RATE
                acc, gyr = traj.imu(t_imu)
                w.write("/imu/data", "sensor_msgs/Imu", t_imu, RB.serialize_imu(
                    t_imu, acc.astype(np.float32), gyr.astype(np.float32)))
            t = t_start + SCAN_DT
            w.write("/velodyne_points", "sensor_msgs/PointCloud2", t,
                    RB.serialize_pointcloud2(t, xyz[mask], None, rings[mask]))
    times = [i * SCAN_DT + SCAN_DT for i in range(N_SWEEPS)]
    gt = [synthetic.gt_sensor_pose(traj, t) for t in times]
    evaluation.save_tum(p("gt_rs32.tum"), times, np.stack([g[0] for g in gt]),
                        np.stack([g[1] for g in gt]))
    log(f"simulated {N_SWEEPS} RS-32 sweeps ({len(rings)} rays) in {t_sim:.1f} s, bag "
        f"{os.path.getsize(p('rs32.bag')) / 2**20:.1f} MiB in "
        f"{time.perf_counter() - t0 - t_sim:.1f} s")
    cli_call(workdir, "convert-bag", "--bag", "rs32.bag", "--out", "rs32.liol")
    conv = [x for x in native.SequenceLog(p("rs32.liol")) if x[0] == "sweep"]
    if len(conv) != N_SWEEPS or any(x[4] is None or len(x[4]) != len(x[2]) for x in conv):
        raise AssertionError("the converted RS-32 log lacks its ring channel")
    if not np.array_equal(conv[0][4], rings[sweeps[0][1]]):
        raise AssertionError("the converted RS-32 log's rings differ from the bag's")

    by_path, stages = {}, []
    knn_kernel.reset_launches()
    t0 = time.perf_counter()
    with launches_by_path(by_path, {"rs32_estimator": (EST, "step_program"),
                                    "rs32_odometry": (ODO, "odometry_program")}), \
            stages_by_pair(stages):
        out = cli_inprocess("run", "--log", p("rs32.liol"), "--config", p("rs32.yaml"),
                            "--out", p("traj_rs32.tum"), "--stats-json", p("stats_rs32.json"))
    run_s = time.perf_counter() - t0
    if sum(by_path.values()) != knn_kernel.launches():
        raise AssertionError(f"launches by path {by_path} do not add up to {knn_kernel.launches()}")
    ev = cli_inprocess("evaluate", "--est", p("traj_rs32.tum"), "--gt", p("gt_rs32.tum"))
    with open(p("stats_rs32.json")) as f:
        stats = json.load(f)
    # the same profile over a log without rings must refuse
    try:
        cli.main(["run", "--log", p("seq.liol"), "--config", p("rs32.yaml"),
                  "--out", p("traj_norings.tum")])
    except ValueError as e:
        ring_error = str(e)
    else:
        raise AssertionError("the uneven profile ran on a log without rings")
    if "ring" not in ring_error:
        raise AssertionError(f"the uneven profile failed without the ring error: {ring_error}")
    row = {"rays": int(len(rings)), "points_mean": float(np.mean([len(x[2]) for x in conv])),
           "stage": _grab(r"\(stage: (\w+)\)", out, "stage"),
           "inited_at_pair": stages.index("INITED") if "INITED" in stages else None,
           "ref_inited_at_pair": REF_INITED_AT_PAIR,
           "ate_rmse_m": float(_grab(r"ATE RMSE: ([0-9.]+) m", ev, "ATE")),
           "ate_limit_m": 2 * RS32_REF_ATE, "ring_error": ring_error,
           "knn_launches_by_path": by_path, "run_s": run_s, "stats": stats}
    log("rs32 " + json.dumps(row))
    if row["stage"] != "INITED":
        raise AssertionError(f"the RS-32 run ended {row['stage']}, not INITED")
    if not row["ate_rmse_m"] <= row["ate_limit_m"]:
        raise AssertionError(f"RS-32 ATE RMSE {row['ate_rmse_m']} m > {row['ate_limit_m']} m")
    if stats["n_pairs"] != N_SWEEPS - 1 or by_path.get("rs32_estimator", 0) <= 0:
        raise AssertionError(f"the RS-32 run: {stats['n_pairs']} pairs, launches {by_path}")
    return row, by_path


def _read_ply(path):
    """(vertex rows, header lines) of an ASCII PLY."""
    with open(path) as f:
        head = []
        while not head or head[-1] != "end_header":
            head.append(f.readline().strip())
        rows = np.loadtxt(f, ndmin=2)
    n = int(next(h for h in head if h.startswith("element vertex")).split()[-1])
    if len(rows) != n:
        raise AssertionError(f"{path}: {len(rows)} rows for {n} vertices")
    return rows, head


def viz_path(workdir):
    """Phase 14: viz-normals as a subprocess, then ``cli.normals_view`` in
    this process with the kernel and with the plain search forced."""
    p = lambda name: os.path.join(workdir, name)  # noqa: E731
    cli_call(workdir, "viz-normals", "--log", "seq.liol", "--traj", "gt.tum",
             "--out", "normals.ply", "--map-out", "normals_map.ply",
             "--frames", str(VIZ_FRAMES))
    feats, head = _read_ply(p("normals.ply"))
    local_map, _ = _read_ply(p("normals_map.ply"))
    norms = np.linalg.norm(feats[:, 3:6], axis=1) if len(feats) else np.zeros(0)
    if not len(feats) or "property float quality" not in head or not len(local_map):
        raise AssertionError(f"viz-normals wrote {len(feats)} features, {len(local_map)} "
                             "map points")
    if np.max(np.abs(norms - 1.0)) > 3e-4:  # four printed decimals
        raise AssertionError(f"viz-normals normals are not unit: {np.max(np.abs(norms - 1))}")

    cfg = LioConfig.indoor()
    knn_kernel.reset_launches()
    t0 = time.perf_counter()
    view = cli.normals_view(p("seq.liol"), p("gt.tum"), cfg, frames=VIZ_FRAMES, device=DEV)
    kernel_s = time.perf_counter() - t0
    launches = knn_kernel.launches()
    t0 = time.perf_counter()
    plain = cli.normals_view(p("seq.liol"), p("gt.tum"), cfg, frames=VIZ_FRAMES, device=DEV,
                             force_tiled=True)
    plain_s = time.perf_counter() - t0
    if knn_kernel.launches() != launches:
        raise AssertionError("the forced plain search launched the kernel")
    if not (np.array_equal(view.xyz, plain.xyz) and np.array_equal(view.map_xyz, plain.map_xyz)):
        raise AssertionError("normals_view's queries or local map differ between the searches")
    both = view.ok & plain.ok
    dn = np.abs(view.normals[both] - plain.normals[both]).max(axis=1)
    differing = int(np.sum(view.ok ^ plain.ok) + np.sum(dn > 1e-4))
    accepted = int(np.sum(view.ok | plain.ok))
    row = {"features_cli": len(feats), "map_points_cli": len(local_map),
           "max_unit_err_cli": float(np.max(np.abs(norms - 1.0))),
           "features_kernel": int(view.ok.sum()), "features_plain": int(plain.ok.sum()),
           "rows": len(view.ok), "accepted_by_one": int(np.sum(view.ok ^ plain.ok)),
           "common_apart_1e-4": int(np.sum(dn > 1e-4)),
           "max_normal_diff_common": float(dn.max(initial=0.0)),
           "max_score_diff_common": float(np.max(np.abs(view.scores[both] - plain.scores[both]),
                                                 initial=0.0)),
           "differing_share": differing / max(accepted, 1), "knn_launches": launches,
           "kernel_view_s": kernel_s, "plain_view_s": plain_s}
    log("viz_normals " + json.dumps(row))
    if launches <= 0:
        raise AssertionError("normals_view on the card did not launch the kernel")
    if not len(feats) == row["features_kernel"]:
        raise AssertionError(f"viz-normals wrote {len(feats)} features, normals_view accepted "
                             f"{row['features_kernel']}")
    if row["differing_share"] > VIZ_MAX_DIFF_ROWS:
        raise AssertionError(f"kernel and plain search differ in {differing} of {accepted} "
                             "accepted rows")
    return row, launches


# ---------------------------------------------------------------------------
# phase 15: the distributed estimator
# ---------------------------------------------------------------------------


def corner_rank(rank, world, address, argv, out_dir):
    """One rank of phase 15's use_corner run: ``cli._run_rank`` on the
    indoor profile with ``use_corner``, its searches counted by path (the
    kernel's launches, and the plain version's searches of the corner
    association); writes them to ``corner<rank>.json``."""
    base = LioConfig.indoor()
    cfg = dataclasses.replace(base, estimator=dataclasses.replace(base.estimator,
                                                                  use_corner=True))
    cli._profile = lambda name, path=None: cfg
    args = cli.build_parser().parse_args(argv)
    kernel, plain = {}, {}
    with launches_by_path(kernel, {"corner": (EST, "_calculate_corner_features"),
                                   "surf": (EST, "_calculate_features")}), \
            plain_searches(plain, {"corner": (EST, "_calculate_corner_features")}):
        rc = cli._run_rank(rank, world, address, args)
    with open(os.path.join(out_dir, f"corner{rank}.json"), "w") as f:
        json.dump({"kernel": kernel, "plain": plain}, f)
    return rc


def mesh_paths(workdir, single):
    """Phase 15: the distributed estimator on phase 5's log, 2 ranks on the
    one card: two CLI subprocesses and the use_corner run from here."""
    from lio_mapping_tpu_torch.parallel import multihost as MH

    p = lambda name: os.path.join(workdir, name)  # noqa: E731
    runs, by_path = [], {}
    common = ["run", "--log", "seq.liol", "--profile", "indoor", "--mesh", "2"]
    for tag, flags in (("mesh2", []), ("mesh2_mapshard_ingest", ["--map-shard",
                                                                  "--ingest-shard"])):
        t0 = time.perf_counter()
        cli_call(workdir, *common, *flags, "--out", f"traj_{tag}.tum",
                 "--stats-json", f"stats_{tag}.json")
        runs.append((tag, time.perf_counter() - t0, None))
    t0 = time.perf_counter()
    tag = "mesh2_mapshard_corner"
    argv = common + ["--map-shard", "--log", p("seq.liol"), "--out", p(f"traj_{tag}.tum"),
                     "--stats-json", p(f"stats_{tag}.json")]
    rc = MH.launch(2, corner_rank, argv, workdir)  # rank 0 prints to this stdout
    if rc != 0:
        raise AssertionError(f"the use_corner mesh run exited {rc}")
    corner = []
    for r in range(2):
        with open(p(f"corner{r}.json")) as f:
            corner.append(json.load(f))
    runs.append((tag, time.perf_counter() - t0, corner))

    rows = []
    for tag, wall_s, corner in runs:
        ev = cli_inprocess("evaluate", "--est", p(f"traj_{tag}.tum"), "--gt", p("gt.tum"))
        with open(p(f"stats_{tag}.json")) as f:
            stats = json.load(f)
        mesh = stats["mesh"]
        row = {"run": tag, "stage": stats["stage"],
               "ate_rmse_m": float(_grab(r"ATE RMSE: ([0-9.]+) m", ev, "ATE")),
               "ate_rmse_m_single": single["ate_rmse_m"],
               "per_step_ms_median": stats["per_step_ms_median"],
               "per_step_ms_median_single": single["stats"]["per_step_ms_median"],
               "fps_steady": stats["fps_steady"],
               "fps_steady_single": single["stats"]["fps_steady"],
               "loop_wall_s": stats["loop_wall_s"], "wall_s": wall_s,
               "n_pairs": stats["n_pairs"], "backend": mesh["backend"],
               "consumed_sweeps": mesh["consumed_sweeps"],
               "collectives_per_consumed_sweep": mesh["collectives_per_consumed_sweep"],
               "bytes_per_consumed_sweep": mesh["bytes_per_consumed_sweep"],
               "host_bytes_per_consumed_sweep": mesh["host_bytes_per_consumed_sweep"],
               "host_bytes": [r["host_bytes"] for r in mesh["per_rank"]],
               "devices": [r["device"] for r in mesh["per_rank"]],
               "knn_launches": [r["knn_launches"] for r in mesh["per_rank"]],
               "estimator_knn_launches": [r["estimator_knn_launches"]
                                          for r in mesh["per_rank"]],
               "rank_split_s": [{k: r[k] for k in ("loop_s", "step_s", "collective_s")}
                                for r in mesh["per_rank"]],
               "states_equal": mesh["states_equal"], "corner_by_rank": corner}
        log("mesh_path " + json.dumps(row))
        if row["stage"] != "INITED":
            raise AssertionError(f"{tag} ended {row['stage']}, not INITED")
        if stats["n_pairs"] != N_SWEEPS - 1 or mesh["ranks"] != 2:
            raise AssertionError(f"{tag}: {stats['n_pairs']} pairs on {mesh['ranks']} ranks")
        if not row["ate_rmse_m"] <= ATE_LIMIT:
            raise AssertionError(f"{tag} ATE RMSE {row['ate_rmse_m']} m > {ATE_LIMIT} m")
        if not all(d.startswith("cuda") for d in row["devices"]):
            raise AssertionError(f"{tag}: a rank ran off the card: {row['devices']}")
        if min(row["estimator_knn_launches"]) <= 0:
            raise AssertionError(f"{tag}: the estimator's searches did not launch the kernel "
                                 f"on every rank: {row['estimator_knn_launches']}")
        if not row["states_equal"]:
            raise AssertionError(f"{tag}: the ranks' final states differ")
        if corner is not None:
            for r, c in enumerate(corner):
                if c["kernel"].get("surf", 0) <= 0:
                    raise AssertionError(f"{tag} rank {r}: the surf searches did not launch "
                                         "the kernel")
                if c["kernel"].get("corner", 0) != 0 or c["plain"].get("corner", 0) <= 0:
                    raise AssertionError(f"{tag} rank {r}: the corner searches must run the "
                                         f"plain version only: {c}")
            by_path[f"{tag}_surf"] = sum(c["kernel"]["surf"] for c in corner)
            by_path[f"{tag}_corner"] = sum(c["kernel"].get("corner", 0) for c in corner)
        by_path[tag] = sum(row["knn_launches"])
        rows.append(row)
    return rows, by_path


# ---------------------------------------------------------------------------
# phase 16: the measurement tools
# ---------------------------------------------------------------------------


def tool_runs(workdir):
    """Each tool once, at the cut depths of PERF.md section 4, longest first;
    files they write go to ``workdir``."""
    return [("bench", "--sweeps", "6", "--reps", "2", "--warmup", "0", "--skip-legacy"),
            ("ab_flags", "--sweeps", "56", "--out", os.path.join(workdir, "ab_flags.json")),
            ("bench_cli", "--sweeps", "40", "--profile-config", "small", "--out",
             os.path.join(workdir, "cli_throughput.json")),
            ("debug_corner",),
            ("bench_scaling", "--virtual", "2", "--iters", "5"),
            ("profile_step",)]


def run_tool(workdir, name, *args):
    """``python -m lio_mapping_tpu_torch.tools.<name> <args>`` in ``workdir``
    (its own process group, killed whole past ``TOOL_TIMEOUT_S``); returns
    (name, exit code, stdout, stderr, seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(x for x in (ROOT, env.get("PYTHONPATH")) if x)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", f"lio_mapping_tpu_torch.tools.{name}", *args],
                            cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TOOL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        out, err = "", f"timed out after {TOOL_TIMEOUT_S} s"
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    return name, proc.returncode, out, err, time.perf_counter() - t0


def tools_path(workdir, card):
    """Phase 16: the six tools as subprocesses, ``TOOL_LANES`` at a time;
    each must exit 0 and name the card (``card``: the nvidia-smi line), with
    the checks of each tool's numbers. Returns (row, kernel launches by
    tool)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(TOOL_LANES) as pool:
        done = list(pool.map(lambda run: run_tool(workdir, *run), tool_runs(workdir)))
    wall_s = time.perf_counter() - t0
    res, secs = {}, {}
    for name, rc, out, err, s in done:
        for line in out.splitlines():
            log(f"  tool {name}: {line}")
        if rc != 0:
            raise AssertionError(f"tool {name} exited {rc}:\n{err[-4000:]}")
        res[name], secs[name] = last_json(out), s
    b, ps, ab = res["bench"], res["profile_step"], res["ab_flags"]
    dc, bs = res["debug_corner"], res["bench_scaling"]
    devices = {"bench": [b["device"]], "bench_cli": [res["bench_cli"]["device"]],
               "profile_step": [ps["aggregate"]["device"]],
               "ab_flags": [r["device"] for r in ab["results"]], "bench_scaling": [bs["device"]],
               "debug_corner": [dc["device"]]}
    knn_row = ps["stages"][0]
    row = {"wall_s": wall_s, "seconds": secs,
           "bench": {k: b.get(k) for k in (
               "value", "median_fps", "chunk_fps", "per_sweep_ms", "dispatch_floor_ms",
               "single_process_fps", "outdoor64_fps", "outdoor64_median_fps",
               "outdoor64_chunk_fps", "outdoor64_per_sweep_ms", "outdoor64_dispatch_floor_ms")},
           "bench_cli": {k: res["bench_cli"].get(k) for k in (
               "value", "fps_total", "per_step_ms_median", "ate_rmse_m", "stage")},
           "profile_step": [{k: r.get(k) for k in ("stage", "ms", "gflop", "gbytes_per_s",
                                                   "knn_launches")} for r in ps["stages"]],
           "ab_flags": [{k: r.get(k) for k in ("variant", "ate_rmse_m", "n_inited_poses",
                                               "fps")} for r in ab["results"]],
           "bench_scaling": bs["steps"], "debug_corner": dc["rmse"],
           "debug_corner_limit": {m: 2 * v for m, v in DEBUG_CORNER_REF_RMSE.items()}}
    log("tools " + json.dumps(row))
    for name, devs in devices.items():
        if any(d != card for d in devs):
            raise AssertionError(f"tool {name} ran on {devs}, not on {card}")
    if not (b["value"] > 0 and b.get("outdoor64_fps", 0) > 0):
        raise AssertionError(f"bench: indoor {b['value']} f/s, outdoor_64 "
                             f"{b.get('outdoor64_fps')} f/s")
    if b.get("dispatch_floor_ms") is None or b.get("outdoor64_dispatch_floor_ms") is None:
        raise AssertionError("bench recorded no dispatch_floor_ms")
    if not knn_row["stage"].startswith("knn ") or knn_row["knn_launches"] < 1:
        raise AssertionError(f"profile_step's KNN row did not launch the kernel: {knn_row}")
    for mode, ref in DEBUG_CORNER_REF_RMSE.items():
        if not dc["rmse"][mode] <= 2 * ref:
            raise AssertionError(f"debug_corner {mode}: RMSE {dc['rmse'][mode]} m > 2 x {ref}")
    if [s["n_devices"] for s in bs["steps"]] != [1, 2]:
        raise AssertionError(f"bench_scaling ran {bs['steps']}")
    by_path = {"tool_bench": b["knn_launches"], "tool_bench_outdoor64": b["outdoor64_knn_launches"],
               "tool_profile_step": ps["aggregate"]["knn_launches"],
               "tool_ab_flags": sum(r["knn_launches"] for r in ab["results"]),
               "tool_bench_scaling": sum(s["knn_launches"] for s in bs["steps"]),
               "tool_debug_corner": dc["knn_launches"]}
    return row, by_path


def main():
    t_start = time.perf_counter()
    torch.manual_seed(SEED)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"device {name} x{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # the kernels' sources, one nvcc each, all started together
    t0 = time.perf_counter()
    builders = {"knn.cu": knn_kernel.build, "eigh.cu": EIGH.build, "lu_solve.cu": LU.build,
                "graph_if.cu": SG.build_if_nodes}
    with ThreadPoolExecutor(len(builders)) as ex:
        built = {src: ex.submit(fn) for src, fn in builders.items()}
        built = {src: f.result() for src, f in built.items()}
    knn_kernel._load()
    EIGH._load()
    LU._load()
    log(f"built {', '.join(built)} in {time.perf_counter() - t0:.2f} s")
    for src, path in built.items():
        log(f"build {src} -> {os.path.relpath(path)}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src} " + line.strip())

    traj = sim_trajectory()
    cfg = LioConfig.indoor()
    cases, corner = knn_cases(traj, cfg)
    checked = [check_case(*c) for c in cases + [outdoor64_case()]]
    rows = [row for row, _ in checked]
    max_err = max(r["max_abs_err"] for r in rows)
    corner_row = corner_plain(*corner)
    eigh_rows = [check_eigh(case, torch.as_tensor(m, dtype=torch.float32, device=DEV))
                 for n in EIGH_ORDERS for case, m in eigh_synthetic(n, n)]
    solve_rows = [check_solve(f"damped_{n}", *solve_synthetic(n, n)) for n in SOLVE_ORDERS]

    # sweeps are simulated in worker processes (a fresh interpreter each, so
    # nothing of this process's CUDA state is inherited)
    with ProcessPoolExecutor(SIM_WORKERS, mp_context=get_context("spawn")) as pool, \
            tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        seq = simulate_sequence(pool, traj, N_SWEEPS + N_EXTRA)
        log(f"simulated {len(seq)} sweeps in {time.perf_counter() - t0:.1f} s")
        eigh_paths, solve_paths = {}, {}
        summary, lio_paths, graphed, g_poses = main_path(seq, traj, eigh_paths, solve_paths)
        _, eager_paths, eager_other, sweep_mats = eager_replay(
            seq, traj, workdir, graphed, summary, g_poses)
        eigh_paths.update(eager_other["eigh"])
        solve_paths.update(eager_other["solve"])
        del graphed
        # phase 3's eigh and solve parts on the matrices of a real sweep (the
        # last consumed sweep's of phase 17)
        eigh_rows += [check_eigh(f"sweep_{n}", args[0], sweep_eigh_step(n, sweep_mats))
                      for n, args in sorted(sweep_mats["eigh"].items())]
        solve_rows += [check_solve(f"sweep_{n}", *args)
                       for n, args in sorted(sweep_mats["solve"].items())]
        plain_loop = plain_closed_loop(seq, traj, summary, "knn")
        plain_eigh_loop = plain_closed_loop(seq, traj, summary, "eigh")

        # phases 5 and 11's logs, simulated side by side
        simulating = [cli_start(workdir, "simulate", "--out", "seq.liol", "--gt-out", "gt.tum",
                                "--sweeps", str(N_SWEEPS)),
                      cli_start(workdir, "simulate", "--out", "seq_o.liol", "--gt-out",
                                "gt_o.tum", "--sweeps", str(N_SWEEPS),
                                "--extrinsic-translation", "-2.4", "0", "0.7")]
        try:
            single = cli_lio(workdir, simulating[0])
            cli_two_phase(workdir, single)
            _, loam_paths = cli_loam(workdir)
            _, o64_paths = outdoor64_path(pool)
            corner_by_path = corner_paths(seq, traj)
            _, four_d_paths = cli_4d(workdir)
            outdoor = cli_outdoor(workdir, simulating[1])
        finally:
            for proc, _, _ in simulating:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        bag = cli_bag(workdir, single)
        _, rs32_paths = rs32_path(workdir, pool)
        _, viz_launches = viz_path(workdir)
        _, mesh_by_path = mesh_paths(workdir, single)
        t_tools = time.perf_counter()
        _, tool_paths = tools_path(workdir, smi.splitlines()[0].strip())
        log(f"phase 16 took {time.perf_counter() - t_tools:.1f} s")

    # the device time of each of the search's kernels, under torch.profiler
    # (after every timed run: the profiler may slow later host work)
    for (row, raw) in checked:
        by_kernel = device_kernel_ms(raw, DEV)
        log("knn_device " + json.dumps({"case": row["case"], "device_ms_by_kernel": by_kernel,
                                        "device_ms": sum(by_kernel.values())}))

    # ms: the kernel's device work (bounds, search); wrapper_ms: the
    # whole search as the main path calls it. The first numbers are the
    # estimator's gated shape; scan_to_map holds the LOAM shape's, outdoor64
    # the outdoor_64 estimator's.
    def times(row):
        return {"ms": row["kernel_ms"], "wrapper_ms": row["wrapper_ms"],
                "empty_launch_ms": row["empty_launch_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    main_row = next(r for r in rows if r["case"] == "estimator_5nn_gated")
    map_row = next(r for r in rows if r["case"] == "mapping_5nn_gated")
    bc_row = next(r for r in rows if r["case"] == "builder_corner_5nn_gated")
    o64_row = next(r for r in rows if r["case"] == "estimator64_5nn_gated")
    mesh_rows = {tag: next(r for r in rows if r["case"] == f"estimator_{tag}_5nn_gated")
                 for tag in ("mesh2", "mesh2_block")}
    by_path = {**lio_paths, **eager_paths, **loam_paths, **o64_paths, **corner_by_path, **four_d_paths,
               "cli_outdoor": outdoor["knn_launches"], "cli_bag": bag["knn_launches"],
               **rs32_paths, "viz_normals": viz_launches, **mesh_by_path, **tool_paths}
    kernels = [{
        "name": "knn", "route": "cuda", "source": "lio_mapping_tpu_torch/csrc/knn.cu",
        "replaces": "lio_mapping_tpu/ops/pallas/knn_kernel.py:167",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max_err, **times(main_row),
        "scan_to_map": {"shape": [map_row["Q"], map_row["M"], map_row["k"]], **times(map_row),
                        "corner_plain_ms": corner_row["plain_ms"]},
        "builder_corner": {"shape": [bc_row["Q"], bc_row["M"], bc_row["k"]], **times(bc_row)},
        "outdoor64": {"shape": [o64_row["Q"], o64_row["M"], o64_row["k"]], **times(o64_row)},
        **{tag: {"shape": [r["Q"], r["M"], r["k"]], **times(r)} for tag, r in mesh_rows.items()},
        "plain_closed_loop": {k: plain_loop[k] for k in ("inited_at_sweep", "ate_rmse_m")},
        "plain_eigh_closed_loop": {k: plain_eigh_loop[k] for k in ("inited_at_sweep",
                                                                   "ate_rmse_m")},
    }]
    # eigh: the indoor prior's Schur complement of a real sweep is the main
    # shape; every order checked beside it
    e_main = next(r for r in eigh_rows if r["case"] == "sweep_111")
    kernels.append({
        "name": "eigh", "route": "cuda", "source": "lio_mapping_tpu_torch/csrc/eigh.cu",
        "replaces": "lio_mapping_tpu/ops/gn.py:31, lio_mapping_tpu/ops/marginalization.py:119 "
                    "and :155 (jnp.linalg.eigh inside the jitted step; XLA, not Pallas)",
        "launches": sum(eigh_paths.values()), "launches_by_path": eigh_paths,
        "max_abs_err": e_main["max_abs_err"],
        **{k: e_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "ql_iterations": e_main["ql_iterations"],
        "by_case": {r["case"]: {k: r[k] for k in ("n", "ql_iterations", "rel_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "library_ms")}
                    for r in eigh_rows},
    })
    # solve: the indoor LM's damped system of a real sweep is the main shape
    s_main = next(r for r in solve_rows if r["case"] == "sweep_126")
    kernels.append({
        "name": "lu_solve", "route": "cuda", "source": "lio_mapping_tpu_torch/csrc/lu_solve.cu",
        "replaces": "lio_mapping_tpu/ops/solver.py:397, lio_mapping_tpu/models/estimator.py:369 "
                    "(jnp.linalg.solve inside the jitted step; XLA, not Pallas)",
        "launches": sum(solve_paths.values()), "launches_by_path": solve_paths,
        "max_abs_err": s_main["max_abs_err"],
        **{k: s_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_case": {r["case"]: {k: r[k] for k in ("n", "max_abs_err", "plain_err", "ms",
                                                  "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")}
                    for r in solve_rows},
    })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
