"""One run of one cell: set-up, the measured window, the check.

``run_cell`` is everything ``run.py`` does after it has found a card:

1. set-up: the port's profile (its sizes checked against the
   configuration's file), the loop of sweeps made on the device from the
   seed and copied to host memory, the program built and fed the sweeps of
   its bootstrap and warm-up, so that every CUDA graph the window replays is
   captured and the maps are filled before the clock starts;
2. the window: the traffic's arrivals for ``seconds`` (under the profiler
   with ``trace``);
3. the check, once the window has closed, the peak memory has been read and
   the program is freed: every pose of the window against the trajectory's
   own (``harness/reference.py``); with the 4D builder, a sample of its
   steps drawn from the seed worked out again in float64 from the inputs
   and maps each step read (``harness/scan_to_map.py``); each number against
   its limit (``limits/<cell>.json``).
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from . import drive
from . import reference as REF
from . import scan_to_map as S2M
from . import world
from .spec import Cell, readers
from .trace import Trace, breakdown


def port_config(conf: dict):
    """The port's profile ``conf["profile"]``, with its sizes held to the
    file's ``shipped`` values (a profile that drifted from the file fails
    the run rather than measuring something else)."""
    from lio_mapping_tpu_torch.config import LioConfig

    cfg = {"indoor": LioConfig.indoor, "outdoor": LioConfig.outdoor,
           "outdoor_64": LioConfig.outdoor_64}[conf["profile"]]()
    for key, want in conf.get("shipped", {}).items():
        obj = cfg
        for part in key.split("."):
            obj = getattr(obj, part)
        if obj != want:
            raise ValueError(f"the port's {conf['profile']} profile has {key} = {obj!r}, "
                             f"the configuration file says {want!r}")
    return cfg


def _lm_size(cfg) -> int:
    return 15 * (cfg.estimator.opt_window_size + 1) + 6


def _schur_size(cfg) -> int:
    return 15 * cfg.estimator.opt_window_size + 6


def judge(cell: Cell, mode: str, poses: dict, inited: bool,
          log: Callable = None) -> Dict[str, float]:
    """Every number the check can compare, for the window's poses; ``log``
    takes the builder steps' gaps one by one."""
    conf = cell.config
    nums: Dict[str, float] = {"not_inited": 0.0 if inited else 1.0}
    for tag, kk, qk, tk in (("", "k", "q", "t"), ("4d_", "k4d", "q4d", "t4d")):
        ks = poses.get(kk)
        if ks is None or len(ks) == 0:
            continue
        est_q, est_t = poses[qk], poses[tk]
        if not (np.isfinite(est_q).all() and np.isfinite(est_t).all()):
            nums.update({f"{tag}ate_rmse_m": float("inf"), f"{tag}ate_max_m": float("inf")})
            continue
        gq, gt = REF.gt_poses(conf, ks)
        for key, val in REF.summarize(REF.pose_errors(est_q, est_t, gq, gt)).items():
            nums[tag + key] = val
    ks = poses.get("k_state")
    if ks is not None and len(ks):
        nums.update(REF.state_errors(conf, ks, poses))
    if mode == "lio4d":
        nums.update(builder_gaps(conf, poses.get("snaps", []), poses.get("q4d"),
                                 poses.get("t4d"), log))
    return nums


MAP_TOL_M = 1e-4  # a map row further than this from every reference row is apart


def builder_gaps(conf: dict, snaps, q4d, t4d, log: Callable = None) -> Dict[str, float]:
    """The builder steps kept in the window, each worked out again in
    float64 from its inputs (``harness/scan_to_map.py``): the worst gap
    between the program's pose and the reference's (``4d_step_gap_m``,
    ``4d_step_gap_deg``), the median step's rotation gap
    (``4d_step_gap_deg_median``), and the most map rows of the program that
    the reference's insert at the program's pose does not hold
    (``4d_map_rows_apart``). A run that kept no step reads inf."""
    if not snaps:
        return {"4d_step_gap_m": float("inf"), "4d_step_gap_deg": float("inf"),
                "4d_step_gap_deg_median": float("inf"), "4d_map_rows_apart": float("inf"),
                "4d_steps_checked": 0.0}
    mc = S2M.params(conf)
    apart = 0.0
    iters, gaps_m, gaps_deg = [], [], []
    for j, snap in snaps:
        dev = snap["odom"].device
        out = S2M.Pose(torch.as_tensor(q4d[j], device=dev), torch.as_tensor(t4d[j], device=dev))
        if "_ref" not in snap:  # the same for every planted fault: worked out once
            snap["_ref"] = S2M.refine(snap, mc)
        pose, it, stacks = snap["_ref"]
        iters.append(it)
        gaps_m.append(float(torch.linalg.norm(pose.t - out.t)))
        gaps_deg.append(math.degrees(float(S2M.angle_between(pose.q, out.q))))
        corner, surf = S2M.insert_stacks(snap, stacks, out, mc)
        apart = max(apart, float(
            S2M.rows_apart(snap["after_corner_xyz"], snap["after_corner_mask"], *corner, MAP_TOL_M)
            + S2M.rows_apart(snap["after_surf_xyz"], snap["after_surf_mask"], *surf, MAP_TOL_M)))
    if log is not None:
        log("builder steps checked: gap m " + " ".join(f"{g:.3e}" for g in gaps_m)
            + "; gap deg " + " ".join(f"{g:.3e}" for g in gaps_deg))
    return {"4d_step_gap_m": max(gaps_m), "4d_step_gap_deg": max(gaps_deg),
            "4d_step_gap_deg_median": float(np.median(gaps_deg)), "4d_map_rows_apart": apart,
            "4d_steps_checked": float(len(snaps)), "4d_ref_iterations_mean": float(np.mean(iters))}


FAULTS = ("frozen", "altered")
TRACED_S = 10.0  # seconds of a --trace 1 window under the profiler


def plant(fault: str, poses: dict, seed: int) -> dict:
    """The window's poses as a faulty program would have returned them:
    ``frozen``, a step that returns its state unchanged (every pose of the
    window is the first, and each checked builder step leaves its maps as
    it found them); ``altered``, one answer altered where it is
    produced (one pose, drawn from the seed, moved by 1 m in a direction
    drawn from the seed). Applied to every pose stream the run judges."""
    out = dict(poses)
    rng = np.random.default_rng(seed % (2 ** 63))
    if fault == "frozen":
        maps = ("corner_xyz", "corner_mask", "surf_xyz", "surf_mask")
        out["snaps"] = [(j, dict(snap, **{f"after_{k}": snap[k] for k in maps}))
                        for j, snap in poses.get("snaps", [])]
    for qk, tk in (("q", "t"), ("q4d", "t4d")):
        if tk not in poses or len(poses[tk]) == 0:
            continue
        q, t = poses[qk].copy(), poses[tk].copy()
        if fault == "frozen":
            q[:], t[:] = q[0], t[0]
        elif fault == "altered":
            i = int(rng.integers(len(t)))
            d = rng.normal(size=3)
            t[i] += d / np.linalg.norm(d)
        else:
            raise ValueError(f"unknown fault {fault!r}")
        out[qk], out[tk] = q, t
    return out


def checks(cell: Cell, nums: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} of the numbers the cell's limits name;
    a number the run could not give reads inf."""
    return {name: {"value": nums.get(name, float("inf")), "limit": lim["limit"]}
            for name, lim in cell.limits.get("checks", {}).items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float = None, make_system: Callable = None,
             log: Callable = None, fault: str = None) -> dict:
    """One run; returns the result object ``run.py`` prints last. ``fault``
    plants one of :data:`FAULTS` into the window's answers before the
    check (the check's own test)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    conf, traffic = cell.config, cell.traffic
    mode, arrival = traffic["mode"], traffic["arrival"]
    cfg = port_config(conf)

    # -- set-up ---------------------------------------------------------
    loop = world.Loop(conf, seed, dev)
    host = loop.to_host()
    del loop
    system = (make_system or drive.System)(mode, cfg, dev, host)
    boot_max = int(conf["sequence"]["boot_max_sweeps"])
    k, inited_at = 0, None
    if mode != "loam":
        while system.stage != "INITED" and k < boot_max:
            system.feed(k)
            k += 1
        inited_at = k - 1 if system.stage == "INITED" else None
    inited = mode == "loam" or inited_at is not None
    for _ in range(int(traffic["warm_sweeps" if mode == "loam" else "warm_after_init"])):
        system.feed(k)
        k += 1
    if mode == "lio4d":
        # the builder steps the check works out again: every check_every-th
        # of the window's, from a place drawn from the seed
        every = int(traffic["check_every"])
        system.snapshot_every(every, np.random.default_rng(seed % (2 ** 63)).integers(every))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    captures0 = system.captures()
    setup_s = time.perf_counter() - t_start
    log(f"setup: {setup_s:.4f} s, {k} sweeps fed, INITED at sweep {inited_at}, "
        f"{captures0} graph captures, fill {fills(system)}")

    # -- the window -----------------------------------------------------
    if arrival not in ("live", "replay"):
        raise ValueError(f"unknown arrival {arrival!r}")
    delay = float(cfg.estimator.msg_time_delay) if mode != "loam" else 0.0

    def drive_for(k0: int, sec: float, traced: bool):
        if arrival == "live":
            return drive.live(system, k0, int(round(sec / host.dt)), host.dt, delay, traced)
        return drive.replay(system, k0, sec, int(traffic["in_flight"]), traced)

    tr = None
    if not trace:
        recs, window_s = drive_for(k, seconds, False)
        host_recs, host_window_s = recs, window_s
    else:
        # the profiler costs the host a few microseconds per graph node it
        # replays (~70 ms a 24.5k-node sweep), so the window runs without it
        # (the host's per-layer times) but for its last TRACED_S seconds (the
        # device's), which also keeps the trace's reading short
        from torch.profiler import ProfilerActivity, profile

        traced_s = min(TRACED_S, seconds / 2)
        host_recs, host_window_s = drive_for(k, seconds - traced_s, False)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            w0_ns = time.time_ns()
            traced_recs, window_s = drive_for(host_recs[-1].k + 1, traced_s, True)
            w1_ns = time.time_ns()
        tr = Trace(prof.profiler.kineto_results.events(), w0_ns, w1_ns)
        del prof
        recs = host_recs + traced_recs
    poses = drive.gather_poses(recs)
    if fault is not None:
        poses = plant(fault, poses, seed)
    captures_in_window = system.captures() - captures0
    counts = drive.counters(recs)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    fill = fills(system)
    drop_device_tensors(recs)
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- end-to-end metrics (of the untraced part of the window) ----------
    quantities: Dict[str, float] = {"setup_s": setup_s}
    kinds = [r.kind for r in recs]
    if arrival == "live":
        lat = np.asarray([r.latency_s for r in host_recs]) * 1e3
        late = np.asarray([r.late_s for r in host_recs]) * 1e3
        quantities["latency_p95"] = float(np.percentile(lat, 95))
        log(f"window: {len(host_recs)} sweeps in {host_window_s:.4f} s, latency ms p50 "
            f"{np.percentile(lat, 50):.4f} p95 {np.percentile(lat, 95):.4f} max {lat.max():.4f}; "
            f"released late by ms p50 {np.percentile(late, 50):.4f} max {late.max():.4f}")
    else:
        quantities["rate"] = len(host_recs) / host_window_s
        log(f"window: {len(host_recs)} sweeps in {host_window_s:.4f} s")
    names = dict(traffic["end_to_end"], setup_s="setup_s")
    e2e = {name: quantities[q] for name, q in names.items() if q in quantities}
    host_ms = 1e3 * sum(r.host_s for r in host_recs) / max(len(host_recs), 1)
    log(f"window: host ms a sweep {host_ms:.4f}; "
        f"sweeps by kind {dict((x, kinds.count(x)) for x in sorted(set(kinds)))}; "
        f"graph captures {captures_in_window}; consumed LM iterations mean "
        f"{counts['lm'].mean() if len(counts['lm']) else float('nan'):.4f}; fill {fill}")
    if tr is not None:
        log(f"trace: events {dict(tr.census)}; device activities {len(tr.kernels)}, "
            f"{tr.linked} of them in a span; busy {tr.busy_s:.4f} s of {tr.window_s:.4f} s")

    # -- the check --------------------------------------------------------
    t_check = time.perf_counter()
    nums = judge(cell, mode, poses, inited, log)
    chk = checks(cell, nums)
    for fault in FAULTS:
        f_nums = judge(cell, mode, plant(fault, poses, seed), inited)
        log(f"fault {fault}: " + ", ".join(f"{k_}={v:.6g}" for k_, v in f_nums.items()))
    correct = bool(chk) and all(c["value"] <= c["limit"] for c in chk.values())
    log("numbers: " + ", ".join(f"{k_}={v:.6g}" for k_, v in nums.items()))
    log(f"check: {time.perf_counter() - t_check:.4f} s")
    poses = None

    # -- metrics ----------------------------------------------------------
    if trace:
        ctx = {"trace": tr, "sweeps": host_recs, "counters": counts, "cfg": cfg, "mode": mode,
               "arrival": arrival, "window_s": window_s, "lm_size": _lm_size(cfg),
               "schur_size": _schur_size(cfg), "log": log}
        metrics = {}
        for name, mod in readers(cell).items():
            val = mod.read(ctx)
            if val is not None:
                metrics[name] = {"value": float(val), "unit": mod.UNIT}
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RuntimeError(f"the run has no {m['name']}")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    failed = sum(c["value"] > c["limit"] for c in chk.values())
    result = {"correct": correct, "attempted": len(recs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s if tr is not None else 0.0
        device_info["window_s"] = tr.window_s if tr is not None else window_s
        bd = breakdown(tr)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = chk
    return result


def drop_device_tensors(recs):
    """Drop the device tensors the window's records hold."""
    for r in recs:
        r.pose = r.pose4d = r.lm = r.state = r.snap = None


def fills(system) -> dict:
    """Rows filled in the program's maps (a count for the report line)."""
    maps = {"loam": getattr(getattr(system, "pipe", None), "map_state", None),
            "builder": getattr(getattr(system, "builder", None), "state", None)}
    return {f"{who}_{kind}_map": int(getattr(st, f"{kind}_map").mask.sum())
            for who, st in maps.items() if st is not None for kind in ("surf", "corner")}
