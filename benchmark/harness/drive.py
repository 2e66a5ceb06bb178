"""The system under test and the two ways a cell drives it.

``System`` wraps the program's public entry points for one traffic mode:

* ``lio``: ``LioPipeline.process`` on every sweep with its IMU interval, a
  consumed sweep's cloud prefetched as ``cli run`` does;
* ``lio4d``: the same, and ``MapBuilder.step`` on the estimator's output of
  every consumed INITED sweep, as ``cli run --enable-4d`` does;
* ``loam``: ``LoamPipeline.process`` on every sweep (no IMU).

Every pose stays on the device as the program returns it; the loops read
them back where a user would: ``live`` after each sweep, ``replay`` once at
the end of the window. After ``snapshot_every``, every n-th builder step
also keeps device copies of what it read and of the maps it left
(``builder_inputs``, ``builder_maps``), for the check to work out again.

``live`` releases sweep ``i`` of the window at its due time, the end stamp
of the sweep plus the profile's ``msg_time_delay`` on the window's clock,
and times it from then until its pose is on the host; a sweep released late
because the one before it ran long is timed from its due time all the same.
``replay`` feeds sweeps as fast as the program takes them, holding at most
``in_flight`` sweeps enqueued ahead of the device, stops feeding when the
window's seconds are up and stops the clock when the last pose is on the
host.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class Sweep:
    """One fed sweep: its index in the run, what the program did with it,
    the host seconds the feed took, and the device tensors it returned."""

    k: int
    kind: str
    host_s: float
    pose: tuple                     # (q, t) on the device
    pose4d: Optional[tuple] = None  # the builder's (q, t), lio4d
    lm: Optional[torch.Tensor] = None  # consumed: the LM iterations it ran
    state: Optional[tuple] = None   # consumed: (v, ba, bg, ex_q, ex_p) on the device
    late_s: float = 0.0             # live: release after the due time
    latency_s: float = 0.0          # live: pose on the host after the due time
    snap: Optional[dict] = None     # lio4d: a builder step's inputs and maps, for the check


STATE_KEYS = ("velocity", "ba", "bg", "ex_q", "ex_p")


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class System:
    """The program for one traffic mode on one device."""

    def __init__(self, mode: str, cfg, device, host_loop):
        from lio_mapping_tpu_torch.models import pipeline as PL

        self.mode, self.cfg, self.device, self.host = mode, cfg, torch.device(device), host_loop
        self.builder = None
        self.builder_steps = 0
        self.snap_every, self.snap_phase = 0, 0
        if mode == "loam":
            self.pipe = PL.LoamPipeline(cfg, device=self.device, dtype=torch.float32)
        elif mode in ("lio", "lio4d"):
            self.pipe = PL.LioPipeline(cfg, device=self.device, dtype=torch.float32)
            if mode == "lio4d":
                from lio_mapping_tpu_torch.models import map_builder as MB

                self.builder = MB.MapBuilder(cfg, self.device, torch.float32)
        else:
            raise ValueError(f"unknown traffic mode {mode!r}")

    @property
    def stage(self) -> str:
        return "LOAM" if self.mode == "loam" else self.pipe.stage

    def captures(self) -> int:
        n = self.pipe.graph_captures()
        return n + (self.builder.graph_captures() if self.builder is not None else 0)

    def snapshot_every(self, every: int, phase: int):
        """From now on keep the inputs and maps of builder step ``phase``,
        ``phase + every``, ... (counted from here) for the check."""
        self.builder_steps, self.snap_every, self.snap_phase = 0, int(every), int(phase)

    def _snap_due(self) -> bool:
        return (self.snap_every > 0 and self.builder_steps >= self.snap_phase
                and (self.builder_steps - self.snap_phase) % self.snap_every == 0)

    def feed(self, k: int, trace: bool = False) -> Sweep:
        """Sweep ``k`` of the run through the program."""
        xyz, mask, dts, acc, gyr, acc0, gyr0 = self.host.sweep(k)
        t0 = time.perf_counter()
        if self.mode == "loam":
            mapped = (self.pipe.frame_count + 1) % self.cfg.odometry.io_ratio == 0
            kind = "loam_map" if mapped else "loam_assoc"
            with _span("sweep." + kind, trace):
                out = self.pipe.process(xyz, mask)
            pose = out["laser_pose"]
            return Sweep(k, kind, time.perf_counter() - t0, (pose.q, pose.t))
        pipe = self.pipe
        booting = pipe.stage != "INITED"
        consume = pipe.will_consume()
        kind = "boot" if booting else ("consumed" if consume else "skipped")
        with _span("sweep." + kind, trace):
            samples = pipe.make_samples(dts, acc, gyr, acc0, gyr0)
            if consume:
                out = pipe.process(pipe.prefetch_cloud(xyz, mask), None, samples)
            else:
                out = pipe.process(xyz, mask, samples)
        pose = out["laser_pose"]
        rec = Sweep(k, kind, 0.0, (pose.q, pose.t))
        if "solver_iterations" in out:
            rec.kind = "consumed"
            rec.lm = out["solver_iterations"]
            rec.state = tuple(out[key] for key in STATE_KEYS)
        if (self.builder is not None and out.get("stage") == "INITED"
                and "corner_cloud" in out and not out.get("predicted")):
            snap = None
            if self._snap_due():
                snap = builder_inputs(self.builder.state, out["corner_cloud"],
                                      out["surf_cloud"], pose)
            with _span("builder.step", trace):
                p4 = self.builder.step(out["corner_cloud"], out["surf_cloud"], pose)["pose"]
            if snap is not None:
                snap.update(builder_maps(self.builder.state, "after_"))
                rec.snap = snap
            self.builder_steps += 1
            rec.pose4d = (p4.q, p4.t)
        rec.host_s = time.perf_counter() - t0
        return rec


def builder_maps(state, prefix: str = "") -> dict:
    """Copies of the builder's two map stores (xyz, mask)."""
    return {f"{prefix}{kind}_{part}": getattr(getattr(state, f"{kind}_map"), part).clone()
            for kind in ("corner", "surf") for part in ("xyz", "mask")}


def builder_inputs(state, corner_cloud, surf_cloud, odom) -> dict:
    """Copies of everything a builder step reads: its maps and poses, the
    sweep's corner and surf clouds and the estimator's pose (as (q, t)
    concatenated)."""
    snap = builder_maps(state)
    snap.update(pose=torch.cat([state.pose.q, state.pose.t]),
                pose_bef=torch.cat([state.pose_bef.q, state.pose_bef.t]),
                initialized=state.initialized.clone(), odom=torch.cat([odom[0], odom[1]]),
                corner_cloud=corner_cloud.xyz.clone(), corner_cloud_mask=corner_cloud.mask.clone(),
                surf_cloud=surf_cloud.xyz.clone(), surf_cloud_mask=surf_cloud.mask.clone())
    return snap


def _sleep_until(t: float):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left - 0.0005 if left > 0.001 else 0)


def live(system: System, k0: int, n: int, dt: float, delay: float,
         trace: bool = False) -> tuple:
    """``n`` sweeps from ``k0`` released at 1 / dt Hz; returns (sweeps,
    window seconds)."""
    recs = []
    start = time.perf_counter() + 0.05
    for i in range(n):
        due = start + (i + 1) * dt + delay
        _sleep_until(due)
        released = time.perf_counter()
        rec = system.feed(k0 + i, trace)
        with _span("readback", trace):
            torch.cat(rec.pose).cpu()
        rec.late_s, rec.latency_s = released - due, time.perf_counter() - due
        recs.append(rec)
    return recs, time.perf_counter() - start


def replay(system: System, k0: int, seconds: float, in_flight: int,
           trace: bool = False) -> tuple:
    """Sweeps from ``k0`` as fast as the program takes them for ``seconds``;
    returns (sweeps, window seconds to the last pose on the host)."""
    recs, events = [], []
    on_card = system.device.type == "cuda"
    start = time.perf_counter()
    k = k0
    while time.perf_counter() - start < seconds:
        if len(events) >= in_flight:
            events[len(events) - in_flight].synchronize()
        recs.append(system.feed(k, trace))
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
        k += 1
    with _span("readback", trace):
        gather_poses(recs)
    return recs, time.perf_counter() - start


def gather_poses(recs: List[Sweep]) -> dict:
    """Every pose of ``recs`` on the host, float64: {"k", "q", "t"} and the
    builder's {"k4d", "q4d", "t4d"}."""
    out = {"k": np.asarray([r.k for r in recs], np.int64)}
    if recs:
        both = torch.stack([torch.cat(r.pose) for r in recs]).double().cpu().numpy()
        out["q"], out["t"] = both[:, :4], both[:, 4:]
    cons = [r for r in recs if r.state is not None]
    out["k_state"] = np.asarray([r.k for r in cons], np.int64)
    if cons:
        flat = torch.stack([torch.cat(r.state) for r in cons]).double().cpu().numpy()
        cuts = np.cumsum([3, 3, 3, 4])
        out.update(zip(STATE_KEYS, np.split(flat, cuts, axis=1)))
    four = [r for r in recs if r.pose4d is not None]
    out["k4d"] = np.asarray([r.k for r in four], np.int64)
    if four:
        both = torch.stack([torch.cat(r.pose4d) for r in four]).double().cpu().numpy()
        out["q4d"], out["t4d"] = both[:, :4], both[:, 4:]
    # the builder steps kept for the check, by their place in the 4D poses
    out["snaps"] = [(j, r.snap) for j, r in enumerate(four) if r.snap is not None]
    return out


def counters(recs: List[Sweep]) -> dict:
    """The estimator's LM iterations of the consumed sweeps, on the host:
    {"lm": (N,)}."""
    cons = [r for r in recs if r.lm is not None]
    return {"lm": torch.stack([r.lm for r in cons]).cpu().numpy() if cons else np.zeros(0)}
