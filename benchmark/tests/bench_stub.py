"""A stand-in for the program, for the CPU tests of the harness: it answers
every sweep with the trajectory's own pose (plus a little noise), and every
4D builder step with the float64 reference's own step on a small map, or
with a planted fault, so that a whole run (set-up, window, check, result
line) runs in seconds without the port's kernels."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import drive  # noqa: E402
from harness import reference as REF  # noqa: E402
from harness import scan_to_map as S2M  # noqa: E402
from harness.spec import Cell, load_spec, resolve  # noqa: E402

torch.set_num_threads(2)  # several test workers share the machine's cores

SPEC_CELLS = [w["name"] for w in load_spec(ROOT)["workloads"]]


class StubSystem:
    """Answers sweep k with the truth, moved by ``noise_m``; ``fault``:
    ``frozen`` (the first answer again and again), ``altered`` (answer 3 of
    the window moved by 1 m), ``never_inited`` (the bootstrap never ends)."""

    def __init__(self, conf, mode, fault=None, noise_m=0.01, seed=0, host=None):
        self.conf, self.mode, self.fault, self.host = conf, mode, fault, host
        self.noise_m = noise_m
        self.rng = np.random.default_rng(seed)
        self.device = torch.device("cpu")
        self.fed = 0
        self.first = None
        self.builder = StubBuilder(conf) if mode == "lio4d" else None
        self.builder_steps, self.snap_every, self.snap_phase = 0, 0, 0

    snapshot_every = drive.System.snapshot_every
    _snap_due = drive.System._snap_due

    @property
    def stage(self):
        if self.mode == "loam":
            return "LOAM"
        if self.fault == "never_inited":
            return "NOT_INITED"
        return "INITED" if self.fed >= 5 else "NOT_INITED"

    def captures(self):
        return 0

    def feed(self, k, trace=False):
        t0 = time.perf_counter()
        q, p = REF.gt_poses(self.conf, [k])
        p = p[0] + self.rng.normal(scale=self.noise_m, size=3)
        q = q[0]
        if self.fault == "frozen":
            if self.first is None:
                self.first = (q, p)
            q, p = self.first
        if self.fault == "altered" and k == self.alter_at:
            p = p + np.array([1.0, 0.0, 0.0])
        self.fed += 1
        booting = self.stage != "INITED" and self.mode != "loam"
        kind = "boot" if booting else ("consumed" if k % 2 == 0 else "skipped")
        if self.mode == "loam":
            kind = "loam_map" if k % 2 else "loam_assoc"
        rec = drive.Sweep(k, kind, time.perf_counter() - t0,
                          (torch.as_tensor(q, dtype=torch.float32),
                           torch.as_tensor(p, dtype=torch.float32)))
        if self.mode == "lio4d" and kind == "consumed":
            xyz, mask = (torch.as_tensor(a) for a in self.host.sweep(k)[:2])
            corner = SimpleNamespace(xyz=xyz[::18], mask=mask[::18])
            surf = SimpleNamespace(xyz=xyz[::6], mask=mask[::6])
            snap = (drive.builder_inputs(self.builder.state, corner, surf, rec.pose)
                    if self._snap_due() else None)
            rec.pose4d = self.builder.step(corner, surf, rec.pose)
            if snap is not None:
                snap.update(drive.builder_maps(self.builder.state, "after_"))
                rec.snap = snap
            self.builder_steps += 1
        return rec

    alter_at = 30  # a sweep inside every test window


class StubBuilder:
    """The 4D builder's stand-in: the float64 reference's step
    (``harness/scan_to_map.py``) on maps of ``CAP`` rows, kept in float32
    as the program keeps them."""

    CAP = 1024

    def __init__(self, conf):
        self.mc = S2M.params(conf)

        def store():
            return SimpleNamespace(xyz=torch.zeros((self.CAP, 3)),
                                   mask=torch.zeros(self.CAP, dtype=torch.bool))

        ident = (torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3))
        self.state = SimpleNamespace(corner_map=store(), surf_map=store(),
                                     pose=SimpleNamespace(q=ident[0], t=ident[1]),
                                     pose_bef=SimpleNamespace(q=ident[0], t=ident[1]),
                                     initialized=torch.tensor(False))

    def step(self, corner, surf, odom) -> tuple:
        snap = drive.builder_inputs(self.state, corner, surf, odom)
        pose, _, stacks = S2M.refine(snap, self.mc)
        (c_xyz, c_mask), (s_xyz, s_mask) = S2M.insert_stacks(snap, stacks, pose, self.mc)
        q, t = pose.q.float(), pose.t.float()
        self.state = SimpleNamespace(
            corner_map=SimpleNamespace(xyz=c_xyz.float(), mask=c_mask),
            surf_map=SimpleNamespace(xyz=s_xyz.float(), mask=s_mask),
            pose=SimpleNamespace(q=q, t=t),
            pose_bef=SimpleNamespace(q=odom[0].float(), t=odom[1].float()),
            initialized=torch.tensor(True))
        return q, t


# cells that BENCHMARK.json does not declare (PERF.md, Open questions), made
# here as data: they run the harness's live arrival and LOAM mode
OPEN_CELLS = {
    "indoor-live": {"mode": "lio", "arrival": "live", "warm_after_init": 12,
                    "end_to_end": {"pose_latency_p95_ms": "latency_p95"}},
    "indoor-loam-replay": {"mode": "loam", "arrival": "replay", "in_flight": 4,
                           "warm_sweeps": 200, "end_to_end": {"loam_sweeps_per_s": "rate"}},
}
OPEN_LIMITS = {"checks": {"not_inited": {"limit": 0}, "ate_max_m": {"limit": 0.55},
                          "rpe_max_m": {"limit": 0.6}}}


def open_cell(name: str) -> Cell:
    traffic = OPEN_CELLS[name]
    metric = next(iter(traffic["end_to_end"]))
    setup = {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}
    return Cell(name, 1, json.loads((BENCH / "configs" / "indoor_vlp16.json").read_text()),
                dict(traffic), json.loads(json.dumps(OPEN_LIMITS)),
                [setup, {"name": metric, "unit": "ms", "better": "lower", "bound": 0.25,
                         "source": "host_clock"}], [])


def tiny_cell(name: str, fault=None):
    """The cell ``name`` (of BENCHMARK.json, or an open one) with its
    configuration cut to a 90-step azimuth (the harness's CPU tests), and a
    factory of stubs."""
    cell = open_cell(name) if name in OPEN_CELLS else resolve(load_spec(ROOT), ROOT, name)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["sensor"]["n_azimuth"] = 90
    cell.traffic = dict(cell.traffic)
    for key in ("warm_after_init", "warm_sweeps"):
        if key in cell.traffic:
            cell.traffic[key] = 25
    if "check_every" in cell.traffic:
        cell.traffic["check_every"] = 1
    mode = cell.traffic["mode"]

    def make(mode_, cfg, dev, host):
        return StubSystem(cell.config, mode_, fault, host=host)

    assert isinstance(cell, Cell)
    return cell, make, mode
