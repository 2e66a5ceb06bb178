"""Full pipeline orchestration on one device (port of
lio_mapping_tpu.models.pipeline).

    raw sweep --process_sweep--> features --odometry_step--> laser odom
        --(NOT_INITED: fill window, initializer)--> INITED
        --lio_step--> tightly-coupled window odometry

``LioPipeline``: the estimator consumes every ``odom_io``-th sweep; skipped
sweeps get the IMU-predicted pose (on the device, or with ``host_predict``
in numpy from the last consumed step's state). Bootstrap
(``_try_initialize``) runs on the host in float64 numpy and moves its
results to the device explicitly. A sweep's cloud travels as one packed
(N, 4|5) float array (x, y, z, mask[, ring]); ``prefetch_cloud`` starts
that copy early from a pinned host buffer.

``LioPipeline(mesh=...)``: this process is one rank of a mesh
(``parallel/multihost.py``); every rank feeds the same sweeps, runs the
front end, the bootstrap and the IMU predicts itself, and runs the
estimator step distributed (``parallel/lio_dist.py``), so every rank holds
the same state and outputs. ``map_shard`` shards the local map too;
``ingest_shard`` uploads only this rank's rows of each packed cloud and
reassembles the cloud on the device (``multihost.all_gather_rows``) before
the front end. Without a mesh both are ignored, as in the reference.

On a CUDA device without a mesh (``graphs``, the default there) every
sweep is one CUDA graph (``models/step_graph.py``), as the reference runs
one jitted program a sweep: a bootstrap sweep's front end and
``odometry.odometry_program`` (with the init window's stacks on a push
sweep), the consumed INITED sweep's front end and
``estimator.step_program``, each captured once per cloud bucket and
replayed, the GNs' and the LM's early exits decided on the device by
conditional nodes, so the sweep reads nothing back (``_try_initialize``
reads the window back on purpose, on the host in float64 as in the
reference); the skipped sweep's device predict is one graph. The
odometry's and the estimator's states live in the graphs' static buffers
from sweep to sweep. The sweep's cloud (padded with
masked rows to a bucket of row counts, which changes no result), start
azimuth and IMU interval are staged into the graphs' static input buffers
without a host sync, and everything ``process`` returns is a copy that no
later replay overwrites. ``graphs=False`` runs the same program eagerly,
as ``jax.disable_jit`` does for the reference; the CPU and the mesh
always do.

With the tracer on (``utils/timing.py``) ``process`` is a host span
(``process``, its note the sweep's kind: boot, consumed, skipped or loam,
a stamp launched before its device work), inside which the spans ``stage``
(each copy of a cloud or an IMU interval to the device, with its bytes),
``capture`` and ``replay`` (the runner's), ``init`` (the host
initialisation) and ``outputs`` (the copies handed out) lie; a graphed
sweep's front end ends at a stamp of its own (``front``).

``LoamPipeline``: the LiDAR-only baseline, front end -> scan-to-scan
odometry -> scan-to-map refinement (``models/mapping.py``) every
``odometry.io_ratio``-th sweep; with ``graphs`` one CUDA graph a sweep
too.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import LioConfig
from ..ops import preintegration as PI
from ..ops import voxel as VX
from ..ops.cloud import Cloud
from ..parallel import lio_dist
from ..parallel import multihost as MH
from ..utils import quaternion as quat
from ..utils import timing as TM
from ..utils.se3 import Pose
from ..utils.tree import tree_map, tree_stack
from . import estimator as EST
from . import initializer as INIT
from . import mapping as MAP
from . import odometry as ODO
from . import step_graph as SG
from .point_processor import StartOriTracker, process_sweep, raw_start_ori


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _check_ring(cfg: LioConfig, ring):
    """The uneven (ring-annotated) profile REQUIRES per-point rings:
    elevation binning means nothing for unevenly spaced lasers
    (processor_node.cc:68-74)."""
    if cfg.sensor.uneven and ring is None:
        raise ValueError(
            "config has sensor.uneven=True (ring-annotated rig) but no per-point ring IDs "
            "were supplied: record the bag with the driver's `ring` PointField or use an "
            "elevation-binned profile")


def _pack_xyzw_np(xyz, mask, ring=None, out: np.ndarray | None = None) -> np.ndarray:
    """Host (N,3) + (N,) mask [+ (N,) ring] -> one packed f32 (N, 4|5)
    buffer (into ``out`` when given)."""
    w = 5 if ring is not None else 4
    if out is None:
        out = np.empty((len(xyz), w), np.float32)
    out[:, 0:3] = np.asarray(xyz)[:, 0:3]
    out[:, 3] = np.asarray(mask, np.float32)
    if ring is not None:
        out[:, 4] = np.asarray(ring, np.float32)
    return out


def _upload_cloud(xyz, mask, ring, device, dtype, non_blocking: bool = False):
    """The packed cloud on ``device`` in ``dtype``: one host buffer, one
    copy. On a CUDA device the buffer is pinned and fresh per call, so a
    ``non_blocking`` copy in flight is never overwritten."""
    w = 5 if ring is not None else 4
    if device.type == "cuda":
        host = torch.empty((len(xyz), w), dtype=torch.float32, pin_memory=True)
        _pack_xyzw_np(xyz, mask, ring, out=host.numpy())
        return host.to(device, non_blocking=non_blocking).to(dtype)
    return torch.from_numpy(_pack_xyzw_np(xyz, mask, ring)).to(dtype)


def _feats_from_xyzw(xyzw: torch.Tensor, start_ori, cfg: LioConfig):
    """Packed (N, 4|5) cloud -> features; column 4 (present iff
    ``cfg.sensor.uneven``) carries the per-point ring. ``start_ori``: None,
    a float or a device scalar."""
    so = start_ori
    if start_ori is not None and not torch.is_tensor(start_ori):
        so = torch.full((), start_ori, dtype=xyzw.dtype, device=xyzw.device)
    rings = xyzw[:, 4].to(torch.int32) if cfg.sensor.uneven else None
    return process_sweep(xyzw[:, 0:3].contiguous(), xyzw[:, 3] > 0.5, cfg, so, rings)


def cloud_rows_bucket(n: int) -> int:
    """The row count a graphed sweep's cloud is padded to (with masked
    rows): ``n`` rounded up to a multiple of 2^(bit length - 4), at least
    1024 (at most an eighth more rows). Masked rows sort after every valid
    one and land nowhere, so the front end's result does not change; the
    front end's graphs are keyed by the bucket."""
    step = max(1024, 1 << max(n.bit_length() - 4, 0))
    return max(step, -(-n // step) * step)


def _stage_cloud(g: SG.StepGraphs, v: dict, start_ori, dtype, xyz=None, mask=None, ring=None,
                 pf: "PrefetchedCloud" = None):
    """A graphed sweep's inputs: the packed cloud (``pf``, or
    ``xyz``/``mask``/``ring``) padded with masked rows into the runner's
    buffer for its row bucket as ``v["xyzw"]``, and the start azimuth into
    ``v["start_ori"]``, without a host sync. Returns (rows, width), the
    part of the graph's key the cloud sets."""
    n = len(pf.xyzw) if pf is not None else len(xyz)
    width = pf.xyzw.shape[1] if pf is not None else (4 if ring is None else 5)
    rows = cloud_rows_bucket(n)
    buf = g.buffer(("xyzw", rows), (rows, width), torch.float32)
    with TM.span("stage", "cloud", 0 if pf is not None else rows * width * 4):
        if pf is not None:
            buf[:n].copy_(pf.xyzw)
            buf[n:].zero_()
        else:
            host = torch.zeros((rows, width), dtype=torch.float32, pin_memory=g.capture)
            _pack_xyzw_np(xyz, mask, ring, out=host.numpy()[:n])
            buf.copy_(host, non_blocking=True)
        v["xyzw"] = buf
        if start_ori is not None:
            v["start_ori"] = g.buffer("start_ori", (), dtype)
            v["start_ori"].fill_(start_ori)
    return rows, width


def _front(g: SG.StepGraphs, v: dict, dtype, cfg: LioConfig):
    """The front end inside a graphed sweep's program, on its staged
    cloud; a ``front`` stamp marks its end."""
    feats = _feats_from_xyzw(v["xyzw"].to(dtype), v.get("start_ori"), cfg)
    g.mark("front")
    return feats


def _predict_pose(st, samples: PI.ImuSamples, w: int) -> Pose:
    """IMU-predicted laser pose from the newest window state, mean-only."""
    pre = PI.integrate_mean(samples, st.bas[w], st.bgs[w])
    q, p, _ = PI.apply_deltas(pre, st.qs[w], st.ps[w], st.vs[w], st.g_vec)
    return EST.laser_pose(q, p, st.q_lb, st.t_lb)


class PrefetchedCloud:
    """A sweep whose packed cloud is already on its way to the device
    (:meth:`LioPipeline.prefetch_cloud`); pass it to
    :meth:`LioPipeline.process` in place of ``(xyz, mask)``."""

    __slots__ = ("xyzw", "raw_ori")

    def __init__(self, xyzw, raw_ori):
        self.xyzw = xyzw          # (N, 4|5) tensor on the device
        self.raw_ori = raw_ori    # host float from raw_start_ori, or None


class LioPipeline:
    """Sweep-by-sweep LIO: feed (sweep, imu batch) pairs, get poses out.

    ``host_predict``: the pose of a skipped sweep is integrated in numpy
    from the last consumed step's state, whose copy to the host starts
    without blocking when that step is enqueued (before the first consumed
    step, and after ``load``, the device predict runs). Off under a mesh.

    ``mesh`` (a ``parallel.multihost.Mesh``): run as one rank of it, on the
    mesh's device unless ``device`` is given (see the module docstring).

    ``graphs``: replay each sweep (bootstrap, INITED step, predict) as a
    CUDA graph; the default on a CUDA device without a mesh, and there
    only (gloo's collectives cannot be captured). ``False`` runs the same
    programs eagerly. A capture that fails raises; the pipeline never falls
    back to the eager path by itself."""

    def __init__(self, cfg: LioConfig, device=None, dtype=torch.float32,
                 mesh: MH.Mesh = None, map_shard: bool = False, ingest_shard: bool = False,
                 host_predict: bool = False, graphs: bool = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            lio_dist.check_caps(cfg, mesh.size)
            device = mesh.device if device is None else device
        self.map_shard = bool(map_shard) and mesh is not None
        self.ingest_shard = bool(ingest_shard) and mesh is not None
        self.device = resolve_device(device)
        self.dtype = dtype
        TM.from_env(self.device)
        on_card = self.device.type == "cuda" and mesh is None
        if graphs and not on_card:
            raise ValueError("graphs=True needs a CUDA device and no mesh")
        self.graphs = on_card if graphs is None else bool(graphs)
        self._step_graphs = None  # the StepGraphs of the graphed step, made at first use
        self.host_predict = bool(host_predict) and mesh is None
        self._snap = None  # (host copies of the last consumed step's state, event)
        self.odom_state = ODO.init_state(cfg, dtype, self.device)
        self.est_state = EST.init_state(cfg, dtype, self.device)
        self.stage = "NOT_INITED"
        self.frame_count = 0
        self._io_ratio = max(1, cfg.estimator.odom_io)
        self._pending: List[np.ndarray] = []  # packed IMU since last consume
        self._compact_count = 0
        self._init_odom_poses: List[Pose] = []
        self._init_samples: List[np.ndarray] = []  # packed host buffers
        self._init_stacks: List[tuple] = []
        self._start_ori_tracker = (StartOriTracker(cfg.sensor.rad_diff)
                                   if cfg.sensor.infer_start_ori else None)

    # ------------------------------------------------------------------
    def _merge_pending(self) -> np.ndarray:
        m = self.cfg.estimator.imu.max_imu_per_frame
        if not self._pending:
            return np.zeros((m + 1, 7), np.float32)
        if len(self._pending) == 1:
            return self._pending[0]
        return PI.merge_packed_np(self._pending, m)

    def make_samples(self, dts, accs, gyrs, acc0, gyr0) -> np.ndarray:
        """Pack host IMU arrays into ONE padded (M+1, 7) host buffer."""
        return PI.pack_samples_np(dts, accs, gyrs, acc0, gyr0,
                                  self.cfg.estimator.imu.max_imu_per_frame)

    def _host_f32(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` as a float32 host tensor, pinned on a CUDA device (fresh
        per call, so a copy from it in flight is never overwritten)."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if self.device.type != "cuda":
            return t
        return torch.empty(t.shape, dtype=torch.float32, pin_memory=True).copy_(t)

    def _samples(self, packed: np.ndarray) -> PI.ImuSamples:
        with TM.span("stage", "imu", packed.size * 4):
            t = self._host_f32(packed).to(self.device, non_blocking=True).to(self.dtype)
        return PI.unpack_samples(t)

    def _is_compact(self, frame_count: int) -> bool:
        """io_ratio cadence: does the sweep numbered ``frame_count``
        (1-based) consume its cloud (PointOdometry.cc:725-729)?"""
        io = self._io_ratio
        return io < 2 or (frame_count % io == 1)

    def will_consume(self, offset: int = 1) -> bool:
        """Will the sweep ``offset`` calls from now consume its cloud?
        Skipped sweeps on the INITED deskew path never use theirs, so a
        caller need not prefetch them (a conservative True costs one copy)."""
        e = self.cfg.estimator
        if self.stage != "INITED" or not (e.enable_deskew or e.cutoff_deskew):
            return True
        return self._is_compact(self.frame_count + offset)

    def prefetch_cloud(self, xyz, mask, ring=None) -> PrefetchedCloud:
        """Start the host-to-device copy of a FUTURE sweep's packed cloud
        now; pass the handle to :meth:`process` in place of ``(xyz, mask)``."""
        _check_ring(self.cfg, ring)
        raw = raw_start_ori(xyz, mask) if self._start_ori_tracker is not None else None
        return PrefetchedCloud(self._commit_cloud(xyz, mask, ring, non_blocking=True), raw)

    def _commit_cloud(self, xyz, mask, ring=None, non_blocking: bool = False) -> torch.Tensor:
        """The packed (N, 4|5) cloud on this rank's device. With
        ``ingest_shard`` this rank uploads only its slice of the rows, padded
        to ceil(N / D) rows with mask 0, and the slices are gathered in rank
        order and cut back to the N rows: the front end gets the same cloud
        as without it."""
        width = 4 if ring is None else 5
        if not self.ingest_shard:
            with TM.span("stage", "cloud", len(xyz) * width * 4):
                return _upload_cloud(xyz, mask, ring, self.device, self.dtype, non_blocking)
        n, mesh = len(xyz), self.mesh
        per = -(-n // mesh.size)
        lo, hi = min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
        with TM.span("stage", "cloud", (hi - lo) * width * 4):
            part = _upload_cloud(xyz[lo:hi], mask[lo:hi],
                                 None if ring is None else ring[lo:hi], self.device, self.dtype,
                                 non_blocking)
        if hi - lo < per:
            part = torch.cat([part, part.new_zeros((per - (hi - lo), part.shape[1]))])
        return MH.all_gather_rows(part, mesh)[:n]

    def _predict(self, packed: np.ndarray) -> Pose:
        """IMU-predicted laser pose for a skipped sweep (the reference's
        /predict_laser_odom, Estimator.cc:744-758), mean-only; with
        ``graphs`` one replayed graph."""
        w = self.cfg.estimator.window_size
        if not self.graphs:
            return _predict_pose(self.est_state, self._samples(packed), w)
        g, v = self._graph_inputs(packed)
        dtype = self.dtype
        g.stretch(("predict",), lambda v: {"pred": _predict_pose(
            v["state"], PI.unpack_samples(v["packed"].to(dtype)), w)}, v)
        with TM.span("outputs"):
            return tree_map(torch.clone, v["pred"])

    def graph_captures(self) -> int:
        """CUDA graphs captured so far (0 on the eager path)."""
        return 0 if self._step_graphs is None else self._step_graphs.stats["captures"]

    # ------------------------------------------------------------------
    def _runner(self) -> SG.StepGraphs:
        if self._step_graphs is None:
            self._step_graphs = SG.StepGraphs(self.device)
        return self._step_graphs

    def _graph_inputs(self, packed: np.ndarray):
        """(runner, values) of a graphed call: the IMU interval staged into
        its static buffer without a host sync, the state bound to the
        runner's buffers (copied there once after a bootstrap or ``load``)."""
        g = self._runner()
        m = self.cfg.estimator.imu.max_imu_per_frame
        v = {"packed": g.buffer("packed", (m + 1, 7), torch.float32)}
        with TM.span("stage", "imu", (m + 1) * 7 * 4):
            v["packed"].copy_(self._host_f32(packed), non_blocking=True)
        g.bind(v, "state", self.est_state)
        self.est_state = v["state"]
        return g, v

    def _graphed_step(self, packed: np.ndarray, start_ori, xyz=None, mask=None, ring=None,
                      pf: "PrefetchedCloud" = None, clouds=None) -> dict:
        """The consumed INITED sweep as one graph: the cloud (``pf``, or
        ``xyz``/``mask``/``ring``) and the front end inside it, or the
        odometry's (surf, corner) ``clouds`` bound as inputs. Returns the
        step's outputs, copied."""
        cfg, dtype = self.cfg, self.dtype
        g, v = self._graph_inputs(packed)

        def samples(v):
            return PI.unpack_samples(v["packed"].to(dtype))

        if clouds is not None:
            g.bind(v, "surf_cloud", clouds[0])
            g.bind(v, "corner_cloud", clouds[1])
            key = ("step", "odometry")

            def front(v):
                return v["surf_cloud"], v["corner_cloud"], samples(v), {}
        else:
            key = ("step",) + _stage_cloud(g, v, start_ori, dtype, xyz, mask, ring, pf)

            def front(v):
                feats = _front(g, v, dtype, cfg)
                corner = feats.corner_less_sharp if cfg.estimator.use_corner else None
                return feats.surf_less_flat, corner, samples(v), {
                    "corner_cloud": feats.corner_less_sharp,
                    "surf_cloud": feats.surf_less_flat}
        ex_prior = EST.extrinsic_prior(cfg)

        def program(v):
            state, out = EST.step_program(g, v, cfg, ex_prior, front=front)
            return {"state": state, "out": out}

        g.stretch(key, program, v)
        self.est_state = v["state"]
        # the next replay overwrites the graphs' buffers: hand out copies
        with TM.span("outputs"):
            return tree_map(torch.clone, v["out"])

    def _graphed_odometry(self, start_ori, push: bool, xyz=None, mask=None, ring=None,
                          pf: "PrefetchedCloud" = None):
        """The front end and the odometry of a sweep (the reference's
        ``front_odo``) as one graph, with (``push``) the init window's
        stacks of the frame: captured once per cloud bucket and ``push``,
        and replayed. The odometry's state stays in the runner's buffers.
        Returns (the odometry's pose and clouds, the stacks or None), each
        a copy that no later replay overwrites."""
        cfg, dtype = self.cfg, self.dtype
        g = self._runner()
        v = {}
        g.bind(v, "odom", self.odom_state)
        key = ("odometry", push) + _stage_cloud(g, v, start_ori, dtype, xyz, mask, ring, pf)

        def program(v):
            state, odo_out = ODO.odometry_program(
                g, v, cfg, front=lambda v: _front(g, v, dtype, cfg))
            out = {"odom": state, "odo_out": {k: odo_out[k] for k in
                                              ("pose", "corner_cloud", "surf_cloud")}}
            if push:
                out["stack"] = self._init_stack(odo_out)
            return out

        g.stretch(key, program, v)
        self.odom_state = v["odom"]
        with TM.span("outputs"):
            return (tree_map(torch.clone, v["odo_out"]),
                    tree_map(torch.clone, v["stack"]) if push else None)

    @staticmethod
    def _host_predict_pose(snap: dict, packed: np.ndarray) -> Pose:
        """Numpy mirror of the device predict (midpoint IMU propagation from
        the last consumed step's state, then the laser pose;
        Estimator.cc:387-394, :1391-1394). ``snap`` values are host arrays
        or CPU tensors. Returns a Pose of float32 numpy arrays."""
        from scipy.spatial.transform import Rotation

        q = np.asarray(snap["q"], np.float64)
        p = np.asarray(snap["p"], np.float64)
        v = np.asarray(snap["v"], np.float64)
        ba = np.asarray(snap["ba"], np.float64)
        bg = np.asarray(snap["bg"], np.float64)
        g = np.asarray(snap["g"], np.float64)
        q_lb = np.asarray(snap["ex_q"], np.float64)
        t_lb = np.asarray(snap["ex_p"], np.float64)

        rot = Rotation.from_quat(np.roll(q, -1))
        acc_prev = np.asarray(packed[0, 1:4], np.float64)
        gyr_prev = np.asarray(packed[0, 4:7], np.float64)
        for k in range(1, packed.shape[0]):
            dt = float(packed[k, 0])
            if dt == 0.0:
                continue
            acc = np.asarray(packed[k, 1:4], np.float64)
            gyr = np.asarray(packed[k, 4:7], np.float64)
            un_acc0 = rot.apply(acc_prev - ba) + g
            un_gyr = 0.5 * (gyr_prev + gyr) - bg
            rot_new = rot * Rotation.from_rotvec(un_gyr * dt)
            un_acc = 0.5 * (un_acc0 + (rot_new.apply(acc - ba) + g))
            p = p + dt * v + 0.5 * dt * dt * un_acc
            v = v + dt * un_acc
            rot = rot_new
            acc_prev, gyr_prev = acc, gyr

        # laser pose: R_l = R_b R_lb^-1, p_l = p_b - R_l t_lb
        rot_l = rot * Rotation.from_quat(np.roll(q_lb, -1)).inv()
        p_l = p - rot_l.apply(t_lb)
        return Pose(np.roll(rot_l.as_quat(), 1).astype(np.float32), p_l.astype(np.float32))

    def _update_snap(self, out: dict):
        """Start the copies of the consumed step's state to the host (pinned
        buffers, no block); an event marks when they have landed."""
        vals = {"q": out["body_pose"].q, "p": out["body_pose"].t, "v": out["velocity"],
                "ba": out["ba"], "bg": out["bg"], "ex_q": out["ex_q"], "ex_p": out["ex_p"],
                "g": self.est_state.g_vec}
        event = None
        if self.device.type == "cuda":
            host = {k: torch.empty(a.shape, dtype=a.dtype, pin_memory=True).copy_(
                a, non_blocking=True) for k, a in vals.items()}
            event = torch.cuda.Event()
            event.record()
        else:
            host = {k: a.detach().clone() for k, a in vals.items()}
        self._snap = (host, event)

    # ------------------------------------------------------------------
    def process(self, xyz, mask: Optional[np.ndarray], samples: Optional[np.ndarray],
                ring_ids: Optional[np.ndarray] = None) -> dict:
        """Process one sweep (+ its packed IMU interval). Returns pose outputs.

        ``xyz`` may be a :class:`PrefetchedCloud` (``mask`` is then None)."""
        tr = TM.TRACER
        if tr is None:
            return self._process(xyz, mask, samples, ring_ids)
        with tr.span("process", self._sweep_kind(), sweep=self.frame_count + 1, device=True):
            return self._process(xyz, mask, samples, ring_ids)

    def _sweep_kind(self) -> str:
        """What the next sweep will be: boot, consumed or skipped."""
        if self.stage != "INITED":
            return "boot"
        return "consumed" if self._is_compact(self.frame_count + 1) else "skipped"

    def _process(self, xyz, mask, samples, ring_ids) -> dict:
        cfg = self.cfg
        pf = None
        if isinstance(xyz, PrefetchedCloud):
            pf, xyz, mask = xyz, None, None
        else:
            _check_ring(self.cfg, ring_ids)
        start_ori = None
        if self._start_ori_tracker is not None:
            raw = pf.raw_ori if pf is not None else raw_start_ori(xyz, mask)
            start_ori = self._start_ori_tracker.update(raw)
        self.frame_count += 1
        if samples is not None:
            self._pending.append(np.asarray(samples, np.float32))
        is_compact = self._is_compact(self.frame_count)
        if is_compact:
            self._compact_count += 1

        def cloud():
            if pf is not None:
                return pf.xyzw
            return self._commit_cloud(xyz, mask, ring_ids, non_blocking=True)

        deskew_mode = cfg.estimator.enable_deskew or cfg.estimator.cutoff_deskew
        if self.stage == "INITED" and deskew_mode:
            merged = self._merge_pending()
            if not is_compact:
                # skipped sweep: its cloud is never used
                if self.host_predict and self._snap is not None:
                    host, event = self._snap
                    if event is not None:
                        event.synchronize()
                    lp = self._host_predict_pose(host, merged)
                else:
                    lp = self._predict(merged)
                return {"stage": self.stage, "laser_pose": lp, "predicted": True}
            self._pending = []
            if self.graphs:
                out = self._graphed_step(merged, start_ori, xyz, mask, ring_ids, pf)
            else:
                feats = _feats_from_xyzw(cloud(), start_ori, cfg)
                corner = feats.corner_less_sharp if cfg.estimator.use_corner else None
                self.est_state, out = EST.lio_step_impl(
                    self.est_state, feats.surf_less_flat, self._samples(merged), cfg, corner,
                    axis=self.mesh, map_shard=self.map_shard)
                out["corner_cloud"] = feats.corner_less_sharp
                out["surf_cloud"] = feats.surf_less_flat
            if self.host_predict:
                self._update_snap(out)
            out["stage"] = self.stage
            return out

        # NOT_INITED: every init_window_factor-th COMPACT frame is pushed
        push = (self.stage == "NOT_INITED" and samples is not None and is_compact
                and self._compact_count % cfg.estimator.init_window_factor == 0)
        if self.graphs:
            odo_out, stack = self._graphed_odometry(start_ori, push, xyz, mask, ring_ids, pf)
        else:
            feats = _feats_from_xyzw(cloud(), start_ori, cfg)
            self.odom_state, odo_out = ODO.odometry_step(self.odom_state, feats, cfg)
            stack = self._init_stack(odo_out) if push else None

        if self.stage == "NOT_INITED":
            if push:
                merged = self._merge_pending()
                self._pending = []
                self._init_odom_poses.append(odo_out["pose"])
                self._init_samples.append(np.asarray(merged, np.float32))
                self._init_stacks.append(stack)
                if len(self._init_odom_poses) == cfg.estimator.window_size + 1:
                    with TM.span("init"):
                        inited = self._try_initialize()
                    if inited:
                        self.stage = "INITED"
                    else:
                        self._init_odom_poses.pop(0)
                        self._init_samples.pop(0)
                        self._init_stacks.pop(0)
            return {"stage": self.stage, "laser_pose": odo_out["pose"],
                    "corner_cloud": odo_out["corner_cloud"],
                    "surf_cloud": odo_out["surf_cloud"]}

        # INITED without deskew: clouds come from the odometry
        if not is_compact:
            return {"stage": self.stage, "laser_pose": odo_out["pose"], "predicted": True,
                    "corner_cloud": odo_out["corner_cloud"],
                    "surf_cloud": odo_out["surf_cloud"]}
        merged = self._merge_pending()
        self._pending = []
        corner = odo_out["corner_cloud"] if cfg.estimator.use_corner else None
        if self.graphs:
            out = self._graphed_step(merged, None, clouds=(odo_out["surf_cloud"], corner))
        else:
            self.est_state, out = EST.lio_step_impl(
                self.est_state, odo_out["surf_cloud"], self._samples(merged), cfg, corner,
                axis=self.mesh, map_shard=self.map_shard)
        out["stage"] = self.stage
        out["corner_cloud"] = odo_out["corner_cloud"]
        out["surf_cloud"] = odo_out["surf_cloud"]
        return out

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Serialize the state to an npz checkpoint (the reference's layout);
        under a mesh rank 0 alone writes it (every rank holds the same
        state)."""
        from ..io import checkpoint as CKPT

        if self.mesh is not None and self.mesh.rank != 0:
            return
        meta = np.asarray([1 if self.stage == "INITED" else 0, self.frame_count,
                           self._compact_count], np.int32)
        CKPT.save_state(path, est=self.est_state, odom=self.odom_state,
                        meta=[meta], pending=[self._merge_pending()])

    def load(self, path: str):
        """Resume from a checkpoint written by this class's or the
        reference's ``save`` (under a mesh every rank reads it)."""
        from ..io import checkpoint as CKPT

        loaded = CKPT.load_state(path, est=self.est_state, odom=self.odom_state)
        self.est_state = loaded["est"]
        self.odom_state = loaded["odom"]
        with np.load(path, allow_pickle=False) as raw:
            inited, count, compact = raw["meta.0"]
            pending = np.asarray(raw["pending.0"], np.float32)
        self.stage = "INITED" if int(inited) else "NOT_INITED"
        self.frame_count = int(count)
        self._compact_count = int(compact)
        self._snap = None  # resumed: the device predict runs until the next consumed step
        self._pending = [pending] if (pending[1:, 0] > 0).any() else []

    # ------------------------------------------------------------------
    def _init_stack(self, odo_out) -> tuple:
        """A pushed frame's stacks for the init window: the surf (and with
        ``use_corner`` the corner) cloud voxel-downsampled, else zeros."""
        e = self.cfg.estimator
        surf: Cloud = odo_out["surf_cloud"]
        ds_xyz, ds_mask, _ = VX.voxel_downsample(surf.xyz, surf.mask, e.surf_filter_size,
                                                 e.surf_stack_cap)
        if e.use_corner:
            corner: Cloud = odo_out["corner_cloud"]
            dc_xyz, dc_mask, _ = VX.voxel_downsample(corner.xyz, corner.mask,
                                                     e.corner_filter_size, e.corner_stack_cap)
        else:
            dc_xyz = torch.zeros((e.corner_state_cap, 3), dtype=self.dtype, device=self.device)
            dc_mask = torch.zeros((e.corner_state_cap,), dtype=torch.bool, device=self.device)
        return ds_xyz, ds_mask, dc_xyz, dc_mask

    def _try_initialize(self) -> bool:
        """EstimateExtrinsicRotation + ImuInitializer + state alignment, on
        the host in float64."""
        cfg = self.cfg
        e = cfg.estimator
        w = e.window_size
        dtype, dev = self.dtype, self.device
        f64 = torch.float64
        noise = PI.noise_matrix(e.imu.acc_n, e.imu.gyr_n, e.imu.acc_w, e.imu.gyr_w, f64)
        zeros3 = torch.zeros(3, dtype=f64)
        host_samples = [PI.unpack_samples(torch.as_tensor(s).to(f64))
                        for s in self._init_samples]

        pres = [PI.Preintegration.identity(f64)]
        for i in range(1, w + 1):
            pres.append(PI.integrate(host_samples[i], zeros3, zeros3, noise))

        # the window's poses in one copy to the host, the extrinsic in another
        poses = torch.stack([torch.cat([p.q, p.t]) for p in self._init_odom_poses])
        poses = poses.detach().to("cpu", f64).numpy()
        laser_q = np.ascontiguousarray(poses[:, :4])
        laser_p = np.ascontiguousarray(poses[:, 4:])
        imu_dq = np.stack([pres[i].delta_q.numpy() for i in range(1, w + 1)])
        ex = torch.cat([self.est_state.q_lb, self.est_state.t_lb]).to("cpu", f64).numpy()
        q_lb, t_lb = ex[:4].copy(), ex[4:].copy()

        if e.estimate_extrinsic == 2:
            q_lb_new, ok = INIT.estimate_extrinsic_rotation(laser_q, imu_dq, q_lb)
            if not ok:
                return False
            q_lb = q_lb_new

        delta_vs = np.stack([pres[i].delta_v.numpy() for i in range(1, w + 1)])
        sum_dts = np.array([float(pres[i].sum_dt) for i in range(1, w + 1)])
        if not INIT.check_imu_observibility(delta_vs, sum_dts):
            return False

        jacs = [pres[i].jacobian.numpy() for i in range(1, w + 1)]
        dqs = [pres[i].delta_q.numpy() for i in range(1, w + 1)]
        dbg = INIT.estimate_gyro_bias(laser_q, jacs, dqs)
        # physical-sanity gate of the reference port: a MEMS gyro bias is
        # < 0.02 rad/s; far above it means corrupt laser rotations
        if np.linalg.norm(dbg) > 0.2:
            return False
        bg = torch.as_tensor(dbg, dtype=f64)
        for i in range(1, w + 1):
            pres[i] = PI.integrate(host_samples[i], zeros3, bg, noise)

        delta_ps = np.stack([pres[i].delta_p.numpy() for i in range(1, w + 1)])
        delta_vs = np.stack([pres[i].delta_v.numpy() for i in range(1, w + 1)])
        g_approx, ok = INIT.approximate_gravity(laser_p, laser_q, q_lb, t_lb, sum_dts,
                                                delta_ps, delta_vs, e.imu.g_norm)
        if not ok:
            return False
        vels, g_refined, r_wi = INIT.refine_gravity_acc_bias(
            laser_p, laser_q, q_lb, t_lb, sum_dts, delta_ps, delta_vs, g_approx, e.imu.g_norm)

        # state alignment (Estimator.cc:905-947): T_bi = T_li * T_lb
        t_lb_pose = Pose(torch.as_tensor(q_lb), torch.as_tensor(t_lb))
        qs_b, ps_b = [], []
        for i in range(w + 1):
            t_bi = Pose(torch.as_tensor(laser_q[i]), torch.as_tensor(laser_p[i])) @ t_lb_pose
            qs_b.append(quat.normalize(t_bi.q).numpy())
            ps_b.append(t_bi.t.numpy())
        qs_b = np.stack(qs_b)
        ps_b = np.stack(ps_b)

        # yaw-zeroed alignment rotation R0
        r0 = r_wi.T
        rs0 = quat.to_matrix(torch.as_tensor(qs_b[0])).numpy()
        yaw = float(quat.rot_to_ypr(torch.as_tensor(r0 @ rs0))[0])
        r0 = quat.ypr_to_rot(torch.tensor([-yaw, 0.0, 0.0], dtype=f64)).numpy() @ r0
        g_vec = r0 @ g_refined
        q_diff = quat.from_matrix(torch.as_tensor(r0))
        qs_new = np.stack([quat.normalize(quat.qmul(q_diff, torch.as_tensor(q))).numpy()
                           for q in qs_b])
        ps_new = (r0 @ ps_b.T).T
        vs_new = (r0 @ vels.T).T

        def dev_t(x):
            # row-major, as the step writes the state back (the graphed
            # step's state buffers keep one layout)
            return torch.as_tensor(np.ascontiguousarray(x)).to(dev, dtype)

        samples_all = tree_stack([self._samples(s) for s in self._init_samples])
        pres_dev = tree_map(lambda a: a.to(dev, dtype), tree_stack(pres))
        self.est_state = self.est_state._replace(
            qs=dev_t(qs_new), ps=dev_t(ps_new), qs_lin=dev_t(qs_new), ps_lin=dev_t(ps_new),
            corner_xyz=torch.stack([s[2] for s in self._init_stacks]),
            corner_mask=torch.stack([s[3] for s in self._init_stacks]),
            vs=dev_t(vs_new),
            bas=torch.zeros((w + 1, 3), dtype=dtype, device=dev),
            bgs=dev_t(dbg).expand(w + 1, 3).clone(),
            pres=pres_dev,
            imu=samples_all,
            surf_xyz=torch.stack([s[0] for s in self._init_stacks]),
            surf_mask=torch.stack([s[1] for s in self._init_stacks]),
            g_vec=dev_t(g_vec), q_lb=dev_t(q_lb), t_lb=dev_t(t_lb),
        )
        return True


class LoamPipeline:
    """LiDAR-only LOAM baseline: front end -> odometry -> scan-to-map.

    The reference's baseline graph (launch/16_scans_test.launch:7-9, no
    IMU). The scan-to-map refinement runs every ``odometry.io_ratio``-th
    sweep; in between, the published pose chains the scan-to-scan increment
    onto the last mapped pose (TransformAssociateToMap,
    PointMapping.cc:755-758).

    ``graphs`` as in :class:`LioPipeline`: on a CUDA device (the default
    there) a sweep is one CUDA graph, the reference's two programs
    (``front_map``: front end, odometry, scan-to-map GN and map insert;
    ``front_assoc``: front end, odometry and the chain), each captured once
    per cloud bucket; the odometry's and the map's states live in the
    runner's static buffers, the GNs' exits are conditional nodes, and the
    sweep reads nothing back. ``False`` runs the same programs eagerly."""

    def __init__(self, cfg: LioConfig, device=None, dtype=torch.float32, graphs: bool = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        TM.from_env(self.device)
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError("graphs=True needs a CUDA device")
        self.graphs = on_card if graphs is None else bool(graphs)
        self._step_graphs = None  # made at first use
        self.odom_state = ODO.init_state(cfg, dtype, self.device)
        self.map_state = MAP.init_state(cfg, dtype, self.device)
        self.frame_count = 0
        self._start_ori_tracker = (StartOriTracker(cfg.sensor.rad_diff)
                                   if cfg.sensor.infer_start_ori else None)

    def process(self, xyz: np.ndarray, mask: np.ndarray,
                ring_ids: Optional[np.ndarray] = None) -> dict:
        tr = TM.TRACER
        if tr is None:
            return self._process(xyz, mask, ring_ids)
        with tr.span("process", "loam", sweep=self.frame_count + 1, device=True):
            return self._process(xyz, mask, ring_ids)

    def _process(self, xyz, mask, ring_ids) -> dict:
        cfg = self.cfg
        _check_ring(cfg, ring_ids)
        start_ori = None
        if self._start_ori_tracker is not None:
            start_ori = self._start_ori_tracker.update(raw_start_ori(xyz, mask))
        self.frame_count += 1
        mapped = self.frame_count % cfg.odometry.io_ratio == 0
        if self.graphs:
            return self._graphed(mapped, start_ori, xyz, mask, ring_ids)

        with TM.span("stage", "cloud", len(xyz) * (4 if ring_ids is None else 5) * 4):
            xyzw = _upload_cloud(xyz, mask, ring_ids, self.device, self.dtype)
        feats = _feats_from_xyzw(xyzw, start_ori, cfg)
        self.odom_state, odo_out = ODO.odometry_step(self.odom_state, feats, cfg)
        if mapped:
            self.map_state, m_out = MAP.mapping_step(
                self.map_state, odo_out["corner_cloud"], odo_out["surf_cloud"],
                odo_out["pose"], cfg)
            pose = m_out["pose"]
        else:
            pose = MAP.associate_to_map(self.map_state, odo_out["pose"])
        return {"stage": "LOAM", "laser_pose": pose, "odom_pose": odo_out["pose"]}

    def _graphed(self, mapped: bool, start_ori, xyz, mask, ring) -> dict:
        """One sweep as the graph of ``front_map`` (``mapped``) or
        ``front_assoc``; returns copies of its poses."""
        cfg, dtype = self.cfg, self.dtype
        if self._step_graphs is None:
            self._step_graphs = SG.StepGraphs(self.device)
        g = self._step_graphs
        v = {}
        g.bind(v, "odom", self.odom_state)
        g.bind(v, "map", self.map_state)
        key = ("loam_map" if mapped else "loam_assoc",) + _stage_cloud(
            g, v, start_ori, dtype, xyz, mask, ring)

        def program(v):
            odom, odo_out = ODO.odometry_program(g, v, cfg,
                                                 front=lambda v: _front(g, v, dtype, cfg))
            out = {"odom": odom, "odom_pose": odo_out["pose"]}
            if mapped:
                v.update(corner_cloud=odo_out["corner_cloud"], surf_cloud=odo_out["surf_cloud"],
                         odom_pose=odo_out["pose"])
                out["map"], m_out = MAP.mapping_program(g, v, cfg)
                out["pose"] = m_out["pose"]
            else:
                out["pose"] = MAP.associate_to_map(v["map"], odo_out["pose"])
            return out

        g.stretch(key, program, v)
        self.odom_state, self.map_state = v["odom"], v["map"]
        with TM.span("outputs"):
            return {"stage": "LOAM", "laser_pose": tree_map(torch.clone, v["pose"]),
                    "odom_pose": tree_map(torch.clone, v["odom_pose"])}

    def graph_captures(self) -> int:
        """CUDA graphs captured so far (0 on the eager path)."""
        return 0 if self._step_graphs is None else self._step_graphs.stats["captures"]

    def save(self, path: str):
        """The reference's npz layout (``odom``, ``map``, ``meta``); the
        states' current values, wherever they live."""
        from ..io import checkpoint as CKPT

        CKPT.save_state(path, odom=self.odom_state, map=self.map_state,
                        meta=[np.asarray([self.frame_count], np.int32)])

    def load(self, path: str):
        """Resume from a checkpoint; a graphed sweep copies the states into
        its buffers."""
        from ..io import checkpoint as CKPT

        loaded = CKPT.load_state(path, odom=self.odom_state, map=self.map_state)
        self.odom_state = loaded["odom"]
        self.map_state = loaded["map"]
        with np.load(path, allow_pickle=False) as raw:
            self.frame_count = int(raw["meta.0"][0])
