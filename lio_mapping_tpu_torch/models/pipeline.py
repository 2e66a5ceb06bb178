"""Full LIO pipeline orchestration, lio mode on one device
(port of lio_mapping_tpu.models.pipeline.LioPipeline).

    raw sweep --process_sweep--> features --odometry_step--> laser odom
        --(NOT_INITED: fill window, initializer)--> INITED
        --lio_step--> tightly-coupled window odometry

The estimator consumes every ``odom_io``-th sweep; skipped sweeps get the
IMU-predicted pose. Bootstrap (``_try_initialize``) runs on the host in
float64 numpy and moves its results to the device explicitly.

Not ported: cloud prefetch, host-side prediction and the device mesh;
``LoamPipeline`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import LioConfig
from ..ops import preintegration as PI
from ..ops import voxel as VX
from ..ops.cloud import Cloud
from ..utils import quaternion as quat
from ..utils.se3 import Pose
from ..utils.tree import tree_map, tree_stack
from . import estimator as EST
from . import initializer as INIT
from . import odometry as ODO
from .point_processor import StartOriTracker, process_sweep, raw_start_ori


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class LioPipeline:
    """Sweep-by-sweep LIO: feed (sweep, imu batch) pairs, get poses out."""

    def __init__(self, cfg: LioConfig, device=None, dtype=torch.float32):
        EST.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
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

    def _samples(self, packed: np.ndarray) -> PI.ImuSamples:
        t = torch.as_tensor(np.asarray(packed, np.float32)).to(self.device, self.dtype)
        return PI.unpack_samples(t)

    def _is_compact(self, frame_count: int) -> bool:
        io = self._io_ratio
        return io < 2 or (frame_count % io == 1)

    def _features(self, xyz, mask, start_ori, ring_ids):
        pts = torch.as_tensor(np.asarray(xyz, np.float32)[:, 0:3]).to(self.device, self.dtype)
        msk = torch.as_tensor(np.asarray(mask, bool)).to(self.device)
        so = None if start_ori is None else torch.tensor(start_ori, dtype=self.dtype,
                                                         device=self.device)
        rings = None
        if self.cfg.sensor.uneven:
            if ring_ids is None:
                raise ValueError("config has sensor.uneven=True but no per-point ring IDs "
                                 "were supplied")
            rings = torch.as_tensor(np.asarray(ring_ids, np.int32)).to(self.device)
        return process_sweep(pts, msk, self.cfg, so, rings)

    def _predict(self, packed: np.ndarray) -> Pose:
        """IMU-predicted laser pose for a skipped sweep (the reference's
        /predict_laser_odom, Estimator.cc:744-758), mean-only."""
        st = self.est_state
        w = self.cfg.estimator.window_size
        pre = PI.integrate_mean(self._samples(packed), st.bas[w], st.bgs[w])
        q, p, _ = PI.apply_deltas(pre, st.qs[w], st.ps[w], st.vs[w], st.g_vec)
        return EST.laser_pose(q, p, st.q_lb, st.t_lb)

    # ------------------------------------------------------------------
    def process(self, xyz: np.ndarray, mask: np.ndarray, samples: Optional[np.ndarray],
                ring_ids: Optional[np.ndarray] = None) -> dict:
        """Process one sweep (+ its packed IMU interval). Returns pose outputs."""
        cfg = self.cfg
        start_ori = None
        if self._start_ori_tracker is not None:
            start_ori = self._start_ori_tracker.update(raw_start_ori(xyz, mask))
        self.frame_count += 1
        if samples is not None:
            self._pending.append(np.asarray(samples, np.float32))
        is_compact = self._is_compact(self.frame_count)
        if is_compact:
            self._compact_count += 1

        deskew_mode = cfg.estimator.enable_deskew or cfg.estimator.cutoff_deskew
        if self.stage == "INITED" and deskew_mode:
            merged = self._merge_pending()
            if not is_compact:
                return {"stage": self.stage, "laser_pose": self._predict(merged),
                        "predicted": True}
            self._pending = []
            feats = self._features(xyz, mask, start_ori, ring_ids)
            self.est_state, out = EST.lio_step_impl(
                self.est_state, feats.surf_less_flat, self._samples(merged), cfg)
            out["corner_cloud"] = feats.corner_less_sharp
            out["surf_cloud"] = feats.surf_less_flat
            out["stage"] = self.stage
            return out

        feats = self._features(xyz, mask, start_ori, ring_ids)
        self.odom_state, odo_out = ODO.odometry_step(self.odom_state, feats, cfg)

        if self.stage == "NOT_INITED":
            # every init_window_factor-th COMPACT frame is pushed
            if (samples is not None and is_compact
                    and self._compact_count % cfg.estimator.init_window_factor == 0):
                merged = self._merge_pending()
                self._pending = []
                self._push_init_frame(odo_out, merged)
                if len(self._init_odom_poses) == cfg.estimator.window_size + 1:
                    if self._try_initialize():
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
        self.est_state, out = EST.lio_step_impl(
            self.est_state, odo_out["surf_cloud"], self._samples(merged), cfg)
        out["stage"] = self.stage
        out["corner_cloud"] = odo_out["corner_cloud"]
        out["surf_cloud"] = odo_out["surf_cloud"]
        return out

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Serialize the state to an npz checkpoint (the reference's layout)."""
        from ..io import checkpoint as CKPT

        meta = np.asarray([1 if self.stage == "INITED" else 0, self.frame_count,
                           self._compact_count], np.int32)
        CKPT.save_state(path, est=self.est_state, odom=self.odom_state,
                        meta=[meta], pending=[self._merge_pending()])

    def load(self, path: str):
        """Resume from a checkpoint written by this class's or the
        reference's ``save``."""
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
        self._pending = [pending] if (pending[1:, 0] > 0).any() else []

    # ------------------------------------------------------------------
    def _push_init_frame(self, odo_out, packed: np.ndarray):
        e = self.cfg.estimator
        self._init_odom_poses.append(odo_out["pose"])
        self._init_samples.append(np.asarray(packed, np.float32))
        surf: Cloud = odo_out["surf_cloud"]
        ds_xyz, ds_mask, _ = VX.voxel_downsample(surf.xyz, surf.mask, e.surf_filter_size,
                                                 e.surf_stack_cap)
        dc_xyz = torch.zeros((e.corner_state_cap, 3), dtype=self.dtype, device=self.device)
        dc_mask = torch.zeros((e.corner_state_cap,), dtype=torch.bool, device=self.device)
        self._init_stacks.append((ds_xyz, ds_mask, dc_xyz, dc_mask))

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

        laser_q = np.stack([p.q.detach().to("cpu", f64).numpy() for p in self._init_odom_poses])
        laser_p = np.stack([p.t.detach().to("cpu", f64).numpy() for p in self._init_odom_poses])
        imu_dq = np.stack([pres[i].delta_q.numpy() for i in range(1, w + 1)])
        q_lb = self.est_state.q_lb.to("cpu", f64).numpy()
        t_lb = self.est_state.t_lb.to("cpu", f64).numpy()

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
            return torch.as_tensor(np.asarray(x)).to(dev, dtype)

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
    """The LiDAR-only LOAM baseline (reference ``LoamPipeline``): not ported
    yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("LoamPipeline (the LOAM baseline) is not ported yet")
