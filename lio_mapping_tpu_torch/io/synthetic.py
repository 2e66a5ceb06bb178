"""Synthetic LiDAR + IMU data generation (host-side, numpy; copy of
lio_mapping_tpu.io.synthetic with ``synthetic_estimator_state`` rebuilt on
this package).

The reference tests the optimizer against a simulated IMU trajectory with
ground truth (test/test_imu_processor/test_imu_factor.cc + LoadVirtual.h).
We extend that pattern to full closed-loop testing: an analytic indoor world
(box room + pillars) is ray-cast from a continuously moving sensor to produce
Velodyne-like sweeps with per-point timestamps (motion skew included), and an
analytically consistent IMU stream is derived from the same trajectory.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


# ---------------------------------------------------------------------------
# World model
# ---------------------------------------------------------------------------


@dataclass
class BoxRoom:
    """Axis-aligned room interior [xmin,xmax]x[ymin,ymax]x[zmin,zmax]."""

    bounds: np.ndarray  # (2, 3): row 0 = min, row 1 = max

    def ray_hit(self, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        """Distance to the room shell from inside, per ray. dirs: (N,3)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            t_min = (self.bounds[0] - origin) / dirs  # (N,3)
            t_max = (self.bounds[1] - origin) / dirs
        t_far = np.maximum(t_min, t_max)  # exit distance per axis
        t_far[~np.isfinite(t_far)] = np.inf
        return np.min(t_far, axis=-1)


@dataclass
class Box:
    """Axis-aligned solid obstacle (pillar/furniture)."""

    bounds: np.ndarray  # (2, 3)

    def ray_hit(self, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (self.bounds[0] - origin) / dirs
            t1 = (self.bounds[1] - origin) / dirs
        t_near = np.nanmax(np.minimum(t0, t1), axis=-1)
        t_far = np.nanmin(np.maximum(t0, t1), axis=-1)
        hit = (t_near <= t_far) & (t_far > 0) & (t_near > 0)
        return np.where(hit, t_near, np.inf)


def default_world() -> Tuple[BoxRoom, List[Box]]:
    """A hall-sized indoor scene: large enough that mid-wall planar area
    dominates over corner regions (where 5-NN plane fits mix two walls)."""
    room = BoxRoom(np.array([[-11.0, -8.0, -1.5], [12.0, 9.0, 4.5]]))
    pillars = [
        Box(np.array([[2.0, -1.5, -1.5], [2.6, -0.9, 4.5]])),
        Box(np.array([[-3.0, 1.0, -1.5], [-2.2, 1.8, 4.5]])),
        Box(np.array([[6.5, 4.0, -1.5], [7.3, 4.8, 1.5]])),
        Box(np.array([[-6.5, -5.5, -1.5], [-5.9, -4.9, 2.0]])),
        Box(np.array([[8.0, -5.0, -1.5], [9.2, -3.8, 0.5]])),
        Box(np.array([[-8.0, 5.0, -1.5], [-6.8, 6.2, 1.0]])),
        Box(np.array([[0.5, 6.0, -1.5], [1.7, 7.2, 2.5]])),
    ]
    return room, pillars


def corridor_world(length: float = 300.0, width: float = 4.0,
                   height: float = 3.0,
                   fixture_every: float = 5.0) -> Tuple[BoxRoom, List[Box]]:
    """Feature-degenerate corridor: two parallel walls + floor/ceiling,
    end walls far beyond sensor range. The infinite planes observe only
    y/z/roll/pitch — translation ALONG the corridor (x) AND yaw slide
    freely; sparse shallow wall fixtures (doorframe-scale boxes every
    ``fixture_every`` m) give the feature extractor a weak handle on x/yaw
    the way real corridors do, so the system is degenerate-dominated but
    not pathological: the degeneracy projection
    (PointOdometry.cc:584-615) and the IMU factor carry the weak
    directions."""
    room = BoxRoom(np.array([[-length / 2, -width / 2, -1.2],
                             [length / 2, width / 2, height - 1.2]]))
    fixtures = []
    rng = np.random.default_rng(11)
    for x in np.arange(-length / 2 + 10, length / 2 - 10, fixture_every):
        side = 1.0 if (int(x) % 2 == 0) else -1.0
        y0 = side * (width / 2 - 0.25)
        z0 = float(rng.uniform(-0.9, 0.6))
        fixtures.append(Box(np.array([
            [x, min(y0, y0 + side * -0.2), z0],
            [x + 0.35, max(y0, y0 + side * -0.2), z0 + 0.9]])))
    return room, fixtures


def outdoor_loop_world(extent: float = 220.0) -> Tuple[BoxRoom, List[Box]]:
    """Outdoor-scale scene for a >200 m loop: a large ground 'room' (its
    ceiling far above sensor range) populated with building-sized boxes
    around the loop corridor so every sweep sees structure."""
    room = BoxRoom(np.array([[-extent, -extent, -2.0],
                             [extent, extent, 60.0]]))
    rng = np.random.default_rng(5)
    buildings = []
    # ring of buildings inside and outside a ~35 m radius loop
    for radius, n in ((22.0, 7), (52.0, 12)):
        for i in range(n):
            ang = 2 * np.pi * i / n + rng.uniform(-0.12, 0.12)
            cx, cy = radius * np.cos(ang), radius * np.sin(ang)
            w = rng.uniform(3.0, 8.0)
            d = rng.uniform(3.0, 8.0)
            h = rng.uniform(4.0, 14.0)
            buildings.append(Box(np.array(
                [[cx - w / 2, cy - d / 2, -2.0],
                 [cx + w / 2, cy + d / 2, -2.0 + h]])))
    return room, buildings


def cast_rays(origin: np.ndarray, dirs: np.ndarray, room: BoxRoom, obstacles: List[Box]) -> np.ndarray:
    t = room.ray_hit(origin, dirs)
    for ob in obstacles:
        t = np.minimum(t, ob.ray_hit(origin, dirs))
    return t


# ---------------------------------------------------------------------------
# Trajectory
# ---------------------------------------------------------------------------


@dataclass
class Trajectory:
    """Analytic trajectory: t -> (R_wb, p_w, v_w, a_w, omega_b).

    Sinusoidal translation + yaw wobble, twice differentiable so IMU
    measurements are exact.
    """

    pos_amp: np.ndarray = dataclasses.field(default_factory=lambda: np.array([1.5, 1.0, 0.15]))
    pos_freq: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.25, 0.2, 0.5]))
    yaw_amp: float = 0.6
    yaw_freq: float = 0.15
    pitch_amp: float = 0.06
    roll_amp: float = 0.05
    rp_freq: float = 0.3
    g_norm: float = 9.805

    def pose(self, t: float):
        w = 2.0 * np.pi * self.pos_freq
        p = self.pos_amp * np.sin(w * t)
        v = self.pos_amp * w * np.cos(w * t)
        a = -self.pos_amp * w * w * np.sin(w * t)

        wy = 2.0 * np.pi * self.yaw_freq
        wr = 2.0 * np.pi * self.rp_freq
        yaw = self.yaw_amp * np.sin(wy * t)
        pitch = self.pitch_amp * np.sin(wr * t)
        roll = self.roll_amp * np.cos(wr * t)
        rot = Rotation.from_euler("ZYX", [yaw, pitch, roll])

        # analytic body rates from euler rates (ZYX convention)
        dyaw = self.yaw_amp * wy * np.cos(wy * t)
        dpitch = self.pitch_amp * wr * np.cos(wr * t)
        droll = -self.roll_amp * wr * np.sin(wr * t)
        sy, cy = np.sin(yaw), np.cos(yaw)
        sp, cp = np.sin(pitch), np.cos(pitch)
        sr, cr = np.sin(roll), np.cos(roll)
        # omega in body frame for ZYX euler rates
        omega_b = np.array(
            [
                droll - dyaw * sp,
                dpitch * cr + dyaw * cp * sr,
                -dpitch * sr + dyaw * cp * cr,
            ]
        )
        return rot, p, v, a, omega_b

    def imu(self, t: float):
        """Ideal IMU: body acc (incl. gravity reaction) + body rates."""
        rot, p, v, a, omega_b = self.pose(t)
        g_w = np.array([0.0, 0.0, -self.g_norm])
        acc_b = rot.inv().apply(a - g_w)
        return acc_b, omega_b


@dataclasses.dataclass
class LineTrajectory(Trajectory):
    """Forward motion (+x) with the sinusoidal wobble of
    :class:`Trajectory` on top — drives the corridor scene where
    along-track translation is LiDAR-unobservable.

    ``ramp_t0``/``ramp_tau``: smooth softplus speed ramp — near-stationary
    before ``ramp_t0``, cruising at ``forward_speed`` after. A realistic
    corridor run initializes before moving fast: while x is unobservable
    the scan-to-scan stage cannot deskew the along-track motion, and the
    residual skew masquerades as yaw, poisoning the gyro-bias init (the
    reference's bootstrap has the identical failure mode)."""

    forward_speed: float = 1.5
    ramp_t0: float = 0.0
    ramp_tau: float = 0.0

    def _forward(self, t: float):
        s = self.forward_speed
        if self.ramp_tau <= 0.0:
            return s * t, s, 0.0
        u = (t - self.ramp_t0) / self.ramp_tau
        # softplus position ramp: x = s*tau*log(1+e^u), analytic v/a
        x = s * self.ramp_tau * np.logaddexp(0.0, u)
        sig = 1.0 / (1.0 + np.exp(-u))
        return x, s * sig, s * sig * (1.0 - sig) / self.ramp_tau

    def pose(self, t: float):
        rot, p, v, a, omega_b = super().pose(t)
        x, vx, ax = self._forward(t)
        p = p + np.array([x, 0.0, 0.0])
        v = v + np.array([vx, 0.0, 0.0])
        a = a + np.array([ax, 0.0, 0.0])
        return rot, p, v, a, omega_b


class CircleTrajectory:
    """Analytic loop trajectory: constant-speed circle of radius R with
    yaw tracking the tangent, plus pitch/roll wobble — a >=2*pi*R loop
    with exact IMU. Same interface as :class:`Trajectory` (pose / imu).

    The wobble matters: on a wobble-free circle the BODY-frame
    acceleration (centripetal + gravity reaction) is constant, so the
    reference's IMU-excitation variance gate (Estimator.cc:886-893)
    correctly refuses to initialize."""

    def __init__(self, radius: float = 35.0, speed: float = 8.0,
                 g_norm: float = 9.805, z_amp: float = 0.3,
                 z_freq: float = 0.15, pitch_amp: float = 0.06,
                 roll_amp: float = 0.05, rp_freq: float = 0.45):
        self.r = radius
        self.w = speed / radius  # angular rate
        self.g_norm = g_norm
        self.z_amp = z_amp
        self.z_freq = z_freq
        self.pitch_amp = pitch_amp
        self.roll_amp = roll_amp
        self.rp_freq = rp_freq

    def pose(self, t: float):
        r, w = self.r, self.w
        th = w * t
        wz = 2 * np.pi * self.z_freq
        p = np.array([r * np.cos(th), r * np.sin(th),
                      self.z_amp * np.sin(wz * t)])
        v = np.array([-r * w * np.sin(th), r * w * np.cos(th),
                      self.z_amp * wz * np.cos(wz * t)])
        a = np.array([-r * w * w * np.cos(th), -r * w * w * np.sin(th),
                      -self.z_amp * wz * wz * np.sin(wz * t)])
        wr = 2 * np.pi * self.rp_freq
        yaw = th + np.pi / 2  # facing along the tangent
        pitch = self.pitch_amp * np.sin(wr * t)
        roll = self.roll_amp * np.cos(wr * t)
        rot = Rotation.from_euler("ZYX", [yaw, pitch, roll])
        # body rates from ZYX euler rates (same formula as Trajectory)
        dyaw = w
        dpitch = self.pitch_amp * wr * np.cos(wr * t)
        droll = -self.roll_amp * wr * np.sin(wr * t)
        sp, cp = np.sin(pitch), np.cos(pitch)
        sr, cr = np.sin(roll), np.cos(roll)
        omega_b = np.array([
            droll - dyaw * sp,
            dpitch * cr + dyaw * cp * sr,
            -dpitch * sr + dyaw * cp * cr,
        ])
        return rot, p, v, a, omega_b

    def imu(self, t: float):
        rot, p, v, a, omega_b = self.pose(t)
        g_w = np.array([0.0, 0.0, -self.g_norm])
        acc_b = rot.inv().apply(a - g_w)
        return acc_b, omega_b

    @property
    def loop_time(self) -> float:
        return 2 * np.pi / self.w

    @property
    def loop_length(self) -> float:
        return 2 * np.pi * self.r



# ---------------------------------------------------------------------------
# LiDAR simulation
# ---------------------------------------------------------------------------


def simulate_sweep(
    traj: Trajectory,
    t0: float,
    *,
    n_rings: int = 16,
    lower_deg: float = -15.0,
    upper_deg: float = 15.0,
    n_azimuth: int = 720,
    scan_period: float = 0.1,
    room: BoxRoom | None = None,
    obstacles: List[Box] | None = None,
    max_range: float = 80.0,
    noise_std: float = 0.0,
    rng: np.random.Generator | None = None,
    extrinsic_lb: Tuple[np.ndarray, np.ndarray] | None = None,
):
    """Simulate one sweep starting at time t0.

    Returns (xyz (N,3) float32 in the sensor frame at t0**, mask, t_gt):
    ** points are expressed in the LiDAR frame at each firing time — i.e.,
    motion-skewed, exactly like a real spinning LiDAR. Output order is
    firing-major (all rings per azimuth step), matching Velodyne packets.

    ``extrinsic_lb``: optional (q_lb wxyz, t_lb) laser->body transform; the
    trajectory is the BODY trajectory, the sensor rides at T_wl = T_wb * T_bl.
    """
    if room is None:
        room, obstacles = default_world()
    if obstacles is None:
        obstacles = []

    elev = np.deg2rad(np.linspace(lower_deg, upper_deg, n_rings))
    pts = np.zeros((n_azimuth, n_rings, 3), dtype=np.float64)
    valid = np.zeros((n_azimuth, n_rings), dtype=bool)

    if extrinsic_lb is not None:
        q_lb, t_lb = extrinsic_lb
        rot_lb = Rotation.from_quat(np.roll(np.asarray(q_lb), -1))
        rot_bl = rot_lb.inv()
        t_bl = -rot_bl.apply(np.asarray(t_lb))

    for a_i in range(n_azimuth):
        tau = a_i / n_azimuth
        t = t0 + tau * scan_period
        rot_wb, p_wb, _, _, _ = traj.pose(t)
        if extrinsic_lb is not None:
            rot_ws = rot_wb * rot_bl
            p_ws = rot_wb.apply(t_bl) + p_wb
        else:
            rot_ws, p_ws = rot_wb, p_wb

        # azimuth convention: azi = 2*pi - atan2(y, x) grows with time
        azi = 2.0 * np.pi * tau
        theta = -azi  # atan2(y,x) angle in sensor frame
        d_sensor = np.stack(
            [np.cos(theta) * np.cos(elev), np.sin(theta) * np.cos(elev), np.sin(elev)],
            axis=-1,
        )  # (R, 3)
        d_world = rot_ws.apply(d_sensor)
        dist = cast_rays(p_ws, d_world, room, obstacles)
        ok = np.isfinite(dist) & (dist < max_range) & (dist > 0.3)
        dist = np.where(ok, dist, 1.0)
        if noise_std > 0 and rng is not None:
            dist = dist + rng.normal(0, noise_std, size=dist.shape)
        pts[a_i] = d_sensor * dist[:, None]
        valid[a_i] = ok

    xyz = pts.reshape(-1, 3).astype(np.float32)
    mask = valid.reshape(-1)
    return xyz, mask


def simulate_imu_interval(traj: Trajectory, t_start: float, t_end: float, rate_hz: float = 200.0,
                          noise: dict | None = None, rng: np.random.Generator | None = None):
    """IMU samples in (t_start, t_end]; returns (ts, acc (M,3), gyr (M,3))."""
    n = int(round((t_end - t_start) * rate_hz))
    ts = t_start + (np.arange(1, n + 1)) / rate_hz
    acc = np.zeros((n, 3))
    gyr = np.zeros((n, 3))
    for i, t in enumerate(ts):
        a, w = traj.imu(t)
        acc[i], gyr[i] = a, w
    if noise and rng is not None:
        acc = acc + rng.normal(0, noise.get("acc_n", 0.0), acc.shape)
        gyr = gyr + rng.normal(0, noise.get("gyr_n", 0.0), gyr.shape)
    return ts, acc, gyr


def gt_sensor_pose(traj: Trajectory, t: float, extrinsic_lb=None):
    """Ground-truth LiDAR pose (q wxyz, p) in world at time t."""
    rot_wb, p_wb, _, _, _ = traj.pose(t)
    if extrinsic_lb is not None:
        q_lb, t_lb = extrinsic_lb
        rot_lb = Rotation.from_quat(np.roll(np.asarray(q_lb), -1))
        rot_bl = rot_lb.inv()
        t_bl = -rot_bl.apply(np.asarray(t_lb))
        rot_ws = rot_wb * rot_bl
        p_ws = rot_wb.apply(t_bl) + p_wb
    else:
        rot_ws, p_ws = rot_wb, p_wb
    return np.roll(rot_ws.as_quat(), 1), p_ws


def synthetic_estimator_state(cfg, traj: Trajectory, dtype=None, device=None,
                              n_azimuth: int = 540, room=None,
                              obstacles=None, max_range: float = 80.0,
                              t_start: float = 0.5):
    """Fabricate an INITED ``EstimatorState`` from ground truth.

    Fills the full sliding window — GT body poses/velocities, per-frame
    surf stacks (voxel-downsampled synthetic sweeps in their own laser
    frames), exact preintegrations and raw IMU buffers — without running
    the odometry/initializer pipeline. Requires an identity extrinsic
    (body == laser). Returns (state, t_next) with ``t_next`` the start
    time of the next sweep. Built on this package's own estimator,
    preintegration and voxel modules (device ``device``, default CPU).
    """
    import torch

    from ..models import estimator as EST
    from ..ops import preintegration as PI
    from ..ops import voxel as VX
    from ..utils.tree import tree_stack

    e = cfg.estimator
    dtype = dtype or torch.float32
    w1 = e.window_size + 1
    dt = cfg.sensor.scan_period * max(1, e.odom_io)
    m = e.imu.max_imu_per_frame
    state = EST.init_state(cfg, dtype, device)
    noise18 = PI.noise_matrix(e.imu.acc_n, e.imu.gyr_n, e.imu.acc_w,
                              e.imu.gyr_w, dtype, device)
    zeros3 = torch.zeros(3, dtype=dtype, device=device)

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    times = [t_start + i * dt for i in range(w1)]
    qs, ps, vs, stacks_x, stacks_m, pres, imus = [], [], [], [], [], [], []
    for i, tm in enumerate(times):
        rot, p, v, _, _ = traj.pose(tm)
        qs.append(np.roll(rot.as_quat(), 1))
        ps.append(p)
        vs.append(v)
        xyz, mask = simulate_sweep(
            traj, tm - cfg.sensor.scan_period, n_azimuth=n_azimuth,
            n_rings=cfg.sensor.n_rings, lower_deg=cfg.sensor.lower_bound_deg,
            upper_deg=cfg.sensor.upper_bound_deg, room=room,
            obstacles=obstacles, max_range=max_range)
        sx, sm, _ = VX.voxel_downsample(
            t(xyz), torch.as_tensor(mask, device=device),
            e.surf_filter_size, e.surf_stack_cap)
        stacks_x.append(sx)
        stacks_m.append(sm)
        if i == 0:
            pres.append(PI.Preintegration.identity(dtype, device))
            imus.append(PI.ImuSamples.empty(m, dtype, device))
        else:
            ts, acc, gyr = simulate_imu_interval(traj, times[i - 1], tm, 200.0)
            a0, w0 = traj.imu(times[i - 1])
            dts = np.diff(np.concatenate([[times[i - 1]], ts]))
            packed = PI.pack_samples_np(dts, acc, gyr, a0, w0, m)
            samples = PI.unpack_samples(t(packed))
            imus.append(samples)
            pres.append(PI.integrate(samples, zeros3, zeros3, noise18))

    state = state._replace(
        qs=t(np.stack(qs)), ps=t(np.stack(ps)), vs=t(np.stack(vs)),
        qs_lin=t(np.stack(qs)), ps_lin=t(np.stack(ps)),
        pres=tree_stack(pres), imu=tree_stack(imus),
        surf_xyz=torch.stack(stacks_x), surf_mask=torch.stack(stacks_m),
        g_vec=t([0.0, 0.0, -traj.g_norm]),
    )
    return state, times[-1] + dt
