"""The benchmark's synthetic sensor data, made on the device from the seed.

A frozen rewrite in PyTorch of the world, trajectory, ray-casting and IMU
pieces of ``lio_mapping_tpu_torch/io/synthetic.py``: axis-aligned boxes in
an axis-aligned room, an analytic body trajectory that is twice
differentiable (so the IMU is exact before noise), a spinning LiDAR whose
points are taken in the sensor frame at each firing time (motion skew
included) and an IMU of body accelerations and rates. With
``sensor.deskewed`` a sweep is motion-compensated as a driver delivers it
(KITTI's scans are): every point in the laser's frame at the sweep's end
stamp. Every array comes out
of a few large tensor calls, so a loop of a few hundred HDL-64 sweeps takes
well under a second on the card.

The sequence is periodic: ``loop_sweeps`` sweeps span one period of the
trajectory, so sweep ``k`` of a run is sweep ``k % loop_sweeps`` of the loop
with the same poses, points and IMU samples. The seed draws the range noise
and the IMU noise; the trajectory, the world, the slot count and the
lengths are the configuration's alone.

Nothing here imports the program under test: the same functions give the
ground truth that the run's poses are judged against
(``harness/reference.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

SWEEPS_PER_CALL = 8  # sweeps ray-cast together: ~1.2M HDL-64 rays, a few hundred MB


def rot_zyx(yaw: torch.Tensor, pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation Rz(yaw) Ry(pitch) Rx(roll) (scipy's ``ZYX``)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _body_rates(yaw, pitch, roll, dyaw, dpitch, droll):
    """Body-frame angular rate from ZYX Euler angles and their rates."""
    sp, cp = torch.sin(pitch), torch.cos(pitch)
    sr, cr = torch.sin(roll), torch.cos(roll)
    return torch.stack([droll - dyaw * sp,
                        dpitch * cr + dyaw * cp * sr,
                        -dpitch * sr + dyaw * cp * cr], dim=-1)


def trajectory_state(traj: dict, t: torch.Tensor):
    """The body's (R_wb (..., 3, 3), p, v, a, omega_b) at times ``t``.

    ``traj["kind"]``: ``wobble`` (``synthetic.Trajectory``: sinusoidal
    translation, yaw, pitch and roll) or ``circle``
    (``synthetic.CircleTrajectory``: constant speed on a circle, facing
    along the tangent, with a vertical and a pitch/roll wobble)."""
    kind = traj["kind"]
    if kind == "wobble":
        amp = torch.tensor(traj["pos_amp"], dtype=t.dtype, device=t.device)
        w = 2.0 * math.pi * torch.tensor(traj["pos_freq"], dtype=t.dtype, device=t.device)
        wt = w * t[..., None]
        p = amp * torch.sin(wt)
        v = amp * w * torch.cos(wt)
        a = -amp * w * w * torch.sin(wt)
        wy = 2.0 * math.pi * traj["yaw_freq"]
        yaw = traj["yaw_amp"] * torch.sin(wy * t)
        dyaw = traj["yaw_amp"] * wy * torch.cos(wy * t)
    elif kind == "circle":
        r = traj["radius"]
        om = traj["speed"] / r
        th = om * t
        wz = 2.0 * math.pi * traj["z_freq"]
        za = traj["z_amp"]
        p = torch.stack([r * torch.cos(th), r * torch.sin(th), za * torch.sin(wz * t)], -1)
        v = torch.stack([-r * om * torch.sin(th), r * om * torch.cos(th),
                         za * wz * torch.cos(wz * t)], -1)
        a = torch.stack([-r * om * om * torch.cos(th), -r * om * om * torch.sin(th),
                         -za * wz * wz * torch.sin(wz * t)], -1)
        yaw = th + math.pi / 2
        dyaw = torch.full_like(t, om)
    else:
        raise ValueError(f"unknown trajectory kind {kind!r}")
    wr = 2.0 * math.pi * traj["rp_freq"]
    pitch = traj["pitch_amp"] * torch.sin(wr * t)
    roll = traj["roll_amp"] * torch.cos(wr * t)
    dpitch = traj["pitch_amp"] * wr * torch.cos(wr * t)
    droll = -traj["roll_amp"] * wr * torch.sin(wr * t)
    rot = rot_zyx(yaw, pitch, roll)
    return rot, p, v, a, _body_rates(yaw, pitch, roll, dyaw, dpitch, droll)


@dataclass(frozen=True)
class Rig:
    """The laser -> body transform of the rig that is simulated
    (``R_lb``, ``t_lb``: a point in the laser frame maps into the body
    frame as ``R_bl p + t_bl``), and its inverse."""

    r_bl: torch.Tensor  # (3, 3) float64
    t_bl: torch.Tensor  # (3,) float64

    @staticmethod
    def from_lb(r_lb, t_lb) -> "Rig":
        r_lb = torch.as_tensor(r_lb, dtype=torch.float64).reshape(3, 3)
        t_lb = torch.as_tensor(t_lb, dtype=torch.float64).reshape(3)
        r_bl = r_lb.T
        return Rig(r_bl, -r_bl @ t_lb)


def sensor_poses(traj: dict, rig: Rig, t: torch.Tensor):
    """The laser's (R_ws, p_ws) at times ``t``: T_wb T_bl."""
    rot_wb, p_wb, _, _, _ = trajectory_state(traj, t)
    r_bl = rig.r_bl.to(t.device, t.dtype)
    t_bl = rig.t_bl.to(t.device, t.dtype)
    return rot_wb @ r_bl, (rot_wb @ t_bl) + p_wb


def cast(origin: torch.Tensor, dirs: torch.Tensor, room: torch.Tensor,
         boxes: torch.Tensor) -> torch.Tensor:
    """Distance along each ray to the first surface: the room's shell from
    inside, or the nearest solid box. ``origin``/``dirs`` (..., 3),
    ``room`` (2, 3), ``boxes`` (B, 2, 3); inf where nothing is hit."""
    inv = 1.0 / dirs
    t_lo = (room[0] - origin) * inv
    t_hi = (room[1] - origin) * inv
    t_far = torch.maximum(t_lo, t_hi)
    t_far = torch.where(torch.isfinite(t_far), t_far, torch.full_like(t_far, math.inf))
    dist = t_far.amin(dim=-1)
    for b in range(boxes.shape[0]):
        t0 = (boxes[b, 0] - origin) * inv
        t1 = (boxes[b, 1] - origin) * inv
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        near = torch.where(torch.isnan(near), torch.full_like(near, -math.inf), near).amax(-1)
        far = torch.where(torch.isnan(far), torch.full_like(far, math.inf), far).amin(-1)
        hit = (near <= far) & (far > 0) & (near > 0)
        dist = torch.where(hit, torch.minimum(dist, near), dist)
    return dist


class Loop:
    """One period of a configuration's sequence, made on ``device``.

    ``xyz`` (P, S, 3) float32 and ``mask`` (P, S) bool: sweep ``k`` spans
    [k dt, (k + 1) dt], S = rings x azimuth steps slots in firing order
    (every ring of one azimuth step, then the next), no-returns masked.
    ``imu_acc``/``imu_gyr`` (P * n + 1 wrapped to P * n, 3) float64: the IMU
    at t = j / rate for j = 0 .. P n - 1; sweep ``k``'s interval is samples
    k n + 1 .. (k + 1) n (the last one wraps to the loop's first), with
    sample k n as its start."""

    def __init__(self, conf: dict, seed: int, device):
        sensor, imu, seq = conf["sensor"], conf["imu"], conf["sequence"]
        self.conf = conf
        self.dt = float(sensor["scan_period"])
        self.period = int(seq["loop_sweeps"])
        self.rate = float(imu["rate_hz"])
        self.n_imu = int(round(self.dt * self.rate))
        if abs(self.n_imu / self.rate - self.dt) > 1e-9:
            raise ValueError("the IMU rate must give a whole number of samples a sweep")
        self.traj = conf["trajectory"]
        self.rig = rig_of(conf)
        check_periodic(self.traj, self.rig, self.period * self.dt)
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) % (2 ** 63))
        world = conf["world"]
        room = torch.tensor(world["room"], dtype=torch.float32, device=dev)
        boxes = torch.tensor(world["boxes"], dtype=torch.float32, device=dev).reshape(-1, 2, 3)
        n_rings, n_az = int(sensor["n_rings"]), int(sensor["n_azimuth"])
        elev = torch.deg2rad(torch.linspace(sensor["lower_deg"], sensor["upper_deg"], n_rings,
                                            dtype=torch.float64, device=dev))
        tau = torch.arange(n_az, dtype=torch.float64, device=dev) / n_az
        theta = -2.0 * math.pi * tau  # atan2(y, x) falls as the head spins
        d_sensor = torch.stack([torch.cos(theta)[:, None] * torch.cos(elev),
                                torch.sin(theta)[:, None] * torch.cos(elev),
                                torch.sin(elev).expand(n_az, n_rings)], -1)  # (A, R, 3)
        self.slots = n_az * n_rings
        xyz = torch.empty((self.period, self.slots, 3), dtype=torch.float32, device=dev)
        mask = torch.empty((self.period, self.slots), dtype=torch.bool, device=dev)
        lo, hi = float(sensor["min_range"]), float(sensor["max_range"])
        for k0 in range(0, self.period, SWEEPS_PER_CALL):
            ks = torch.arange(k0, min(k0 + SWEEPS_PER_CALL, self.period), dtype=torch.float64,
                              device=dev)
            t = (ks[:, None] + tau) * self.dt  # (K, A) firing times
            r_ws, p_ws = sensor_poses(self.traj, self.rig, t)
            d_world = torch.einsum("kaij,arj->kari", r_ws, d_sensor).to(torch.float32)
            origin = p_ws.to(torch.float32)[:, :, None, :].expand_as(d_world)
            dist = cast(origin, d_world, room, boxes)
            ok = torch.isfinite(dist) & (dist < hi) & (dist > lo)
            dist = torch.where(ok, dist, torch.ones_like(dist))
            noise = torch.randn(dist.shape, generator=gen, device=dev, dtype=torch.float32)
            dist = dist + float(sensor["range_noise_m"]) * noise
            pts = d_sensor.to(torch.float32) * dist[..., None]
            if sensor.get("deskewed", False):
                # the driver's motion compensation: every point in the
                # laser's frame at the sweep's end stamp
                r_end, p_end = sensor_poses(self.traj, self.rig, (ks + 1) * self.dt)
                world_pts = (torch.einsum("kaij,karj->kari", r_ws.to(torch.float32), pts)
                             + p_ws.to(torch.float32)[:, :, None, :])
                pts = torch.einsum("kji,karj->kari", r_end.to(torch.float32),
                                   world_pts - p_end.to(torch.float32)[:, None, None, :])
            sl = slice(k0, k0 + len(ks))
            xyz[sl] = pts.reshape(len(ks), self.slots, 3)
            mask[sl] = ok.reshape(len(ks), self.slots)
        self.xyz, self.mask = xyz, mask
        n_all = self.period * self.n_imu
        t_imu = torch.arange(n_all, dtype=torch.float64, device=dev) / self.rate
        rot, _, _, acc_w, omega = trajectory_state(self.traj, t_imu)
        g_w = torch.tensor([0.0, 0.0, -float(imu["g_norm"])], dtype=torch.float64, device=dev)
        acc = torch.einsum("nji,nj->ni", rot, acc_w - g_w)  # R^T (a - g)
        acc = acc + float(imu["acc_noise"]) * torch.randn(
            acc.shape, generator=gen, device=dev, dtype=torch.float64)
        gyr = omega + float(imu["gyr_noise"]) * torch.randn(
            omega.shape, generator=gen, device=dev, dtype=torch.float64)
        self.imu_acc, self.imu_gyr = acc, gyr

    def to_host(self) -> "HostLoop":
        """The loop as host arrays, as a driver or a log reader hands them
        over (numpy, not pinned)."""
        return HostLoop(self)


class HostLoop:
    """A :class:`Loop` copied to host memory, with each sweep's IMU
    interval as (dts, acc, gyr, acc0, gyr0)."""

    def __init__(self, loop: Loop):
        self.period, self.dt, self.n_imu, self.slots = loop.period, loop.dt, loop.n_imu, loop.slots
        self.xyz = loop.xyz.cpu().numpy()
        self.mask = loop.mask.cpu().numpy()
        acc = loop.imu_acc.cpu().numpy()
        gyr = loop.imu_gyr.cpu().numpy()
        n, p = self.n_imu, self.period
        idx = [(k * n + 1 + j) % (p * n) for k in range(p) for j in range(n)]
        self.acc = acc[idx].reshape(p, n, 3)
        self.gyr = gyr[idx].reshape(p, n, 3)
        self.acc0 = acc[[k * n for k in range(p)]]
        self.gyr0 = gyr[[k * n for k in range(p)]]
        self.dts = [1.0 / loop.rate] * n

    def sweep(self, k: int):
        """Sweep ``k`` of a run: (xyz (S, 3) f32, mask (S,), dts, acc, gyr,
        acc0, gyr0)."""
        i = k % self.period
        return (self.xyz[i], self.mask[i], self.dts, self.acc[i], self.gyr[i], self.acc0[i],
                self.gyr0[i])


def rig_of(conf: dict) -> Rig:
    """The rig of ``conf["rig"]``: ``identity``, or ``{"r_lb": 9 row-major
    numbers, "t_lb": 3}``."""
    rig = conf["rig"]
    if rig == "identity":
        return Rig(torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))
    return Rig.from_lb(rig["r_lb"], rig["t_lb"])


def check_periodic(traj: dict, rig: Rig, period_s: float):
    """Refuse a loop whose trajectory does not repeat after ``period_s``."""
    t = torch.linspace(0.0, period_s, 17, dtype=torch.float64)
    r0, p0 = sensor_poses(traj, rig, t)
    r1, p1 = sensor_poses(traj, rig, t + period_s)
    if float((r0 - r1).abs().max()) > 1e-9 or float((p0 - p1).abs().max()) > 1e-6:
        raise ValueError(f"the trajectory does not repeat after {period_s} s")
