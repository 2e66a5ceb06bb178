"""Visualization exports (the reference's Visualizer / debug tooling; copy of
lio_mapping_tpu.io.viz).

Parity targets (SURVEY §2 #20, §5 observability):
* ``scripts/transform_monitor.py:16-60`` — republishes trajectory euler
  angles for rqt_plot; here ``euler_series`` + ``plot_trajectory`` render
  the same signals (XY path, z, yaw/pitch/roll over time) straight to PNG,
  and ``save_euler_csv`` writes the raw series for external tooling.
* ``Visualizer.h:75-106`` PlaneNormalVisualizer — a PCLVisualizer window
  showing the local map + fitted plane normals; here ``save_ply_normals``
  writes the same (cloud, normal) pairs as a normals-annotated PLY that
  CloudCompare/MeshLab render identically, with the association produced
  by the same device kernels the estimator runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def euler_series(qs: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz quaternions -> (N, 3) [yaw, pitch, roll] degrees
    (R2ypr convention, math_utils.h — what transform_monitor republishes)."""
    from scipy.spatial.transform import Rotation

    r = Rotation.from_quat(np.roll(np.asarray(qs, np.float64), -1, axis=-1))
    # intrinsic ZYX == R2ypr's yaw-pitch-roll
    return r.as_euler("ZYX", degrees=True)


def save_euler_csv(path: str, times: Sequence[float], qs: np.ndarray):
    """t,yaw,pitch,roll CSV (transform_monitor's /monitor/... topics)."""
    ypr = euler_series(qs)
    with open(path, "w") as f:
        f.write("t,yaw_deg,pitch_deg,roll_deg\n")
        for t, row in zip(times, ypr):
            f.write(f"{t:.6f},{row[0]:.4f},{row[1]:.4f},{row[2]:.4f}\n")


def plot_trajectory(
    out_png: str,
    times: Sequence[float],
    qs: np.ndarray,
    ts: np.ndarray,
    gt: Optional[tuple] = None,   # (times, qs, ts)
    title: str = "trajectory",
):
    """XY path + altitude + euler angles (the debug_plot.sh dashboards)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ts = np.asarray(ts)
    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    ax = axes[0][0]
    ax.plot(ts[:, 0], ts[:, 1], label="est")
    if gt is not None:
        ax.plot(np.asarray(gt[2])[:, 0], np.asarray(gt[2])[:, 1],
                "--", label="gt")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(f"{title}: XY path")
    ax.axis("equal")
    ax.legend()

    ax = axes[0][1]
    ax.plot(times, ts[:, 2], label="est")
    if gt is not None:
        ax.plot(gt[0], np.asarray(gt[2])[:, 2], "--", label="gt")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("z [m]")
    ax.set_title("altitude")
    ax.legend()

    ypr = euler_series(qs)
    ypr_g = euler_series(gt[1]) if gt is not None else None
    for k, (name, col) in enumerate((("yaw", 0), ("pitch", 1))):
        ax = axes[1][k]
        ax.plot(times, ypr[:, col], label=f"est {name}")
        if k == 1:
            ax.plot(times, ypr[:, 2], label="est roll")
        if ypr_g is not None:
            ax.plot(gt[0], ypr_g[:, col], "--", label=f"gt {name}")
            if k == 1:
                ax.plot(gt[0], ypr_g[:, 2], "--", label="gt roll")
        ax.set_xlabel("t [s]")
        ax.set_ylabel("deg")
        ax.set_title(name if k == 0 else "pitch / roll")
        ax.legend()

    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def save_ply_normals(path: str, xyz: np.ndarray, normals: np.ndarray,
                     scores: Optional[np.ndarray] = None):
    """Normals-annotated binary-less ASCII PLY (PlaneNormalVisualizer view).

    ``scores`` (optional) are written as a per-vertex quality channel (the
    reference colors normals by association score, Visualizer.h:108-238).
    """
    xyz = np.asarray(xyz, np.float32)
    normals = np.asarray(normals, np.float32)
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if scores is not None:
            f.write("property float quality\n")
        f.write("end_header\n")
        for i in range(n):
            row = (f"{xyz[i,0]:.4f} {xyz[i,1]:.4f} {xyz[i,2]:.4f} "
                   f"{normals[i,0]:.4f} {normals[i,1]:.4f} {normals[i,2]:.4f}")
            if scores is not None:
                row += f" {float(scores[i]):.4f}"
            f.write(row + "\n")


def save_ply_cloud(path: str, xyz: np.ndarray):
    """Plain ASCII PLY point cloud (the local-map half of the viewer)."""
    xyz = np.asarray(xyz, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in xyz:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
