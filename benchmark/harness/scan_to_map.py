"""The plain float64 reference of one 4D map builder step.

The builder (``MapBuilder.step`` of the program) refines the estimator's
pose of a consumed sweep against its own map and then inserts the sweep's
features into that map. This module works the same step out again, from
the step's inputs: the builder's map and poses before the step, the
sweep's corner and surf clouds and the estimator's pose. It follows the
reference system's ``MapBuilder.cc`` / ``PointMapping.cc``:

* the yaw-only prediction (``predict_4d``): the incremental transform
  since the last step, of which only the yaw offset over the incoming
  rotation is kept;
* the stacks' voxel-centroid downsample (corner 0.2 m, surf 0.4 m);
* the scan-to-map Gauss-Newton (``optimize``): 5-NN line fits for corner
  rows (accepted where the largest eigenvalue exceeds three times the
  middle one), 5-NN plane fits with the 0.2 m planarity check for surf
  rows, the +-60 deg field-of-view cone, the rotation Jacobian damped to
  yaw in the body frame, the eigenvalue-100 degeneracy projection taken at
  the first iteration, a left-multiplied update, and the 0.05 deg / 0.05
  cm abort, at most ``max_iterations`` iterations;
* the map insert (``insert``): the union of the map and the new world
  points, a voxel-centroid filter, a crop to the active cube region around
  the snapped origin.

Every number is float64; searches are exact. Imports torch only: nothing of
the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

F64 = torch.float64
WIDE_HALF_CELLS = 4096          # the map's voxel keys hold +-4096 cells an axis
STACK_HALF_CELLS = 512          # a stack's voxel keys hold +-512 cells an axis


# -- rotations (w, x, y, z quaternions) ------------------------------------

def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qnorm(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qconj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qmat(q):
    """Unit quaternion -> rotation matrix."""
    w, x, y, z = qnorm(q).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        dim=-1).reshape(q.shape[:-1] + (3, 3))


def mat_q(m):
    """Rotation matrix -> unit quaternion, w >= 0."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    cands = torch.stack([tr, m[0, 0], m[1, 1], m[2, 2]])
    i = int(torch.argmax(cands))
    if i == 0:
        s = 2.0 * torch.sqrt(1.0 + tr)
        q = torch.stack([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    elif i == 1:
        s = 2.0 * torch.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        q = torch.stack([(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
                         (m[0, 2] + m[2, 0]) / s])
    elif i == 2:
        s = 2.0 * torch.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2])
        q = torch.stack([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                         (m[1, 2] + m[2, 1]) / s])
    else:
        s = 2.0 * torch.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2])
        q = torch.stack([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                         (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    return qnorm(q if q[0] >= 0 else -q)


def yaw_of(r) -> torch.Tensor:
    """Yaw (rad) of a rotation matrix, as the reference's ``R2ypr``."""
    return torch.atan2(r[1, 0], r[0, 0])


def rot_z(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o]).reshape(3, 3)


def angle_between(q0, q1) -> torch.Tensor:
    """Angle (rad) of q0^-1 q1."""
    d = qmul(qconj(qnorm(q0)), qnorm(q1))
    return 2.0 * torch.atan2(torch.linalg.norm(d[..., 1:]), torch.abs(d[..., 0]))


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(v.shape[:-1] + (3, 3))


class Pose:
    """x' = R(q) x + t, float64."""

    def __init__(self, q, t):
        self.q, self.t = q.to(F64), t.to(F64)

    def apply(self, pts):
        return pts @ qmat(self.q).T + self.t

    def __matmul__(self, other: "Pose") -> "Pose":
        r = qmat(self.q)
        return Pose(qmul(self.q, other.q), r @ other.t + self.t)

    def inverse(self) -> "Pose":
        qi = qconj(qnorm(self.q))
        return Pose(qi, -(qmat(qi) @ self.t))


def predict_4d(pose: Pose, pose_bef: Pose, odom: Pose) -> Pose:
    """The yaw-only prediction (MapBuilder.cc:55-75): the full incremental
    transform's translation, and the incoming rotation turned by the yaw
    offset of the full one over it."""
    full = pose @ (pose_bef.inverse() @ odom)
    full_q = qnorm(full.q)
    dyaw = yaw_of(qmat(full_q)) - yaw_of(qmat(odom.q))
    q = qnorm(qmul(mat_q(rot_z(dyaw)), qnorm(odom.q)))
    return Pose(q, full.t)


# -- voxel filter ------------------------------------------------------------

def voxel_centroids(xyz, mask, leaf: float, capacity: int, half_cells: int):
    """Centroids of the voxels of side ``leaf`` that the valid points fall
    in, in ascending (x, y, z) cell order, the first ``capacity`` of them;
    points outside +-``half_cells`` cells of the origin are dropped.
    Returns (xyz (C, 3), mask (C,))."""
    xyz = xyz.to(F64)
    cells = torch.floor(xyz / leaf).clamp(-(1 << 20), 1 << 20).to(torch.int64)
    ok = mask & torch.all((cells >= -half_cells) & (cells < half_cells), dim=-1)
    cells, pts = cells[ok] + half_cells, xyz[ok]
    span = 2 * half_cells
    key = (cells[:, 0] * span + cells[:, 1]) * span + cells[:, 2]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    n = min(len(uniq), capacity)
    sums = torch.zeros((len(uniq), 3), dtype=F64, device=xyz.device).index_add_(0, inv, pts)
    cnt = torch.zeros(len(uniq), dtype=F64, device=xyz.device).index_add_(
        0, inv, torch.ones_like(pts[:, 0]))
    out = torch.zeros((capacity, 3), dtype=F64, device=xyz.device)
    out[:n] = (sums / cnt[:, None])[:n]
    out_mask = torch.zeros(capacity, dtype=torch.bool, device=xyz.device)
    out_mask[:n] = True
    return out, out_mask


# -- searches and fits -------------------------------------------------------

def knn5(queries, db, db_mask, chunk: int = 1024):
    """The 5 nearest valid map rows of each query, exact, in float64:
    (squared distances (Q, 5) ascending, indices (Q, 5)); fewer than 5
    valid rows give +inf distances."""
    d_all, i_all = [], []
    db_sq = torch.sum(db * db, dim=-1)
    for s in range(0, len(queries), chunk):
        q = queries[s:s + chunk]
        d = torch.sum(q * q, dim=-1, keepdim=True) + db_sq[None, :] - 2.0 * (q @ db.T)
        d = torch.where(db_mask[None, :], d.clamp_min(0.0), math.inf)
        k = min(5, d.shape[1])
        dk, ik = torch.topk(d, k, dim=1, largest=False, sorted=True)
        d_all.append(dk)
        i_all.append(ik)
    if not d_all:
        return (torch.zeros((0, 5), dtype=F64, device=db.device),
                torch.zeros((0, 5), dtype=torch.int64, device=db.device))
    return torch.cat(d_all), torch.cat(i_all)


def line_fit(nb, valid):
    """(centroid, unit direction, ok): ok where the largest eigenvalue of
    the 5 points' covariance exceeds three times the middle one."""
    c = nb.mean(dim=-2)
    dev = nb - c[..., None, :]
    cov = dev.transpose(-1, -2) @ dev / nb.shape[-2]
    vals, vecs = torch.linalg.eigh(cov)
    return c, vecs[..., :, 2], valid & (vals[..., 2] > 3.0 * vals[..., 1])


def point_to_line(p, c, d):
    """Distance from ``p`` to the line and the unit direction toward it."""
    x1, x2 = c + 0.1 * d, c - 0.1 * d
    a = torch.linalg.cross(p - x1, p - x2, dim=-1)
    l12 = torch.linalg.norm(x1 - x2, dim=-1)
    ld = torch.linalg.norm(a, dim=-1) / l12
    n = torch.linalg.cross(x1 - x2, a, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-300)
    return ld, n


def plane_fit(nb, valid, min_plane_dis: float):
    """Plane w.p + d = 0, |w| = 1, through the 5 points by least squares of
    A x = -1; ok where every point lies within ``min_plane_dis``."""
    ones = -torch.ones(nb.shape[:-1] + (1,), dtype=F64, device=nb.device)
    x = torch.linalg.lstsq(nb, ones, driver="gels" if nb.is_cuda else "gelsd").solution[..., 0]
    norm = torch.linalg.norm(x, dim=-1)
    w = x / norm.clamp_min(1e-300)[..., None]
    d = 1.0 / norm.clamp_min(1e-300)
    dist = torch.abs((nb * w[..., None, :]).sum(-1) + d[..., None])
    ok = valid & torch.all(dist <= min_plane_dis, dim=-1) & torch.isfinite(d) & (norm > 1e-8)
    return w, d, ok


def fov_ok(sel, pose: Pose):
    """+-60 deg cone around the sensor's z axis (PointMapping.cc:487-503)."""
    z_axis = pose.apply(torch.tensor([[0.0, 0.0, 10.0]], dtype=F64, device=sel.device))[0]
    sq1 = torch.sum((sel - pose.t) ** 2, dim=-1)
    sq2 = torch.sum((sel - z_axis) ** 2, dim=-1)
    k = 10.0 * math.sqrt(3.0)
    base = 100.0 + sq1 - sq2
    return (base - k * torch.sqrt(sq1) < 0) & (base + k * torch.sqrt(sq1) > 0)


def degeneracy(ata, eigen_th: float):
    """(projector, degenerate): the eigen-directions of A^T A below
    ``eigen_th``, counted from the smallest up to the first above it,
    projected out."""
    vals, vecs = torch.linalg.eigh(ata)
    small = torch.cumprod((vals < eigen_th).to(torch.int64), dim=0) == 1
    keep = (~small).to(F64)
    return (vecs * keep[None, :]) @ vecs.T, bool(small.any())


def _gated(d, gate: float):
    """Rows whose fifth neighbour lies within the squared-distance gate."""
    if d.shape[1] < 5:
        return torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
    return d[:, 4] < gate


def optimize(maps, stacks, pose0: Pose, mc: dict) -> Tuple[Pose, int]:
    """The yaw-constrained scan-to-map GN from ``pose0``; returns the pose
    and the iterations run."""
    c_db, c_db_mask, s_db, s_db_mask = maps
    c_st, c_st_mask, s_st, s_st_mask = stacks
    c_st, s_st = c_st[c_st_mask], s_st[s_st_mask]
    q, t = pose0.q.clone(), pose0.t.clone()
    gate = mc["min_match_sq_dis"]
    damp = torch.tensor([5e-3, 5e-3, 1.0], dtype=F64, device=t.device)
    skews = skew(torch.cat([c_st, s_st]))
    proj, degen = None, False
    for it in range(int(mc["max_iterations"])):
        pose = Pose(q, t)
        c_sel = pose.apply(c_st)
        c_d, c_i = knn5(c_sel, c_db, c_db_mask)
        c_ok = _gated(c_d, gate)
        cen, dirn, line_ok = line_fit(c_db[c_i], c_ok)
        ld, c_n = point_to_line(c_sel, cen, dirn)
        s_c = 1.0 - 0.9 * torch.abs(ld)
        w_c = c_ok & line_ok & (s_c > 0.1)

        s_sel = pose.apply(s_st)
        s_d, s_i = knn5(s_sel, s_db, s_db_mask)
        s_ok = _gated(s_d, gate)
        pw, pd, plane_ok = plane_fit(s_db[s_i], s_ok, mc["min_plane_dis"])
        pd2 = torch.sum(pw * s_sel, dim=-1) + pd
        rng = torch.sqrt(torch.linalg.norm(s_sel, dim=-1).clamp_min(1e-12))
        s_s = 1.0 - 0.9 * torch.abs(pd2) / rng
        w_s = s_ok & plane_ok & (s_s > 0.1)

        w_all = torch.cat([s_c[:, None] * c_n, s_s[:, None] * pw])
        d_all = torch.cat([s_c * ld, s_s * pd2])
        rows = torch.cat([w_c & fov_ok(c_sel, pose), w_s & fov_ok(s_sel, pose)])
        w_all = torch.where(rows[:, None], w_all, 0.0)
        d_all = torch.where(rows, d_all, 0.0)
        rot = qmat(q)
        j_r = -torch.einsum("ni,nij->nj", w_all, (rot @ skews) @ rot.T @ torch.diag(damp))
        jac = torch.cat([j_r, w_all], dim=1)
        ata = jac.T @ jac
        atb = jac.T @ (-d_all)
        x = torch.linalg.solve(ata + 1e-9 * torch.eye(6, dtype=F64, device=t.device), atb)
        if it == 0:
            proj, degen = degeneracy(ata, mc["degeneracy_eigen_th"])
        if degen:
            x = proj @ x
        x = torch.where(torch.isfinite(x), x, 0.0)
        few = int(rows.sum()) < 50
        if few:
            x = torch.zeros_like(x)
        q_new = qnorm(qmul(torch.cat([torch.ones(1, dtype=F64, device=t.device), 0.5 * x[:3]]), q))
        t = t + x[3:]
        delta_r = math.degrees(float(angle_between(q, q_new)))
        delta_t = 100.0 * float(torch.linalg.norm(x[3:]))
        q = q_new
        if (not few) and delta_r < mc["delta_r_abort_deg"] and delta_t < mc["delta_t_abort_cm"]:
            return Pose(q, t), it + 1
    return Pose(q, t), int(mc["max_iterations"])


def insert(map_xyz, map_mask, pts, pts_mask, pose: Pose, leaf: float, mc: dict):
    """The map after the new points (body frame, at ``pose``) are added:
    union, voxel-centroid filter and crop to the active cubes around the
    snapped origin."""
    ext_xy = min(0.5 * mc["cube_length"] * mc["cube_size_m"], 0.95 * leaf * WIDE_HALF_CELLS)
    ext_z = min(0.5 * mc["cube_height"] * mc["cube_size_m"], 0.95 * leaf * WIDE_HALF_CELLS)
    extent = torch.tensor([ext_xy, ext_xy, ext_z], dtype=F64, device=pose.t.device)
    snap = leaf * 64.0
    origin = torch.round(pose.t / snap) * snap
    xyz = torch.cat([map_xyz.to(F64), pose.apply(pts.to(F64))]) - origin
    mask = torch.cat([map_mask, pts_mask]) & torch.all(torch.abs(xyz) < extent, dim=-1)
    out, out_mask = voxel_centroids(xyz, mask, leaf, len(map_xyz), WIDE_HALF_CELLS)
    return out + origin, out_mask


def params(conf: dict) -> dict:
    """The step's parameters from the configuration file: its ``mapping.*``
    values and the stacks' capacities."""
    shipped = conf["shipped"]
    mc = {k.split(".", 1)[1]: v for k, v in shipped.items() if k.startswith("mapping.")}
    mc["corner_cap"] = int(shipped["estimator.corner_stack_cap"])
    mc["surf_cap"] = int(shipped["estimator.surf_stack_cap"])
    return mc


def _pose(v) -> Pose:
    return Pose(v[:4], v[4:])


def refine(snap: Dict[str, torch.Tensor], mc: dict):
    """The builder's pose for one step, from its inputs: ``snap`` holds the
    map and poses before the step (``corner_xyz``, ``corner_mask``,
    ``surf_xyz``, ``surf_mask``; ``pose``, ``pose_bef`` as (q wxyz, t);
    ``initialized``) and the step's inputs (``corner_cloud``,
    ``surf_cloud`` and their ``*_mask``, ``odom``). Returns (the refined
    pose, GN iterations, the downsampled stacks)."""
    f = {k: (v.to(F64) if v.is_floating_point() else v) for k, v in snap.items()}
    pose0 = predict_4d(_pose(f["pose"]), _pose(f["pose_bef"]), _pose(f["odom"]))
    stacks = (*voxel_centroids(f["corner_cloud"], f["corner_cloud_mask"],
                               mc["corner_filter_size"], mc["corner_cap"], STACK_HALF_CELLS),
              *voxel_centroids(f["surf_cloud"], f["surf_cloud_mask"],
                               mc["surf_filter_size"], mc["surf_cap"], STACK_HALF_CELLS))
    maps = (f["corner_xyz"], f["corner_mask"], f["surf_xyz"], f["surf_mask"])
    if bool(f["initialized"]) and int(maps[1].sum()) > 10 and int(maps[3].sum()) > 100:
        pose, iters = optimize(maps, stacks, pose0, mc)
        return pose, iters, stacks
    return pose0, 0, stacks


def insert_stacks(snap: Dict[str, torch.Tensor], stacks, out: Pose, mc: dict):
    """The corner and surf maps after the step's stacks are inserted at the
    step's output pose ``out``: ((xyz, mask), (xyz, mask))."""
    c_st, c_m, s_st, s_m = stacks
    return (insert(snap["corner_xyz"], snap["corner_mask"], c_st, c_m, out,
                   mc["corner_filter_size"], mc),
            insert(snap["surf_xyz"], snap["surf_mask"], s_st, s_m, out,
                   mc["surf_filter_size"], mc))


def rows_apart(prog_xyz, prog_mask, ref_xyz, ref_mask, tol_m: float, chunk: int = 4096) -> int:
    """Map rows of the program with no reference row within ``tol_m``, plus
    the difference of the two row counts."""
    a, b = prog_xyz.to(F64)[prog_mask], ref_xyz.to(F64)[ref_mask]
    if len(b) == 0:
        return len(a)
    off = 0
    b_sq = torch.sum(b * b, dim=-1)
    for s in range(0, len(a), chunk):
        q = a[s:s + chunk]
        d = (torch.sum(q * q, dim=-1, keepdim=True) + b_sq[None, :] - 2.0 * (q @ b.T)).clamp_min(0)
        off += int((d.min(dim=1).values > tol_m * tol_m).sum())
    return off + abs(len(a) - len(b))
