"""The port's LOAM back end against the reference package on the same
inputs, made from a seed: the wide (13-bit) voxel keys and filter,
``insert_into_map``, ``optimize_to_map`` (plain and ``yaw_constrained``)
and ``LoamPipeline`` over a few sweeps.

Tolerances: voxel keys, their sort order and the filter's output mask are
equal bit for bit (float32, +-800 m extents); centroids agree within 1e-6
(segment sums in another order); the map store and the scan-to-map poses
run in float64 and agree within 1e-6 and 1e-5; the LOAM laser poses
within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.io import synthetic as JSYN
from lio_mapping_tpu.models import mapping as JM
from lio_mapping_tpu.models.pipeline import LoamPipeline as JLoam
from lio_mapping_tpu.ops import voxel as JV
from lio_mapping_tpu.utils.se3 import Pose as JPose
from lio_mapping_tpu_torch.models import mapping as TM
from lio_mapping_tpu_torch.models.pipeline import LoamPipeline as TLoam
from lio_mapping_tpu_torch.ops import voxel as TV
from lio_mapping_tpu_torch.utils.se3 import Pose as TPose

from tests.test_torch_pipeline import cold_cfg, port_cfg

F64 = torch.float64
MAP_TOL = 1e-6
POSE_TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def loam_cfg():
    """``cold_cfg`` (narrow feature capacities) with a narrow map store and
    stacks: the reference searches each 10 times a mapped sweep."""
    base = cold_cfg()
    m = dataclasses.replace(base.mapping, map_cloud_cap=8192)
    est = dataclasses.replace(base.estimator, corner_stack_cap=512, surf_stack_cap=2048)
    return dataclasses.replace(base, mapping=m, estimator=est)


def _wide_inputs(rng, n=6000):
    """Points over +-900 m (some beyond the 13-bit range at 0.2 m), with
    repeats in the same voxels and a random mask."""
    centers = rng.uniform(-900, 900, (n // 4, 3))
    x = (centers[rng.integers(0, len(centers), n)] + rng.normal(0, 0.15, (n, 3)))
    return x.astype(np.float32), rng.uniform(size=n) < 0.9


@pytest.mark.parametrize("leaf", [0.2, 0.4])
def test_wide_keys_and_filter_bit_for_bit(leaf):
    rng = np.random.default_rng(0)
    x, mask = _wide_inputs(rng)
    ta, tb = TV.voxel_keys_wide(torch.as_tensor(x), torch.as_tensor(mask), leaf)
    ja, jb = JV.voxel_keys_wide(jnp.asarray(x), jnp.asarray(mask), leaf)
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    assert (np.asarray(ja) == np.iinfo(np.int32).max).any()  # out of range and masked
    assert (np.asarray(ja) != np.iinfo(np.int32).max).sum() > len(x) // 2

    for cap in (len(x), 500):  # every voxel, and a truncating capacity
        tx, tm, _ = TV.voxel_downsample(torch.as_tensor(x), torch.as_tensor(mask), leaf, cap,
                                        wide=True)
        jx, jm, _ = JV.voxel_downsample(jnp.asarray(x), jnp.asarray(mask), leaf, cap, wide=True)
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        # the same voxels in the same order: each centroid's keys, bit for bit
        tka, tkb = TV.voxel_keys_wide(tx, tm, leaf)
        jka, jkb = JV.voxel_keys_wide(jx, jm, leaf)
        np.testing.assert_array_equal(_np(tka), np.asarray(jka))
        np.testing.assert_array_equal(_np(tkb), np.asarray(jkb))
        valid = np.asarray(jm)
        np.testing.assert_allclose(_np(tx)[valid], np.asarray(jx)[valid], rtol=2e-7, atol=0)


def _sweep_world(traj, t0, n_azimuth=300):
    """A simulated sweep's valid points in the world frame at its GT pose."""
    from scipy.spatial.transform import Rotation

    xyz, mask = JSYN.simulate_sweep(traj, t0, n_azimuth=n_azimuth)
    q, p = JSYN.gt_sensor_pose(traj, t0 + 0.1)
    return xyz[mask], Rotation.from_quat(np.roll(q, -1)), p


def _poses(q, t):
    return (JPose(jnp.asarray(q, jnp.float64), jnp.asarray(t, jnp.float64)),
            TPose(torch.as_tensor(q, dtype=F64), torch.as_tensor(t, dtype=F64)))


def _stores(cfg, pts, leaf, moves):
    """Both packages' map store after one insert per pose in ``moves``."""
    cap = cfg.mapping.map_cloud_cap
    jvm = JM.VoxelMapStore.empty(cap, jnp.float64)
    tvm = TM.VoxelMapStore.empty(cap, F64)
    for k, (q, t) in enumerate(moves):
        jp, tp = _poses(q, t)
        chunk = pts[k::len(moves)]
        m = np.ones(len(chunk), bool)
        jvm = JM.insert_into_map(jvm, jnp.asarray(chunk), jnp.asarray(m), jp, leaf, cfg)
        tvm = TM.insert_into_map(tvm, torch.as_tensor(chunk), torch.as_tensor(m), tp, leaf,
                                 port_cfg(cfg))
    return jvm, tvm


def test_insert_into_map_matches():
    jcfg = loam_cfg()
    rng = np.random.default_rng(1)
    pts = rng.uniform(-30, 30, (5000, 3))
    moves = [((1.0, 0, 0, 0), (0.0, 0.0, 0.0)),
             ((np.cos(0.2), 0, 0, np.sin(0.2)), (27.3, -4.1, 0.5))]  # the origin snaps
    jvm, tvm = _stores(jcfg, pts, 0.4, moves)
    np.testing.assert_array_equal(_np(tvm.mask), np.asarray(jvm.mask))
    assert 1000 < int(np.asarray(jvm.mask).sum()) < jcfg.mapping.map_cloud_cap
    np.testing.assert_array_equal(_np(tvm.origin), np.asarray(jvm.origin))
    np.testing.assert_allclose(_np(tvm.xyz), np.asarray(jvm.xyz), atol=MAP_TOL, rtol=0)


@pytest.mark.parametrize("yaw_constrained", [False, True])
def test_optimize_to_map_matches(yaw_constrained):
    """Scan-to-map from a perturbed pose against a map of three posed
    sweeps: the same pose out of both, in float64."""
    jcfg = loam_cfg()
    cfg = port_cfg(jcfg)
    traj = JSYN.Trajectory()
    world = []
    for i in range(3):
        pts, rot, p = _sweep_world(traj, 0.1 * i)
        world.append(rot.apply(pts) + p)
    world = np.concatenate(world)
    m = jcfg.mapping
    cap = m.map_cloud_cap
    stores = {}
    for name, leaf in (("corner", m.corner_filter_size), ("surf", m.surf_filter_size)):
        jvm = JM.insert_into_map(JM.VoxelMapStore.empty(cap, jnp.float64), jnp.asarray(world),
                                 jnp.ones(len(world), bool), JPose.identity(dtype=jnp.float64),
                                 leaf, jcfg)
        stores[name] = (jnp.asarray(jvm.xyz), jnp.asarray(jvm.mask))

    pts, rot, p = _sweep_world(traj, 0.35)
    pts = pts.astype(np.float64)
    e = jcfg.estimator
    c_xyz, c_mask, _ = JV.voxel_downsample(jnp.asarray(pts), jnp.ones(len(pts), bool),
                                           m.corner_filter_size, e.corner_stack_cap)
    s_xyz, s_mask, _ = JV.voxel_downsample(jnp.asarray(pts), jnp.ones(len(pts), bool),
                                           m.surf_filter_size, e.surf_stack_cap)
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(2)
    rot0 = rot * Rotation.from_rotvec(rng.normal(size=3) * 0.01)
    q0 = np.roll(rot0.as_quat(), 1)
    t0 = p + rng.normal(size=3) * 0.05
    jp0, tp0 = _poses(q0, t0)

    args = (stores["corner"][0], stores["corner"][1], stores["surf"][0], stores["surf"][1],
            c_xyz, c_mask, s_xyz, s_mask)
    jout = JM.optimize_to_map(*args, jp0, jcfg, yaw_constrained=yaw_constrained)
    targs = [torch.as_tensor(np.array(a)) for a in args]
    tout = TM.optimize_to_map(*targs, tp0, cfg, yaw_constrained=yaw_constrained)
    np.testing.assert_allclose(_np(tout.t), np.asarray(jout.t), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(_np(tout.q), np.asarray(jout.q), atol=POSE_TOL, rtol=0)
    # it moved: the refinement ran, not only the "too small a map" exit
    assert np.linalg.norm(np.asarray(jout.t) - t0) > 1e-3


def test_loam_pipeline_matches_over_a_few_sweeps():
    """Both packages' ``LoamPipeline`` in float64 on the CPU over 4 sweeps
    (scan-to-map on sweeps 2 and 4: the first maps at the chained pose, the
    second refines); laser poses within 1e-5, and the map stores."""
    jcfg = loam_cfg()
    cfg = port_cfg(jcfg)
    traj = JSYN.Trajectory()
    pj = JLoam(jcfg, dtype=jnp.float64)
    pt = TLoam(cfg, device="cpu", dtype=F64)
    for i in range(4):
        xyz, mask = JSYN.simulate_sweep(traj, 0.1 * i, n_azimuth=360)
        oj = pj.process(xyz, mask)
        ot = pt.process(xyz, mask)
        assert ot["stage"] == oj["stage"] == "LOAM"
        for key in ("laser_pose", "odom_pose"):
            np.testing.assert_allclose(_np(ot[key].t), np.asarray(oj[key].t), atol=POSE_TOL,
                                       rtol=0, err_msg=f"sweep {i} {key}")
            np.testing.assert_allclose(_np(ot[key].q), np.asarray(oj[key].q), atol=POSE_TOL,
                                       rtol=0, err_msg=f"sweep {i} {key}")
    assert pt.frame_count == pj.frame_count == 4
    np.testing.assert_array_equal(_np(pt.map_state.surf_map.mask),
                                  np.asarray(pj.map_state.surf_map.mask))
    assert bool(pt.map_state.initialized)
