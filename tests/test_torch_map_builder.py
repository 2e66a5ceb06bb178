"""The port's 4D map builder (``models/map_builder.py``) against the
reference's, and ``run --enable-4d --out-4d`` through the port's CLI.

* ``transform_4d_associate`` on the scene of
  tests/test_map_builder.py::TestTransform4DAssociate, float64: 1e-12.
* ``map_builder_step`` over the first sweeps of the reference's closed-loop
  scene (a box room's features seen from a slow trajectory, the odometry
  drifting in yaw and x), both packages in float64: poses within 1e-5 (a
  GN on 5-NN fits, summed in another order), map store masks equal.
* ``--two-phase`` with ``--enable-4d --out-4d`` on the CPU: phase B gets
  both flags, the builder starts on the first sweep after init (phase B's
  first), and the 4D file holds phase B's poses: the single-process run's
  stamps but the first, the first pose equal to the LIO pose (an empty
  map keeps the predicted pose).
"""

import copy
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from lio_mapping_tpu.models import map_builder as JMB
from lio_mapping_tpu.models import mapping as JM
from lio_mapping_tpu.ops.cloud import Cloud as JCloud
from lio_mapping_tpu.utils.se3 import Pose as JPose
from lio_mapping_tpu_torch import cli as TCLI
from lio_mapping_tpu_torch.io.evaluation import load_tum
from lio_mapping_tpu_torch.models import map_builder as TMB
from lio_mapping_tpu_torch.models import mapping as TM
from lio_mapping_tpu_torch.ops.cloud import Cloud as TCloud
from lio_mapping_tpu_torch.utils.se3 import Pose as TPose

from tests.test_cli_e2e import SMALL_PROFILE
from tests.test_map_builder import make_world_features, small_cfg
from tests.test_torch_pipeline import port_cfg

F64 = torch.float64
POSE_TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _quat(rot):
    return np.roll(rot.as_quat(), 1)


def _poses(q, t):
    return (JPose(jnp.asarray(q, jnp.float64), jnp.asarray(t, jnp.float64)),
            TPose(torch.as_tensor(np.asarray(q, np.float64)),
                  torch.as_tensor(np.asarray(t, np.float64))))


def test_transform_4d_associate_matches():
    r_prev = Rotation.from_euler("ZYX", [0.3, 0.02, -0.01])
    r_odom = Rotation.from_euler("ZYX", [0.42, 0.06, 0.03])
    pose = (_quat(Rotation.from_euler("ZYX", [0.1, 0, 0]) * r_prev), [1.0, 2.0, 0.5])
    pose_bef = (_quat(r_prev), [0.9, 1.9, 0.5])
    jp, tp = _poses(*pose)
    jb, tb = _poses(*pose_bef)
    jo, to = _poses(_quat(r_odom), [1.2, 2.2, 0.6])
    jst = JM.MappingState(JM.VoxelMapStore.empty(64, jnp.float64),
                          JM.VoxelMapStore.empty(64, jnp.float64), jp, jb, jnp.asarray(True))
    tst = TM.MappingState(TM.VoxelMapStore.empty(64, F64), TM.VoxelMapStore.empty(64, F64),
                          tp, tb, torch.tensor(True))
    want = JMB.transform_4d_associate(jst, jo)
    got = TMB.transform_4d_associate(tst, to)
    np.testing.assert_allclose(_np(got.q), np.asarray(want.q), atol=1e-12, rtol=0)
    np.testing.assert_allclose(_np(got.t), np.asarray(want.t), atol=1e-12, rtol=0)
    # roll and pitch are the odometry's, yaw moved by the chain's 0.1 rad
    ypr = Rotation.from_quat(np.roll(_np(got.q), -1)).as_euler("ZYX")
    np.testing.assert_allclose(ypr[1:], r_odom.as_euler("ZYX")[1:], atol=1e-9)
    assert abs(ypr[0] - r_odom.as_euler("ZYX")[0] - 0.1) < 0.01


def _body_cloud(world, q, t, rng, cap):
    """World features -> a padded body-frame cloud at pose (q, t), 1 cm
    jitter (tests/test_map_builder.py::body_cloud), as numpy arrays."""
    pts = world + rng.normal(0, 0.01, world.shape)
    body = Rotation.from_quat(np.roll(q, -1)).inv().apply(pts - t)
    xyz = np.zeros((cap, 3))
    mask = np.zeros(cap, bool)
    n = min(len(body), cap)
    xyz[:n], mask[:n] = body[:n], True
    return xyz, mask


def _clouds(xyz, mask):
    z = np.zeros(len(mask))
    return (JCloud(jnp.asarray(xyz), jnp.asarray(z), jnp.asarray(z, jnp.int32),
                   jnp.asarray(mask)),
            TCloud(torch.as_tensor(xyz), torch.as_tensor(z), torch.zeros(len(mask),
                                                                          dtype=torch.int32),
                   torch.as_tensor(mask)))


def test_map_builder_steps_match():
    base = small_cfg()  # narrower still: the plain searches on the CPU dominate
    jcfg = dataclasses.replace(
        base, mapping=dataclasses.replace(base.mapping, map_cloud_cap=4096),
        estimator=dataclasses.replace(base.estimator, corner_stack_cap=256, surf_stack_cap=1024))
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(1)
    surf_w, corner_w = (a.astype(np.float64) for a in make_world_features(rng))
    jst = JM.init_state(jcfg, jnp.float64)
    tst = TM.init_state(cfg, F64, "cpu")
    moved = 0.0
    for k in range(4):
        yaw = 0.25 * np.sin(0.15 * k)
        rot = Rotation.from_euler("ZYX", [yaw, 0.05 * np.sin(0.2 * k), 0.04 * np.cos(0.2 * k)])
        p = np.array([1.5 * np.sin(0.1 * k), 1.2 * np.cos(0.1 * k) - 1.2,
                      1.0 + 0.1 * np.sin(0.3 * k)])
        q = _quat(rot)
        jc, tc = _clouds(*_body_cloud(corner_w, q, p, rng, jcfg.estimator.corner_stack_cap))
        js, ts = _clouds(*_body_cloud(surf_w, q, p, rng, jcfg.estimator.surf_stack_cap))
        drift = Rotation.from_euler("ZYX", [0.004 * k, 0, 0])
        jo, to = _poses(_quat(drift * rot), drift.apply(p) + [0.008 * k, 0.0, 0.0])
        jst, jout = JMB.map_builder_step(jst, jc, js, jo, jcfg)
        tst, tout = TMB.map_builder_step(tst, tc, ts, to, cfg)
        for key in ("q", "t"):
            np.testing.assert_allclose(_np(getattr(tout["pose"], key)),
                                       np.asarray(getattr(jout["pose"], key)), atol=POSE_TOL,
                                       rtol=0, err_msg=f"sweep {k} {key}")
        moved = max(moved, float(np.linalg.norm(_np(tout["pose"].t) - _np(to.t))))
        for name in ("corner_map", "surf_map"):
            np.testing.assert_array_equal(_np(getattr(tst, name).mask),
                                          np.asarray(getattr(jst, name).mask))
    assert moved > 1e-3  # the refinement ran, not only the first, unrefined step
    assert bool(tst.initialized)


@pytest.fixture(scope="module")
def seq4d(tmp_path_factory):
    """A short log and a small profile for the builder on the CPU: the
    CLI tests' one (every-sweep cadence, narrow feature capacities) with
    narrow map stores and corner stacks."""
    d = tmp_path_factory.mktemp("cli4d")
    log = str(d / "seq.liol")
    assert TCLI.main(["simulate", "--out", log, "--sweeps", "10", "--azimuth", "300"]) == 0
    prof = copy.deepcopy(SMALL_PROFILE)
    prof["estimator"].update(odom_io=1, corner_stack_cap=512)
    prof["feature"] = {"corner_sharp_cap": 128, "corner_less_sharp_cap": 1024,
                       "surf_flat_cap": 256, "surf_less_flat_cap": 2048}
    prof["mapping"] = {"map_cloud_cap": 8192}
    with open(d / "small4d.yaml", "w") as f:
        yaml.safe_dump(prof, f)
    return d, log, str(d / "small4d.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_two_phase_hands_the_4d_flags_to_phase_b(seq4d, capfd):
    d, log, prof = seq4d
    base = ["run", "--log", log, "--config", prof, "--device", "cpu"]
    assert TCLI.main(base + ["--out", str(d / "sp.tum"), "--enable-4d",
                             "--out-4d", str(d / "sp4.tum")]) == 0
    assert "4D-refined poses" in capfd.readouterr().out
    assert TCLI.main(base + ["--out", str(d / "tp.tum"), "--enable-4d",
                             "--out-4d", str(d / "tp4.tum"), "--two-phase"]) == 0
    out = capfd.readouterr().out
    t_sp, q_sp, p_sp = load_tum(d / "sp.tum")
    t_tp, _, p_tp = load_tum(d / "tp.tum")
    np.testing.assert_allclose(p_tp, p_sp, atol=1e-4)
    t4, q4, p4 = load_tum(d / "sp4.tum")
    tb4, qb4, pb4 = load_tum(d / "tp4.tum")
    # single process: one 4D pose per INITED sweep, from the init sweep on
    assert len(t4) >= 3
    np.testing.assert_allclose(t4, t_sp[-len(t4):], atol=1e-9)
    # phase B: the same stamps but the init sweep's, and it wrote them
    assert f"wrote {len(tb4)} 4D-refined poses" in out
    np.testing.assert_allclose(tb4, t4[1:], atol=1e-9)
    i = len(t_sp) - len(tb4)
    np.testing.assert_allclose(pb4[0], p_sp[i], atol=1e-4)
    assert np.abs(np.sum(qb4[0] * q_sp[i])) > 1 - 1e-6
    assert np.all(np.isfinite(pb4)) and np.max(np.abs(pb4 - p_sp[i:])) < 0.5
