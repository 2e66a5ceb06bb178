"""The port's L0 math, copied host modules and import hygiene, held against
the reference package (lio_mapping_tpu) on identical numpy inputs.

Tolerance: 1e-12 in float64 — the formulas are the same, so only
transcendental-function and summation-order rounding separate the two
frameworks. One float32 case per function family at 1e-5.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu import config as JCFG
from lio_mapping_tpu.io import evaluation as JEV
from lio_mapping_tpu.io import synthetic as JSYN
from lio_mapping_tpu.utils import quaternion as jq
from lio_mapping_tpu.utils import se3 as jse3
from lio_mapping_tpu.utils import so3 as jso3
from lio_mapping_tpu_torch import config as TCFG
from lio_mapping_tpu_torch.io import evaluation as TEV
from lio_mapping_tpu_torch.io import synthetic as TSYN
from lio_mapping_tpu_torch.utils import quaternion as tq
from lio_mapping_tpu_torch.utils import se3 as tse3
from lio_mapping_tpu_torch.utils import so3 as tso3

TOL64 = 1e-12
TOL32 = 1e-5


def _both(x, dtype):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.as_tensor(x)


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


def _quats(rng, n, dtype=np.float64):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(dtype)


UNARY_Q = ["normalize", "conjugate", "inverse", "to_matrix", "log", "left_matrix",
           "right_matrix"]


@pytest.mark.parametrize("dtype,tol", [(np.float64, TOL64), (np.float32, TOL32)],
                         ids=["f64", "f32"])
class TestQuaternion:
    @pytest.mark.parametrize("name", UNARY_Q)
    def test_unary(self, rng, dtype, tol, name):
        jx, tx = _both(_quats(rng, 33, dtype) * 1.3, dtype)
        _close(getattr(tq, name)(tx), getattr(jq, name)(jx), tol)

    def test_binary(self, rng, dtype, tol):
        (ja, ta), (jb, tb) = _both(_quats(rng, 17, dtype), dtype), _both(_quats(rng, 17, dtype), dtype)
        jv, tv = _both(rng.normal(size=(17, 3)), dtype)
        _close(tq.qmul(ta, tb), jq.qmul(ja, jb), tol)
        _close(tq.rotate(ta, tv), jq.rotate(ja, jv), tol)
        _close(tq.angular_distance(ta, tb), jq.angular_distance(ja, jb), tol * 10)
        js, ts = _both(rng.uniform(0, 1, 17), dtype)
        _close(tq.slerp(ta, tb, ts), jq.slerp(ja, jb, js), tol)

    def test_vector_maps(self, rng, dtype, tol):
        phi = rng.normal(size=(25, 3))
        phi[0] = 0.0
        phi[1] = 1e-9
        jp, tp = _both(phi, dtype)
        for name in ("exp", "delta_q", "skew"):
            _close(getattr(tq, name)(tp), getattr(jq, name)(jp), tol)
        for name in ("exp_matrix", "right_jacobian", "right_jacobian_inverse",
                     "left_jacobian"):
            _close(getattr(tso3, name)(tp), getattr(jso3, name)(jp), tol * 10)

    def test_matrix_maps(self, rng, dtype, tol):
        jx, tx = _both(_quats(rng, 40, dtype), dtype)
        m = jq.to_matrix(jx)
        tm = torch.as_tensor(np.array(m))
        _close(tq.from_matrix(tm), jq.from_matrix(m), tol)
        _close(tso3.log_matrix(tm), jso3.log_matrix(m), tol * 100)
        ypr = rng.uniform(-170, 170, size=(40, 3)).astype(dtype)
        ypr[:, 1] = np.clip(ypr[:, 1], -80, 80)
        _close(tq.ypr_to_rot(torch.as_tensor(ypr)), jq.ypr_to_rot(jnp.asarray(ypr)), tol)
        _close(tq.rot_to_ypr(tm), jq.rot_to_ypr(m), tol * 1e3)
        ax, an = tq.to_axis_angle(tx)
        jax_, jan = jq.to_axis_angle(jx)
        _close(ax, jax_, tol * 10)
        _close(an, jan, tol * 10)


class TestPose:
    def test_compose_inverse_apply(self, rng):
        (jqa, tqa), (jqb, tqb) = _both(_quats(rng, 9), np.float64), _both(_quats(rng, 9), np.float64)
        (jta, tta), (jtb, ttb) = _both(rng.normal(size=(9, 3)), np.float64), \
            _both(rng.normal(size=(9, 3)), np.float64)
        jp = jse3.Pose(jqa, jta) @ jse3.Pose(jqb, jtb).inverse()
        tp = tse3.Pose(tqa, tta) @ tse3.Pose(tqb, ttb).inverse()
        _close(tp.q, jp.q, TOL64)
        _close(tp.t, jp.t, TOL64)
        jpts, tpts = _both(rng.normal(size=(9, 5, 3)), np.float64)
        _close(tp.apply(tpts), jp.apply(jpts), TOL64)
        _close(tp.matrix(), jp.matrix(), TOL64)
        _close(tp.normalized().q, jp.normalized().q, TOL64)
        dr_t, dt_t = tse3.pose_distance(tp, tse3.Pose(tqa, tta))
        dr_j, dt_j = jse3.pose_distance(jp, jse3.Pose(jqa, jta))
        _close(dr_t, dr_j, 1e-10)
        _close(dt_t, dt_j, TOL64)


class TestCopiedHostModules:
    @pytest.mark.parametrize("profile", ["indoor", "outdoor", "outdoor_64"])
    def test_config_profiles_equal(self, profile):
        t = getattr(TCFG.LioConfig, profile)()
        j = getattr(JCFG.LioConfig, profile)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        tq_lb, tt_lb = t.extrinsic_lb()
        jq_lb, jt_lb = j.extrinsic_lb()
        _close(tq_lb, jq_lb, TOL64)
        _close(tt_lb, jt_lb, TOL64)

    @pytest.mark.parametrize("profile", ["indoor", "outdoor_64", "rs32"])
    def test_yaml_profiles_load_as_the_reference(self, tmp_path, profile):
        """``load_yaml`` gives the reference's config on the shipped
        profiles and on the RS-32 sensor block (written as JSON, a subset of
        YAML, as ``chip_smoke.py`` writes it)."""
        import json
        import os

        if profile == "rs32":
            path = tmp_path / "rs32.yaml"
            path.write_text(json.dumps({"sensor": {
                "n_rings": 32, "lower_bound_deg": -25.0, "upper_bound_deg": 15.0,
                "max_points_per_ring": 2304, "uneven": True}}))
        else:
            path = os.path.join(os.path.dirname(__file__), "..", "configs", f"{profile}.yaml")
        t, j = TCFG.load_yaml(str(path)), JCFG.load_yaml(str(path))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        if profile == "rs32":
            assert t.sensor == TCFG.SensorConfig.rs32_uneven()
            assert t.estimator == TCFG.LioConfig().estimator

    def test_synthetic_sweep_and_imu_equal(self):
        kw = dict(pitch_amp=0.4, roll_amp=0.35, rp_freq=0.45)
        tt, jt = TSYN.Trajectory(**kw), JSYN.Trajectory(**kw)
        ext = (np.array([0.99, 0.1, 0.0, 0.0]) / np.linalg.norm([0.99, 0.1, 0.0, 0.0]),
               np.array([0.05, 0.0, -0.08]))
        for t0 in (0.0, 0.35):
            xa, ma = TSYN.simulate_sweep(tt, t0, n_azimuth=180, extrinsic_lb=ext)
            xb, mb = JSYN.simulate_sweep(jt, t0, n_azimuth=180, extrinsic_lb=ext)
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ma, mb)
            for a, b in zip(TSYN.simulate_imu_interval(tt, t0, t0 + 0.1),
                            JSYN.simulate_imu_interval(jt, t0, t0 + 0.1)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(TSYN.gt_sensor_pose(tt, t0, ext), JSYN.gt_sensor_pose(jt, t0, ext)):
                np.testing.assert_array_equal(a, b)
        rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
        xa, _ = TSYN.simulate_sweep(tt, 0.2, n_azimuth=90, noise_std=0.02, rng=rng_a,
                                    room=TSYN.corridor_world()[0])
        xb, _ = JSYN.simulate_sweep(jt, 0.2, n_azimuth=90, noise_std=0.02, rng=rng_b,
                                    room=JSYN.corridor_world()[0])
        np.testing.assert_array_equal(xa, xb)

    def test_evaluation_equal(self, rng):
        n = 40
        gt_q, gt_t = _quats(rng, n), np.cumsum(rng.normal(size=(n, 3)), axis=0)
        est_q = _quats(rng, n)
        est_t = gt_t + rng.normal(scale=0.05, size=(n, 3))
        a = TEV.evaluate_trajectory(est_q, est_t, gt_q, gt_t, rpe_delta=2)
        b = JEV.evaluate_trajectory(est_q, est_t, gt_q, gt_t, rpe_delta=2)
        assert a == b
        t_est = np.arange(n) * 0.1 + rng.normal(scale=0.003, size=n)
        t_gt = np.arange(n + 3) * 0.1
        for x, y in zip(TEV.associate_by_time(t_est, t_gt), JEV.associate_by_time(t_est, t_gt)):
            np.testing.assert_array_equal(x, y)


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port imports without jax or lio_mapping_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lio_mapping_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'lio_mapping_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'lio_mapping_tpu' or m.startswith('lio_mapping_tpu.'))\n"
        "assert len(names) >= 25, names\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_port_runs_with_jax_and_reference_blocked(tmp_path):
    """With ``jax`` and ``lio_mapping_tpu`` made unimportable, every module
    of the port (``io/rosbag`` and ``io/viz`` by name) imports, and the CLI
    commands that import lazily inside their bodies run: simulate,
    export-bag, bag-info, convert-bag, viz-normals on the CPU, evaluate."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lio_mapping_tpu'] = None\n"
        "import lio_mapping_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'lio_mapping_tpu_torch.')]\n"
        "assert {'lio_mapping_tpu_torch.io.rosbag', 'lio_mapping_tpu_torch.io.viz'} <= set(names)\n"
        "for n in names: importlib.import_module(n)\n"
        "from lio_mapping_tpu_torch.cli import main\n"
        "d = sys.argv[1]\n"
        "for args in (['simulate', '--out', d + '/s.liol', '--sweeps', '3', '--azimuth', '120',\n"
        "              '--gt-out', d + '/gt.tum'],\n"
        "             ['export-bag', '--log', d + '/s.liol', '--out', d + '/s.bag'],\n"
        "             ['bag-info', '--bag', d + '/s.bag'],\n"
        "             ['convert-bag', '--bag', d + '/s.bag', '--out', d + '/c.liol'],\n"
        "             ['viz-normals', '--log', d + '/c.liol', '--traj', d + '/gt.tum',\n"
        "              '--out', d + '/n.ply', '--frames', '2', '--device', 'cpu'],\n"
        "             ['evaluate', '--est', d + '/gt.tum', '--gt', d + '/gt.tum']):\n"
        "    assert main(args) == 0, args\n"
        "print('IMPORTED', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORTED" in out.stdout and "features with normals" in out.stdout


def test_chip_smoke_and_tools_import_neither_jax_nor_reference():
    """The port's scripts run where JAX is absent: no import of ``jax`` or
    ``lio_mapping_tpu`` anywhere in their source."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for rel in ("chip_smoke.py", "tools/knn_ab.py"):
        tree = ast.parse((root / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module and not n.level]
        assert any(m.startswith("lio_mapping_tpu_torch") for m in names), rel
        bad = [m for m in names if m.split(".")[0] in ("jax", "lio_mapping_tpu")]
        assert not bad, (rel, bad)


def test_stage_timer_and_device_trace(tmp_path):
    """``StageTimer`` aggregates and reports as the reference's does on the
    same records; ``device_trace`` writes a Chrome trace, and nothing
    without a directory."""
    import json

    from lio_mapping_tpu.utils import timing as JT
    from lio_mapping_tpu_torch.utils import timing as TT

    recs = {"pipeline": [12.5, 30.25, 7.0], "global_map": [0.5], "flush": [3.0, 1.0]}
    tt, jt = TT.StageTimer(), JT.StageTimer()
    tt.records = {k: list(v) for k, v in recs.items()}
    jt.records = {k: list(v) for k, v in recs.items()}
    assert tt.summary() == jt.summary()
    assert tt.report() == jt.report()
    with tt.stage("cpu"):
        pass
    assert tt.summary()["cpu"]["count"] == 1
    off = TT.StageTimer(enabled=False)
    with off.stage("x"):
        pass
    assert off.records == {}

    with TT.device_trace(None):
        torch.ones(3).sum()
    assert not list(tmp_path.iterdir())
    with TT.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
