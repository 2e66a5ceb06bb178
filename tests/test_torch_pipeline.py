"""The slice as a whole: the port's estimator step and ``LioPipeline``
against the reference package, started from the same state.

(a) One INITED step: the reference's ``synthetic_estimator_state`` on the
    small closed-loop config (``tests/test_lio_pipeline.small_cfg``,
    identity extrinsic) is carried over through the checkpoint bridge, and
    both packages run one ``lio_step_impl`` in float64 on the same sweep and
    IMU. Body pose, velocity and biases agree within 1e-6 (a 15S+6 LM solve
    and an eigendecomposed prior, summed in different orders), every KNN
    call returns the same neighbour sets, and the mini-GN and LM iteration
    counts are equal.
(b) Cold start: both pipelines (float64, CPU) on the same short sequence
    (``small_cfg`` with narrower feature capacities) reach INITED on the
    same sweep with laser poses within 1e-5 m; one INITED step follows.

The checkpoint bridge is held both ways: the reference's ``save`` loads
into the port and continues as the reference does, and the port's ``save``
loads into the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.io import checkpoint as JCK
from lio_mapping_tpu.io import synthetic as JSYN
from lio_mapping_tpu.models import estimator as JE
from lio_mapping_tpu.models import point_processor as JPP
from lio_mapping_tpu.models.pipeline import LioPipeline as JPipe
from lio_mapping_tpu.ops import knn as JK
from lio_mapping_tpu.ops import preintegration as JPI
from lio_mapping_tpu_torch import config as TCFG
from lio_mapping_tpu_torch.io import checkpoint as TCK
from lio_mapping_tpu_torch.io import synthetic as TSYN
from lio_mapping_tpu_torch.models import estimator as TE
from lio_mapping_tpu_torch.models import point_processor as TPP
from lio_mapping_tpu_torch.models.pipeline import LioPipeline as TPipe
from lio_mapping_tpu_torch.ops import knn as TK
from lio_mapping_tpu_torch.ops import preintegration as TPI
from lio_mapping_tpu_torch.utils.tree import tree_leaves

from tests.test_lio_pipeline import small_cfg

F64 = torch.float64
STATE_TOL = 1e-6   # body pose, velocity, biases after one step
POSE_TOL = 1e-5    # laser poses along the cold start (m, and quaternion)
N_COLD = 7         # INITED at sweep 5 on this config, then one INITED step


def port_cfg(j):
    """The port's config with the same field values as a reference config."""
    kw = {f.name: (port_cfg(getattr(j, f.name)) if dataclasses.is_dataclass(getattr(j, f.name))
                   else getattr(j, f.name)) for f in dataclasses.fields(j)}
    return getattr(TCFG, type(j).__name__)(**kw)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _sweep_and_imu(traj, t0, dt, n_azimuth=540):
    """Sweep over (t0, t0+dt] and its IMU interval, as
    tests/test_lio_pipeline.py pairs them."""
    xyz, mask = JSYN.simulate_sweep(traj, t0, n_azimuth=n_azimuth)
    ts, acc, gyr = JSYN.simulate_imu_interval(traj, t0, t0 + dt, 200.0)
    a0, w0 = traj.imu(t0)
    dts = np.diff(np.concatenate([[t0], ts]))
    return xyz, mask, (dts, acc, gyr, a0, w0)


def _record_knn(monkeypatch):
    """Record every 5-NN search of both packages' estimators: (reference
    calls, port calls), each a list of (sq_d, idx) numpy pairs."""
    calls_j, calls_t = [], []
    orig_j, orig_t = JK.knn, TK.knn

    def rec_j(*args, **kw):
        d, i = orig_j(*args, **kw)
        jax.debug.callback(lambda a, b: calls_j.append((np.asarray(a), np.asarray(b))),
                           d, i, ordered=True)
        return d, i

    def rec_t(*args, **kw):
        d, i = orig_t(*args, **kw)
        calls_t.append((_np(d), _np(i)))
        return d, i

    monkeypatch.setattr(JK, "knn", rec_j)
    monkeypatch.setattr(TK, "knn", rec_t)
    return calls_j, calls_t


def test_config_carries_over():
    j = small_cfg()
    assert dataclasses.asdict(port_cfg(j)) == dataclasses.asdict(j)


def test_one_inited_step_matches(monkeypatch):
    jcfg = small_cfg()
    cfg = port_cfg(jcfg)
    traj = JSYN.Trajectory(g_norm=jcfg.estimator.imu.g_norm)
    jst, t_next = JSYN.synthetic_estimator_state(jcfg, traj, dtype=jnp.float64)

    # the bridge: the reference state's leaves, in jax.tree.flatten order
    template = TE.init_state(cfg, F64, "cpu")
    tst = TCK.state_from_numpy_leaves(template, [np.asarray(x) for x in jax.tree.leaves(jst)])
    # the port's own copy of synthetic_estimator_state builds the same state
    own, own_next = TSYN.synthetic_estimator_state(cfg, TSYN.Trajectory(g_norm=traj.g_norm),
                                                   dtype=F64)
    assert own_next == t_next
    for a, b in zip(tree_leaves(own), tree_leaves(tst)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-12, rtol=0)

    dt = cfg.sensor.scan_period
    xyz, mask, imu = _sweep_and_imu(traj, t_next - dt, dt)
    m = cfg.estimator.imu.max_imu_per_frame
    packed = JPI.pack_samples_np(*imu, m)
    np.testing.assert_array_equal(packed, TPI.pack_samples_np(*imu, m))
    packed = packed.astype(np.float64)  # as LioPipeline casts it to the state's type
    jfeat = JPP.process_sweep(jnp.asarray(xyz), jnp.asarray(mask), jcfg, None, None)
    tfeat = TPP.process_sweep(torch.as_tensor(xyz), torch.as_tensor(mask), cfg, None, None)

    calls_j, calls_t = _record_knn(monkeypatch)
    step = jax.jit(JE.lio_step_impl, static_argnames=("cfg",))
    jst2, jout = step(jst, jfeat.surf_less_flat, JPI.unpack_samples(jnp.asarray(packed)), jcfg)
    jax.effects_barrier()
    tst2, tout = TE.lio_step_impl(tst, tfeat.surf_less_flat,
                                  TPI.unpack_samples(torch.as_tensor(packed)), cfg)

    assert int(tout["solver_iterations"]) == int(jout["solver_iterations"])
    assert int(tout["newest_rounds"]) == int(jout["newest_rounds"])
    assert int(tout["n_features"]) == int(jout["n_features"])
    for key in ("velocity", "ba", "bg"):
        np.testing.assert_allclose(_np(tout[key]), np.asarray(jout[key]), atol=STATE_TOL,
                                   rtol=0, err_msg=key)
    for key in ("q", "t"):
        np.testing.assert_allclose(_np(getattr(tout["body_pose"], key)),
                                   np.asarray(getattr(jout["body_pose"], key)),
                                   atol=STATE_TOL, rtol=0, err_msg=key)
    for name in ("qs", "ps", "vs", "bas", "bgs"):
        np.testing.assert_allclose(_np(getattr(tst2, name)), np.asarray(getattr(jst2, name)),
                                   atol=STATE_TOL, rtol=0, err_msg=name)

    # the same searches, and the same neighbour set in every matched row
    w, pivot = cfg.estimator.window_size, cfg.estimator.pivot_idx
    assert len(calls_t) == len(calls_j) == (w - pivot - 1) + int(tout["newest_rounds"])
    for (td, ti), (jd, ji) in zip(calls_t, calls_j):
        rows = np.isfinite(jd[:, 4])
        assert rows.any()
        np.testing.assert_array_equal(np.isfinite(td[:, 4]), rows)
        np.testing.assert_array_equal(np.sort(ti[rows], axis=1), np.sort(ji[rows], axis=1))
        # the mini-GN moves the queries with poses that agree to ~1e-8
        np.testing.assert_allclose(td[rows], jd[rows], atol=STATE_TOL, rtol=0)


def cold_cfg():
    """``small_cfg`` with narrower feature capacities: the reference's
    scan-to-scan odometry searches them some 25 times a sweep, which on the
    CPU takes ~10 s a sweep at the default widths and ~0.5 s at these."""
    base = small_cfg()
    feat = dataclasses.replace(base.feature, corner_sharp_cap=128, corner_less_sharp_cap=1024,
                               surf_flat_cap=256, surf_less_flat_cap=2048)
    return dataclasses.replace(base, feature=feat)


@pytest.fixture(scope="module")
def cold_start():
    """Both pipelines over the first N_COLD sweeps of the cold-start
    sequence; returns (reference pipe, port pipe, outputs, traj, cfgs)."""
    jcfg = cold_cfg()
    cfg = port_cfg(jcfg)
    traj = JSYN.Trajectory(g_norm=jcfg.estimator.imu.g_norm)
    pj = JPipe(jcfg, dtype=jnp.float64)
    pt = TPipe(cfg, device="cpu", dtype=F64)
    dt = cfg.sensor.scan_period
    outs = []
    for i in range(N_COLD):
        xyz, mask, imu = _sweep_and_imu(traj, i * dt, dt)
        oj = pj.process(xyz, mask, pj.make_samples(*imu))
        ot = pt.process(xyz, mask, pt.make_samples(*imu))
        outs.append((oj, ot))
    return pj, pt, outs, traj, (jcfg, cfg)


def _pose_close(ot, oj, tol=POSE_TOL, msg=""):
    np.testing.assert_allclose(_np(ot["laser_pose"].t), np.asarray(oj["laser_pose"].t),
                               atol=tol, rtol=0, err_msg=msg)
    np.testing.assert_allclose(_np(ot["laser_pose"].q), np.asarray(oj["laser_pose"].q),
                               atol=tol, rtol=0, err_msg=msg)


def test_cold_start_reaches_inited_on_the_same_sweep(cold_start):
    pj, pt, outs, _, _ = cold_start
    stages = [(oj["stage"], ot["stage"]) for oj, ot in outs]
    assert all(a == b for a, b in stages), stages
    first = [s for s, _ in stages].index("INITED")
    assert first < N_COLD - 1, stages
    assert pt.stage == pj.stage == "INITED"
    for i, (oj, ot) in enumerate(outs):
        _pose_close(ot, oj, msg=f"sweep {i}")
    # the last sweep ran the INITED estimator step in both
    oj, ot = outs[-1]
    assert "body_pose" in ot and "body_pose" in oj
    assert int(ot["solver_iterations"]) == int(oj["solver_iterations"])
    assert int(ot["newest_rounds"]) == int(oj["newest_rounds"])


def test_checkpoint_bridge_both_ways(cold_start, tmp_path):
    pj, pt, _, traj, (jcfg, cfg) = cold_start

    # reference save -> port load: every leaf equal, then both continue alike
    ref_path = str(tmp_path / "ref.npz")
    pj.save(ref_path)
    resumed = TPipe(cfg, device="cpu", dtype=F64)
    resumed.load(ref_path)
    assert (resumed.stage, resumed.frame_count) == (pj.stage, pj.frame_count)
    for a, b in zip(tree_leaves((resumed.est_state, resumed.odom_state)),
                    jax.tree.leaves((pj.est_state, pj.odom_state))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    dt = cfg.sensor.scan_period
    xyz, mask, imu = _sweep_and_imu(traj, N_COLD * dt, dt)
    oj = pj.process(xyz, mask, pj.make_samples(*imu))
    ot = resumed.process(xyz, mask, resumed.make_samples(*imu))
    assert ot["stage"] == oj["stage"] == "INITED"
    _pose_close(ot, oj)

    # port save -> reference load
    port_path = str(tmp_path / "port.npz")
    resumed.save(port_path)
    back = JCK.load_state(port_path, est=pj.est_state, odom=pj.odom_state)
    for a, b in zip(tree_leaves((resumed.est_state, resumed.odom_state)),
                    jax.tree.leaves((back["est"], back["odom"]))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    with np.load(port_path) as raw:
        assert list(raw["meta.0"]) == [1, resumed.frame_count, resumed._compact_count]


def test_pipeline_runs_on_the_card_unless_told_otherwise():
    cfg = port_cfg(small_cfg())
    if torch.cuda.is_available():
        assert TPipe(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TPipe(cfg)
    assert TPipe(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("flag", ["use_corner", "fix_map", "cutoff_deskew"])
def test_unported_variants_raise(flag):
    cfg = port_cfg(small_cfg())
    cfg = dataclasses.replace(cfg, estimator=dataclasses.replace(cfg.estimator, **{flag: True}))
    with pytest.raises(NotImplementedError, match=flag):
        TPipe(cfg, device="cpu")


def test_unported_entry_points_raise():
    from lio_mapping_tpu_torch.models.pipeline import LoamPipeline

    with pytest.raises(NotImplementedError):
        LoamPipeline(port_cfg(small_cfg()))
    with pytest.raises(NotImplementedError):
        TPI.integrate_euler(None, None, None, None)
