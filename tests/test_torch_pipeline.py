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
from lio_mapping_tpu_torch.utils.se3 import Pose as TPose
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


def test_mesh_options_without_a_mesh_are_ignored():
    """As in the reference, ``map_shard`` and ``ingest_shard`` mean nothing
    without a mesh, and ``host_predict`` stays as asked."""
    cfg = port_cfg(small_cfg())
    pipe = TPipe(cfg, device="cpu", map_shard=True, ingest_shard=True, host_predict=True)
    assert pipe.mesh is None and not pipe.map_shard and not pipe.ingest_shard
    assert pipe.host_predict


def test_prefetched_cloud_gives_the_same_sweep():
    """A cloud handed over through ``prefetch_cloud`` gives the same poses
    and clouds, bit for bit, as one handed over as (xyz, mask)."""
    cfg = port_cfg(cold_cfg())
    traj = JSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    plain = TPipe(cfg, device="cpu", dtype=F64)
    pref = TPipe(cfg, device="cpu", dtype=F64)
    dt = cfg.sensor.scan_period
    for i in range(3):
        xyz, mask, imu = _sweep_and_imu(traj, i * dt, dt)
        assert pref.will_consume()
        pf = pref.prefetch_cloud(xyz, mask)
        assert pf.xyzw.dtype == F64 and pf.xyzw.shape == (len(xyz), 4)
        a = plain.process(xyz, mask, plain.make_samples(*imu))
        b = pref.process(pf, None, pref.make_samples(*imu))
        for key in ("laser_pose",):
            np.testing.assert_array_equal(_np(a[key].t), _np(b[key].t))
            np.testing.assert_array_equal(_np(a[key].q), _np(b[key].q))
        np.testing.assert_array_equal(_np(a["surf_cloud"].xyz), _np(b["surf_cloud"].xyz))


def test_host_predict_pose(cold_start):
    """The numpy prediction of a skipped sweep's pose: the reference's own
    numpy mirror on the same snapshot gives the same bits, and the port's
    device prediction (float64) agrees within 1e-6."""
    _, pt, _, traj, (_, cfg) = cold_start
    w = cfg.estimator.window_size
    st = pt.est_state
    snap = {"q": st.qs[w], "p": st.ps[w], "v": st.vs[w], "ba": st.bas[w], "bg": st.bgs[w],
            "ex_q": st.q_lb, "ex_p": st.t_lb, "g": st.g_vec}
    dt = cfg.sensor.scan_period
    _, _, imu = _sweep_and_imu(traj, N_COLD * dt, dt)
    packed = pt.make_samples(*imu)
    got = TPipe._host_predict_pose(snap, packed)
    want = JPipe._host_predict_pose({k: _np(v) for k, v in snap.items()}, packed)
    np.testing.assert_array_equal(got.t, np.asarray(want.t))
    np.testing.assert_array_equal(got.q, np.asarray(want.q))
    dev = pt._predict(packed)
    np.testing.assert_allclose(got.t, _np(dev.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.abs(np.sum(got.q * _np(dev.q))), 1.0, atol=1e-6)
    # the snapshot the pipeline keeps when host_predict is on
    pt.host_predict = True
    try:
        pt._update_snap({"body_pose": TPose(st.qs[w], st.ps[w]), "velocity": st.vs[w],
                         "ba": st.bas[w], "bg": st.bgs[w], "ex_q": st.q_lb, "ex_p": st.t_lb})
        host, event = pt._snap
        assert event is None and set(host) == set(snap)
        np.testing.assert_array_equal(
            TPipe._host_predict_pose(host, packed).t, got.t)
    finally:
        pt.host_predict = False
        pt._snap = None


def test_host_predict_in_the_pipeline(cold_start, tmp_path):
    """``host_predict`` through ``process`` at the every-2nd-sweep cadence,
    resumed from the cold start: the skipped sweep after a consumed one
    takes the numpy prediction, which agrees with the device prediction of
    a pipeline without ``host_predict`` (1e-5 m, |q.q'| within 1e-6), and
    the consumed sweep is the same in both."""
    _, pt, _, traj, (_, cfg) = cold_start
    path = str(tmp_path / "cold.npz")
    pt.save(path)
    cfg2 = dataclasses.replace(cfg, estimator=dataclasses.replace(cfg.estimator, odom_io=2))
    pipes = [TPipe(cfg2, device="cpu", dtype=F64, host_predict=h) for h in (False, True)]
    for p in pipes:
        p.load(path)
    dt = cfg.sensor.scan_period
    kinds = []
    for i in range(N_COLD, N_COLD + 3):
        xyz, mask, imu = _sweep_and_imu(traj, i * dt, dt)
        dev, host = (p.process(xyz, mask, p.make_samples(*imu)) for p in pipes)
        kinds.append("skipped" if dev.get("predicted") else "consumed")
        assert bool(host.get("predicted")) == bool(dev.get("predicted"))
        np.testing.assert_allclose(_np(host["laser_pose"].t), _np(dev["laser_pose"].t),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.abs(np.sum(_np(host["laser_pose"].q)
                                                 * _np(dev["laser_pose"].q))), 1.0, atol=1e-6)
    assert kinds == ["skipped", "consumed", "skipped"]
    # the last pose came from the host (numpy), the first from the device
    assert isinstance(host["laser_pose"].t, np.ndarray)
    assert pipes[1]._snap is not None
