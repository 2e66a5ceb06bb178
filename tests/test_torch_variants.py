"""The estimator variants and the outdoor_64 shape: the port against the
reference package, in float64 on the CPU, from the same inputs.

(a) Cold start with ``use_corner`` (and ``use_corner`` + ``fix_map``) on
    ``cold_cfg`` with 1024-row corner stacks and a 4096-row corner local
    map: both pipelines reach INITED on the same sweep and take two INITED
    steps; laser poses within 1e-5, equal mini-GN and LM iteration counts,
    the frozen linearization poses (``qs_lin``/``ps_lin``) within 1e-5, and
    the same neighbour set in every matched row of every 5-NN search. Every
    corner search of the port reaches ``knn`` with ``force_tiled``.
(b) One INITED step on an outdoor_64-shaped config (64 rings, window 7/5,
    ``odom_io`` 3, ``prior_factor``, ``cutoff_deskew``, ``keep_features``
    off, 2048/8192 caps; tests/test_tpu_accuracy.py:96-124) from the
    reference's ``synthetic_estimator_state``, at the tolerances of
    ``test_torch_pipeline.test_one_inited_step_matches``.
(c) The checkpoint bridge both ways for a ``use_corner`` + ``fix_map``
    state (corner stacks, frozen linearization poses): the reference's
    ``save`` loads into the port and both continue alike; the port's
    ``save`` loads into the reference leaf for leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.config import LioConfig as JCfg
from lio_mapping_tpu.io import checkpoint as JCK
from lio_mapping_tpu.io import synthetic as JSYN
from lio_mapping_tpu.models import estimator as JE
from lio_mapping_tpu.models import point_processor as JPP
from lio_mapping_tpu.models.pipeline import LioPipeline as JPipe
from lio_mapping_tpu.ops import knn as JK
from lio_mapping_tpu.ops import preintegration as JPI
from lio_mapping_tpu_torch.io import checkpoint as TCK
from lio_mapping_tpu_torch.models import estimator as TE
from lio_mapping_tpu_torch.models import point_processor as TPP
from lio_mapping_tpu_torch.models.pipeline import LioPipeline as TPipe
from lio_mapping_tpu_torch.ops import knn as TK
from lio_mapping_tpu_torch.ops import preintegration as TPI
from lio_mapping_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_pipeline import _np, _pose_close, _sweep_and_imu, cold_cfg, port_cfg

F64 = torch.float64
STATE_TOL = 1e-6
POSE_TOL = 1e-5
N_COLD = 8  # INITED at sweep 5 on this config, then two INITED steps
VARIANTS = {"use_corner": dict(use_corner=True),
            "use_corner+fix_map": dict(use_corner=True, fix_map=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small ops gain nothing from intra-op threads; one
    thread keeps the file from oversubscribing the cores under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variant_cfg(name):
    base = cold_cfg()
    est = dataclasses.replace(base.estimator, corner_stack_cap=1024, local_map_corner_cap=4096,
                              **VARIANTS[name])
    return dataclasses.replace(base, estimator=est)


def _recording(mp, calls_j, calls_t):
    """Record every 5-NN search of both packages (the estimator's; the
    odometry's 1-NN ones go unrecorded): (sq_d, idx, force_tiled)."""
    orig_j, orig_t = JK.knn, TK.knn

    def rec_j(*args, **kw):
        d, i = orig_j(*args, **kw)
        if d.shape[1] == 5:
            tiled = bool(kw.get("force_tiled", False))
            jax.debug.callback(lambda a, b: calls_j.append((np.asarray(a), np.asarray(b), tiled)),
                               d, i, ordered=True)
        return d, i

    def rec_t(*args, **kw):
        d, i = orig_t(*args, **kw)
        if d.shape[1] == 5:
            calls_t.append((_np(d), _np(i), bool(kw.get("force_tiled", False))))
        return d, i

    mp.setattr(JK, "knn", rec_j)
    mp.setattr(TK, "knn", rec_t)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant_run(request):
    """Both pipelines over the first N_COLD sweeps, every KNN recorded."""
    jcfg = variant_cfg(request.param)
    cfg = port_cfg(jcfg)
    traj = JSYN.Trajectory(g_norm=jcfg.estimator.imu.g_norm)
    calls_j, calls_t = [], []
    outs = []
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, calls_j, calls_t)
        pj = JPipe(jcfg, dtype=jnp.float64)
        pt = TPipe(cfg, device="cpu", dtype=F64)
        dt = cfg.sensor.scan_period
        for i in range(N_COLD):
            xyz, mask, imu = _sweep_and_imu(traj, i * dt, dt)
            oj = pj.process(xyz, mask, pj.make_samples(*imu))
            ot = pt.process(xyz, mask, pt.make_samples(*imu))
            jax.effects_barrier()
            outs.append((oj, ot))
    # copies at the end of the run: the bridge test steps the pipelines on,
    # and the reference's compiled step keeps its recording callback
    return {"name": request.param, "pj": pj, "pt": pt, "outs": outs, "traj": traj,
            "cfg": cfg, "calls": (list(calls_j), list(calls_t)),
            "states": (pj.est_state, pt.est_state)}


def test_variant_cold_start_matches(variant_run):
    r = variant_run
    outs, (est_j, est_t) = r["outs"], r["states"]
    stages = [(oj["stage"], ot["stage"]) for oj, ot in outs]
    assert all(a == b for a, b in stages), stages
    inited = [i for i, (oj, _) in enumerate(outs) if "body_pose" in oj]
    assert len(inited) >= 2, stages
    for i, (oj, ot) in enumerate(outs):
        _pose_close(ot, oj, msg=f"sweep {i}")
    for i in inited:
        oj, ot = outs[i]
        assert int(ot["solver_iterations"]) == int(oj["solver_iterations"]), i
        assert int(ot["newest_rounds"]) == int(oj["newest_rounds"]), i
    for name in ("qs_lin", "ps_lin", "qs", "ps"):
        np.testing.assert_allclose(_np(getattr(est_t, name)), np.asarray(getattr(est_j, name)),
                                   atol=POSE_TOL, rtol=0, err_msg=name)
    if r["cfg"].estimator.fix_map:
        # frozen: the frames' linearization poses lag their solved poses
        assert not np.allclose(_np(est_t.qs_lin), _np(est_t.qs), atol=1e-9)
    np.testing.assert_array_equal(_np(est_t.corner_mask), np.asarray(est_j.corner_mask))
    assert _np(est_t.corner_mask).sum(1).min() > 100

    calls_j, calls_t = r["calls"]
    assert len(calls_t) == len(calls_j)
    n_corner = 0
    for (td, ti, tt), (jd, ji, jt) in zip(calls_t, calls_j):
        assert tt == jt
        n_corner += int(tt)
        rows = np.isfinite(jd[:, -1])
        np.testing.assert_array_equal(np.isfinite(td[:, -1]), rows)
        np.testing.assert_array_equal(np.sort(ti[rows], axis=1), np.sort(ji[rows], axis=1))
        np.testing.assert_allclose(td[rows], jd[rows], atol=STATE_TOL, rtol=0)
    # each INITED step searches the corner map once per frame and GN round,
    # always on the plain tiled version
    w, pivot = r["cfg"].estimator.window_size, r["cfg"].estimator.pivot_idx
    assert n_corner == sum((w - pivot - 1) + int(outs[i][1]["newest_rounds"]) for i in inited)


def outdoor64_small_cfg():
    """The outdoor_64 shape at small capacities (test_tpu_accuracy.py:96-124)."""
    base = JCfg.outdoor_64()
    est = dataclasses.replace(
        base.estimator, estimate_extrinsic=0, opt_extrinsic=False,
        extrinsic_rotation=(1, 0, 0, 0, 1, 0, 0, 0, 1), extrinsic_translation=(0.0, 0.0, 0.0),
        init_window_factor=1, surf_stack_cap=2048, local_map_filtered_cap=8192,
        features_per_frame_cap=2048, max_solver_iterations=8)
    return dataclasses.replace(base, estimator=est)


def test_outdoor64_shaped_inited_step_matches(monkeypatch):
    jcfg = outdoor64_small_cfg()
    cfg = port_cfg(jcfg)
    e = cfg.estimator
    assert (e.window_size, e.opt_window_size, e.odom_io, cfg.sensor.n_rings) == (7, 5, 3, 64)
    assert e.prior_factor and e.cutoff_deskew and not e.keep_features
    traj = JSYN.Trajectory(g_norm=e.imu.g_norm)
    jst, t_next = JSYN.synthetic_estimator_state(jcfg, traj, dtype=jnp.float64, n_azimuth=360)
    tst = TCK.state_from_numpy_leaves(TE.init_state(cfg, F64, "cpu"),
                                      [np.asarray(x) for x in jax.tree.leaves(jst)])

    # the consumed interval spans odom_io sweeps; the cloud is the last one
    s = cfg.sensor
    xyz, mask = JSYN.simulate_sweep(traj, t_next - s.scan_period, n_azimuth=360,
                                    n_rings=s.n_rings, lower_deg=s.lower_bound_deg,
                                    upper_deg=s.upper_bound_deg)
    xyz = xyz.astype(np.float64)
    _, _, imu = _sweep_and_imu(traj, t_next - s.scan_period * e.odom_io,
                               s.scan_period * e.odom_io)
    packed = JPI.pack_samples_np(*imu, e.imu.max_imu_per_frame).astype(np.float64)
    jfeat = JPP.process_sweep(jnp.asarray(xyz), jnp.asarray(mask), jcfg, None, None)
    tfeat = TPP.process_sweep(torch.as_tensor(xyz), torch.as_tensor(mask), cfg, None, None)
    for a, b in zip(tfeat.surf_less_flat, jfeat.surf_less_flat):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-12, rtol=0)

    calls_j, calls_t = [], []
    _recording(monkeypatch, calls_j, calls_t)
    step = jax.jit(JE.lio_step_impl, static_argnames=("cfg",))
    jst2, jout = step(jst, jfeat.surf_less_flat, JPI.unpack_samples(jnp.asarray(packed)), jcfg)
    jax.effects_barrier()
    tst2, tout = TE.lio_step_impl(tst, tfeat.surf_less_flat,
                                  TPI.unpack_samples(torch.as_tensor(packed)), cfg)

    assert int(tout["solver_iterations"]) == int(jout["solver_iterations"])
    assert int(tout["newest_rounds"]) == int(jout["newest_rounds"])
    assert int(tout["n_features"]) == int(jout["n_features"]) > 1000
    for key in ("velocity", "ba", "bg", "ex_p", "ex_q"):
        np.testing.assert_allclose(_np(tout[key]), np.asarray(jout[key]), atol=STATE_TOL,
                                   rtol=0, err_msg=key)
    for name in ("qs", "ps", "vs", "bas", "bgs", "qs_lin", "ps_lin"):
        np.testing.assert_allclose(_np(getattr(tst2, name)), np.asarray(getattr(jst2, name)),
                                   atol=STATE_TOL, rtol=0, err_msg=name)
    for a, b in zip(tree_leaves(tst2.prior), jax.tree.leaves(jst2.prior)):
        assert _np(a).shape == np.asarray(b).shape
    # frames pivot+1..W-1, then the mini-GN rounds, none pinned to tiled
    w, pivot = e.window_size, e.pivot_idx
    assert len(calls_t) == len(calls_j) == (w - pivot - 1) + int(tout["newest_rounds"])
    for (td, ti, tt), (jd, ji, jt) in zip(calls_t, calls_j):
        assert not tt and not jt
        rows = np.isfinite(jd[:, 4])
        assert rows.any()
        np.testing.assert_array_equal(np.sort(ti[rows], axis=1), np.sort(ji[rows], axis=1))
        np.testing.assert_allclose(td[rows], jd[rows], atol=STATE_TOL, rtol=0)


@pytest.mark.parametrize("variant_run", ["use_corner+fix_map"], indirect=True)
def test_variant_checkpoint_bridge_both_ways(variant_run, tmp_path):
    r = variant_run
    pj, pt, cfg, traj = r["pj"], r["pt"], r["cfg"], r["traj"]
    ref_path = str(tmp_path / "ref.npz")
    pj.save(ref_path)
    resumed = TPipe(cfg, device="cpu", dtype=F64)
    resumed.load(ref_path)
    assert (resumed.stage, resumed.frame_count) == (pj.stage, pj.frame_count) == \
        ("INITED", N_COLD)
    for a, b in zip(tree_leaves((resumed.est_state, resumed.odom_state)),
                    jax.tree.leaves((pj.est_state, pj.odom_state))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert _np(resumed.est_state.corner_xyz).shape[1] == cfg.estimator.corner_stack_cap
    dt = cfg.sensor.scan_period
    xyz, mask, imu = _sweep_and_imu(traj, N_COLD * dt, dt)
    oj = pj.process(xyz, mask, pj.make_samples(*imu))
    ot = resumed.process(xyz, mask, resumed.make_samples(*imu))
    assert ot["stage"] == oj["stage"] == "INITED" and "body_pose" in ot
    _pose_close(ot, oj)
    np.testing.assert_allclose(_np(resumed.est_state.qs_lin), np.asarray(pj.est_state.qs_lin),
                               atol=POSE_TOL, rtol=0)

    port_path = str(tmp_path / "port.npz")
    resumed.save(port_path)
    back = JCK.load_state(port_path, est=pj.est_state, odom=pj.odom_state)
    for a, b in zip(tree_leaves((resumed.est_state, resumed.odom_state)),
                    jax.tree.leaves((back["est"], back["odom"]))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
