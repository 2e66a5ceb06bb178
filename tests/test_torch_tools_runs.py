"""The port's tools run against the JAX package's, on the CPU (each test
spends tens of seconds; they share a file so that the scheduler of the
parallel test run starts them beside the rest):

* ``bench``'s two phases on ``--device cpu`` at a small config give a
  checkpoint and the JAX tool's stream record (its keys pinned to
  ``bench.py:213-231``);
* ``_TRUNCATE_STAGE`` at "map" and "solve": the port's truncated step
  against the reference's on one small float64 INITED state, within
  ``tests/test_torch_variants.py``'s tolerances (1e-6 on states, 1e-5 on
  poses); with None again the full step is bit-identical to one run before
  any truncation;
* ``debug_corner both`` against the JAX package's
  ``tools/debug_corner.run(True, True)``: use_corner + fix_map, 16 sweeps
  at 540 azimuth steps, float64. Both tools' small config gets
  ``tests/test_torch_pipeline.cold_cfg``'s narrower feature capacities
  (the same in both; CPU time). Each INITED sweep's error, computed by the
  port's ``sweep_errors`` from each package's poses, agrees within 1e-4 m,
  and the reference's own RMSE is the one of its errors. The port's run
  goes in a thread beside the reference's (which spends most of its time
  compiling).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.io import synthetic as JSYN
from lio_mapping_tpu.models import estimator as JE
from lio_mapping_tpu.models import pipeline as JPL
from lio_mapping_tpu.models import point_processor as JPP
from lio_mapping_tpu.ops import preintegration as JPI
from lio_mapping_tpu_torch.io import checkpoint as TCK
from lio_mapping_tpu_torch.models import estimator as TE
from lio_mapping_tpu_torch.models import point_processor as TPP
from lio_mapping_tpu_torch.ops import preintegration as TPI
from lio_mapping_tpu_torch.tools import bench as TB
from lio_mapping_tpu_torch.tools import debug_corner as TDC
from lio_mapping_tpu_torch.utils.tree import tree_leaves
from tools import debug_corner as JDC

from tests.test_lio_pipeline import small_cfg
from tests.test_torch_pipeline import _np, _sweep_and_imu, port_cfg

F64 = torch.float64
STATE_TOL = 1e-6   # tests/test_torch_variants.py:49-50
POSE_TOL = 1e-5
ERR_TOL = 1e-4     # m, debug_corner's per-sweep errors
# the JAX tool's stream record (bench.py:213-231)
STREAM_KEYS = {"fps", "per_sweep_ms", "estimator_steps_per_sec", "io_ratio", "n_timed", "reps",
               "chunk_fps", "median_fps", "dispatch_floor_ms", "clean_stream"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small eager ops gain nothing from intra-op threads under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow(cfg):
    """``tests/test_torch_pipeline.cold_cfg``'s feature capacities."""
    feat = dataclasses.replace(cfg.feature, corner_sharp_cap=128, corner_less_sharp_cap=1024,
                               surf_flat_cap=256, surf_less_flat_cap=2048)
    return dataclasses.replace(cfg, feature=feat)


# ---------------------------------------------------------------------------
# bench's two phases on the CPU
# ---------------------------------------------------------------------------


def _bench_small(profile="indoor"):
    """``tools/debug_corner.py:18-27``'s caps, narrower features (CPU time)."""
    return _narrow(TDC.small_cfg())


def test_bench_phases_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(TB, "build_cfg", _bench_small)
    ckpt = str(tmp_path / "init.npz")
    a = TB.run_init("indoor", ckpt, 0, torch.device("cpu"))
    assert set(a) == {"consumed"} and a["consumed"] > 0
    with np.load(ckpt) as z:
        assert int(z["meta.0"][0]) == 1  # INITED
    rec = TB.run_stream("indoor", ckpt, a["consumed"], 2, 1, torch.device("cpu"))
    assert set(rec) == STREAM_KEYS
    assert rec["fps"] > 0 and rec["n_timed"] == 2 and rec["reps"] == 1
    assert rec["chunk_fps"] == [rec["fps"]] and rec["median_fps"] == rec["fps"]
    assert rec["io_ratio"] == 2 and rec["dispatch_floor_ms"] > 0


# ---------------------------------------------------------------------------
# _TRUNCATE_STAGE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inited_step_inputs():
    """``tests/test_torch_pipeline.test_one_inited_step_matches``'s inputs:
    the reference's synthetic INITED state carried over, and one sweep."""
    jcfg = small_cfg()
    cfg = port_cfg(jcfg)
    traj = JSYN.Trajectory(g_norm=jcfg.estimator.imu.g_norm)
    jst, t_next = JSYN.synthetic_estimator_state(jcfg, traj, dtype=jnp.float64)
    tst = TCK.state_from_numpy_leaves(TE.init_state(cfg, F64, "cpu"),
                                      [np.asarray(x) for x in jax.tree.leaves(jst)])
    dt = cfg.sensor.scan_period
    xyz, mask, imu = _sweep_and_imu(traj, t_next - dt, dt)
    packed = JPI.pack_samples_np(*imu, cfg.estimator.imu.max_imu_per_frame).astype(np.float64)
    jfeat = JPP.process_sweep(jnp.asarray(xyz), jnp.asarray(mask), jcfg, None, None)
    tfeat = TPP.process_sweep(torch.as_tensor(xyz), torch.as_tensor(mask), cfg, None, None)
    j_in = (jst, jfeat.surf_less_flat, JPI.unpack_samples(jnp.asarray(packed)))
    t_in = (tst, tfeat.surf_less_flat, TPI.unpack_samples(torch.as_tensor(packed)))
    return jcfg, cfg, j_in, t_in


def _jax_truncated(monkeypatch, stage, jcfg, j_in):
    """The reference's step truncated at ``stage``: a fresh jit, so the hook
    is read while tracing."""
    monkeypatch.setattr(JE, "_TRUNCATE_STAGE", stage)
    out = jax.jit(lambda s, c, i: JE.lio_step_impl(s, c, i, jcfg))(*j_in)
    jax.effects_barrier()
    return out


def _close(t, j, tol, what):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=tol, rtol=0, err_msg=what)


def test_truncate_stage_matches_jax(monkeypatch, inited_step_inputs):
    jcfg, cfg, j_in, t_in = inited_step_inputs
    assert TE._TRUNCATE_STAGE is None
    full = TE.lio_step_impl(*t_in, cfg)

    # "map": the pushed window, the local map and the frames' relative poses
    jst, jout = _jax_truncated(monkeypatch, "map", jcfg, j_in)
    monkeypatch.setattr(TE, "_TRUNCATE_STAGE", "map")
    tst, tout = TE.lio_step_impl(*t_in, cfg)
    assert set(tout) == set(jout) == {"m", "maps", "stacks", "rel_q", "rel_t"}
    np.testing.assert_array_equal(_np(tout["maps"][1]), np.asarray(jout["maps"][1]))
    _close(tout["m"], jout["m"], STATE_TOL, "map")
    for key in ("rel_q", "rel_t"):
        _close(tout[key], jout[key], POSE_TOL, key)
    for t, j in zip(tout["stacks"], jout["stacks"]):
        _close(t, j, STATE_TOL, "stacks")
    for name in ("qs", "ps", "vs", "bas", "bgs"):
        _close(getattr(tst, name), getattr(jst, name), STATE_TOL, name)

    # "solve": the window LM's solution before the yaw-gauge fix
    _, jout = _jax_truncated(monkeypatch, "solve", jcfg, j_in)
    monkeypatch.setattr(TE, "_TRUNCATE_STAGE", "solve")
    _, tout = TE.lio_step_impl(*t_in, cfg)
    assert set(tout) == set(jout) == {"q"}
    q_t, q_j = _np(tout["q"]), np.asarray(jout["q"])
    np.testing.assert_allclose(np.abs(np.sum(q_t * q_j, axis=-1)), 1.0, atol=STATE_TOL, rtol=0)

    # the hook left at None: the full step, bit for bit
    monkeypatch.setattr(TE, "_TRUNCATE_STAGE", None)
    again = TE.lio_step_impl(*t_in, cfg)
    for a, b in zip(tree_leaves(full), tree_leaves(again)):
        if torch.is_tensor(a):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# debug_corner against the reference's tool
# ---------------------------------------------------------------------------


def test_debug_corner_both_matches_jax(monkeypatch):
    for mod in (TDC, JDC):
        monkeypatch.setattr(mod, "small_cfg", lambda orig=mod.small_cfg: _narrow(orig()))
    # the reference's poses and their ground truth, as its run() selects them
    poses, stamps = [], []
    orig = JPL.LioPipeline.process

    def process(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        if out["stage"] == "INITED" and "body_pose" in out:
            poses.append((np.asarray(out["laser_pose"].q), np.asarray(out["laser_pose"].t)))
            stamps.append(self.frame_count * self.cfg.sensor.scan_period)
        return out
    monkeypatch.setattr(JDC.LioPipeline, "process", process)

    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(TDC.run, True, True, "cpu")
        j_rmse = JDC.run(True, True)
        t_rmse, t_errs = port.result()

    traj = JDC.synthetic.Trajectory(g_norm=TDC.small_cfg().estimator.imu.g_norm)
    j_errs = TDC.sweep_errors(poses, [JDC.synthetic.gt_sensor_pose(traj, t) for t in stamps])
    assert len(t_errs) == len(j_errs) >= 2
    np.testing.assert_allclose(t_errs, j_errs, atol=ERR_TOL, rtol=0)
    assert j_rmse == pytest.approx(float(np.sqrt(np.mean(np.square(j_errs)))), abs=1e-12)
    assert t_rmse == pytest.approx(j_rmse, abs=ERR_TOL)
