"""The estimator step as one program of stretches and conditional bodies
(``models/estimator.step_program``) and its runner
(``models/step_graph.StepGraphs``) on the CPU, where the runner executes
the program eagerly through the static buffers the card's CUDA graph uses.

(a) The host-read guard: the whole INITED step runs under
    ``HostReadGuard``, which fails on ``aten._local_scalar_dense``,
    ``aten._linalg_check_errors``, ``aten.lift_fresh``, ``aten.nonzero``,
    ``aten.masked_select`` (and a bool-mask index, ``bincount``, ...), and
    on ``eigh`` outside ``ops/eigh.eigh_plain`` (the CPU's plain version of
    the card's Jacobi kernel); a conditional body's flag is read outside the
    guard, as a conditional node reads it on the card, and no decision is
    read on the host. The guard itself trips on each of them.
(b) Twelve sweeps (six consumed, six predicted) from a synthetic INITED
    state in float32: the pipeline whose step goes through the runner
    gives the eager pipeline's outputs and state bit for bit.
(c) From one synthetic state in float64, the runner's first
    consumed sweep against the reference package's jitted
    ``lio_step_impl`` on the same inputs, and the predicted sweep after it
    against the reference's mean-only predict, within
    ``tests/test_torch_pipeline.py``'s tolerances (one reference step: its
    compile and run take a minute on the CPU).
(d) ``gn.solve`` (``solve_ex`` without its error check) equals
    ``torch.linalg.solve`` bit for bit at the mini-GN's 6x6 and the LM's
    shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.models import estimator as JE
from lio_mapping_tpu.models import point_processor as JPP
from lio_mapping_tpu.ops import preintegration as JPI
from lio_mapping_tpu_torch.io import checkpoint as TCK
from lio_mapping_tpu_torch.io import synthetic as TSYN
from lio_mapping_tpu_torch.models import estimator as TE
from lio_mapping_tpu_torch.models import pipeline as TPL
from lio_mapping_tpu_torch.models import step_graph as SG
from lio_mapping_tpu_torch.ops import cloud as TC
from lio_mapping_tpu_torch.ops import gn as TGN
from lio_mapping_tpu_torch.ops import preintegration as TPI
from lio_mapping_tpu_torch.utils.tree import tree_leaves, tree_map

from tests.test_lio_pipeline import small_cfg
from tests.test_torch_pipeline import POSE_TOL, STATE_TOL, port_cfg

F64 = torch.float64
N_SWEEPS = 12  # every 2nd consumed: six consumed INITED steps, six predicts


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _cfgs():
    """The small closed-loop config, every 2nd sweep consumed, at most 4
    mini-GN rounds and 3 LM iterations (CPU sweeps of a second or two)."""
    j = small_cfg()
    j = dataclasses.replace(j, estimator=dataclasses.replace(
        j.estimator, odom_io=2, newest_refine_iters=4, max_solver_iterations=3))
    return j, port_cfg(j)


def _sweeps(traj, t_next, cfg, n):
    """The ``n`` sweeps after ``t_next - dt`` with their packed IMU."""
    dt = cfg.sensor.scan_period
    m = cfg.estimator.imu.max_imu_per_frame
    out = []
    for j in range(n):
        t0 = t_next - dt + j * dt
        xyz, mask = TSYN.simulate_sweep(traj, t0, n_azimuth=540)
        ts, acc, gyr = TSYN.simulate_imu_interval(traj, t0, t0 + dt, 200.0)
        a0, w0 = traj.imu(t0)
        out.append((xyz, mask, TPI.pack_samples_np(np.diff(np.concatenate([[t0], ts])), acc,
                                                   gyr, a0, w0, m)))
    return out


def _inited(cfg, state, runner: bool):
    """A port pipeline resumed INITED at ``state``; with ``runner`` its step
    goes through the CPU runner with the host-read guard on."""
    p = TPL.LioPipeline(cfg, device="cpu", dtype=state.ps.dtype)
    p.est_state = state
    p.stage = "INITED"
    if runner:
        p._step_graphs = SG.StepGraphs("cpu")
        p.graphs = True
    return p


@pytest.fixture(scope="module")
def runs():
    """N_SWEEPS sweeps after the port's synthetic INITED state (float32)
    through an eager pipeline and one whose step runs through the runner."""
    _, cfg = _cfgs()
    traj = TSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    state, t_next = TSYN.synthetic_estimator_state(cfg, traj, dtype=torch.float32)
    sweeps = _sweeps(traj, t_next, cfg, N_SWEEPS)
    out = {}
    for name in ("eager", "runner"):
        p = _inited(cfg, tree_map(torch.clone, state), name == "runner")
        out[name] = (p, [p.process(xyz, mask, packed) for xyz, mask, packed in sweeps])
    return out


@pytest.fixture(scope="module")
def ref_runs():
    """From one synthetic INITED state in both packages (float64): the
    runner's first two sweeps (consumed, predicted), and the reference's
    jitted step on the first and its predict on the second (the skipped
    sweep's IMU after the consumed step's state)."""
    jcfg, cfg = _cfgs()
    traj = TSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    # the port's synthetic state (equal to the reference's to 1e-12,
    # tests/test_torch_pipeline.py) handed to the reference leaf by leaf
    state, t_next = TSYN.synthetic_estimator_state(cfg, traj, dtype=F64)
    jst = jax.tree.unflatten(jax.tree.structure(JE.init_state(jcfg, jnp.float64)),
                             [jnp.asarray(_np(x)) for x in tree_leaves(state)])
    sweeps = _sweeps(traj, t_next, cfg, 2)
    p = _inited(cfg, state, True)
    outs = [p.process(xyz, mask, packed) for xyz, mask, packed in sweeps]

    (xyz, mask, packed), (_, _, packed2) = sweeps
    feats = JPP.process_sweep(jnp.asarray(xyz), jnp.asarray(mask), jcfg, None, None)
    step = jax.jit(JE.lio_step_impl, static_argnames=("cfg",))
    jst2, jout = step(jst, feats.surf_less_flat,
                      JPI.unpack_samples(jnp.asarray(packed, jnp.float64)), jcfg)
    w = jcfg.estimator.window_size
    pre = JPI.integrate_mean(JPI.unpack_samples(jnp.asarray(packed2, jnp.float64)),
                             jst2.bas[w], jst2.bgs[w])
    q, t, _ = JPI.apply_deltas(pre, jst2.qs[w], jst2.ps[w], jst2.vs[w], jst2.g_vec)
    return p, outs, (jst2, jout, JE.laser_pose(q, t, jst2.q_lb, jst2.t_lb))


def test_runner_equals_the_eager_step_bit_for_bit(runs):
    """(b): every output of every sweep and the final state, bit for bit."""
    pipes = runs
    (pe, oe), (pr, og) = pipes["eager"], pipes["runner"]
    assert sum("body_pose" in o for o in oe) == N_SWEEPS // 2
    assert sum(bool(o.get("predicted")) for o in oe) == N_SWEEPS // 2
    _assert_runs_equal(oe, og)
    for x, y in zip(tree_leaves(pe.est_state), tree_leaves(pr.est_state)):
        assert torch.equal(x, y)


def test_stretches_make_no_host_read(runs):
    """(a): the twelve sweeps ran every program under the guard without a
    trip, one graph a sweep; ``eigh`` ran (inside ``eigh_plain`` only), no
    decision read a flag on the host and no op read one under the guard;
    every consumed sweep met the step's conditional bodies (the mini-GN's
    rounds and the LM's iterations after the first), whatever ran."""
    pipes = runs
    pr, outs = pipes["runner"]
    g = pr._step_graphs
    e = pr.cfg.estimator
    consumed = [o for o in outs if "body_pose" in o]
    assert g.stats["decisions"] == 0
    assert g.stats["conditionals"] == len(consumed) * (
        e.newest_refine_iters - 1 + e.max_solver_iterations - 1)
    assert {"_linalg_eigh", "_linalg_solve_ex"} <= g.guard_ops
    assert "_local_scalar_dense" not in g.guard_ops
    # the rounds and iterations that ran are the device counters' outputs
    for o in consumed:
        assert 1 <= int(o["newest_rounds"]) <= e.newest_refine_iters
        assert 1 <= int(o["solver_iterations"]) <= e.max_solver_iterations
    # one graph a sweep: the consumed step (front end included) or the predict
    assert g.stats["stretches"] == N_SWEEPS


def _assert_runs_equal(oe, og):
    for i, (a, b) in enumerate(zip(oe, og)):
        assert sorted(a) == sorted(b), i
        for key in a:
            la, lb = tree_leaves(a[key]), tree_leaves(b[key])
            assert len(la) == len(lb), (i, key)
            for x, y in zip(la, lb):
                if torch.is_tensor(x):
                    assert x.dtype == y.dtype and torch.equal(x, y), (i, key)


@pytest.mark.parametrize("flags", [
    dict(prior_factor=True, cutoff_deskew=True, keep_features=False),
    dict(use_corner=True, fix_map=True, enable_deskew=False, corner_stack_cap=64,
         local_map_corner_cap=256)],
    ids=["prior_cutoff_nokeep", "corner_fixmap_odometry_clouds"])
def test_variants_through_the_runner(flags):
    """(a) and (b) on the estimator's other branches (outdoor_64's extrinsic
    prior, cutoff deskew and no kept features; use_corner with fix_map on
    the odometry's clouds, without deskew): a consumed and a skipped sweep
    through the guarded runner equal the eager pipeline's bit for bit."""
    _, base = _cfgs()
    cfg = dataclasses.replace(base, estimator=dataclasses.replace(base.estimator, **flags))
    traj = TSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    state, t_next = TSYN.synthetic_estimator_state(cfg, traj, dtype=torch.float32)
    sweeps = _sweeps(traj, t_next, cfg, 2)
    outs = {}
    for runner in (False, True):
        p = _inited(cfg, tree_map(torch.clone, state), runner)
        outs[runner] = [p.process(xyz, mask, packed) for xyz, mask, packed in sweeps]
    assert ["body_pose" in o for o in outs[False]] == [True, False]
    if not cfg.estimator.enable_deskew:
        assert outs[True][0]["surf_cloud"].xyz.shape[0] == cfg.feature.surf_less_flat_cap
    _assert_runs_equal(outs[False], outs[True])


@pytest.mark.parametrize("op", ["item", "solve", "tensor", "nonzero", "masked_select",
                                "bool_index", "bincount", "eigh"])
def test_guard_trips_on_each_host_read(op):
    """(a): each forbidden op raises ``HostReadError`` inside a stretch."""
    x = torch.arange(1.0, 7.0, dtype=F64)
    a = torch.eye(6, dtype=F64) * 2.0
    body = {
        "item": lambda: x.sum().item(),
        "solve": lambda: torch.linalg.solve(a, x),
        "tensor": lambda: torch.tensor([1.0, 2.0], dtype=F64),
        "nonzero": lambda: torch.nonzero(x > 3),
        "masked_select": lambda: torch.masked_select(x, x > 3),
        "bool_index": lambda: x[x > 3],
        "bincount": lambda: torch.bincount(x.to(torch.int64)),
        "eigh": lambda: torch.linalg.eigh(a),
    }[op]
    g = SG.StepGraphs("cpu")
    with pytest.raises(SG.HostReadError):
        g.stretch(("t",), lambda v: {"y": body()}, {})


def test_reference_step_agrees(ref_runs):
    """(c): the runner's consumed sweep against the reference's jitted step
    (body pose, velocity, biases, window states, the mini-GN and LM counts)
    and its predicted pose against the reference's predict."""
    p, (ot, opred), (jst2, jout, jpred) = ref_runs
    assert "body_pose" in ot and opred.get("predicted")
    assert int(ot["solver_iterations"]) == int(jout["solver_iterations"])
    assert int(ot["newest_rounds"]) == int(jout["newest_rounds"])
    for key in ("velocity", "ba", "bg"):
        np.testing.assert_allclose(_np(ot[key]), np.asarray(jout[key]), atol=STATE_TOL, rtol=0,
                                   err_msg=key)
    for key in ("q", "t"):
        np.testing.assert_allclose(_np(getattr(ot["body_pose"], key)),
                                   np.asarray(getattr(jout["body_pose"], key)), atol=STATE_TOL,
                                   rtol=0, err_msg=key)
        np.testing.assert_allclose(_np(getattr(opred["laser_pose"], key)),
                                   np.asarray(getattr(jpred, key)), atol=POSE_TOL, rtol=0,
                                   err_msg=key)
    for name in ("qs", "ps", "vs", "bas", "bgs"):
        np.testing.assert_allclose(_np(getattr(p.est_state, name)),
                                   np.asarray(getattr(jst2, name)), atol=STATE_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("n", [6, 66, 126], ids=["gn_6x6", "lm_small", "lm_indoor"])
@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_solve_without_check_equals_solve(n, dtype):
    """(d): the same factorization and solve, bit for bit (126 = the indoor
    LM's 15 (7 + 1) + 6 unknowns; 66 = the small config's)."""
    rng = np.random.default_rng(n)
    j = rng.normal(size=(3 * n, n))
    a = torch.as_tensor(j.T @ j + 1e-3 * np.eye(n), dtype=dtype)
    b = torch.as_tensor(rng.normal(size=n), dtype=dtype)
    assert torch.equal(TGN.solve(a, b), torch.linalg.solve(a, b))


def test_count_ids_equals_bincount():
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(0, 17, size=5000))
    assert torch.equal(TC.count_ids(ids, 17), torch.bincount(ids, minlength=17))


def test_padded_cloud_gives_the_same_features():
    """The graphed pipeline pads a sweep's packed cloud with masked rows to
    ``cloud_rows_bucket`` rows: the front end's features are the same bit
    for bit."""
    _, cfg = _cfgs()
    traj = TSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    xyz, mask = TSYN.simulate_sweep(traj, 0.3, n_azimuth=540)
    n = len(xyz)
    rows = TPL.cloud_rows_bucket(n)
    assert n < rows <= n + max(1024, n // 8)
    packed = TPL._pack_xyzw_np(xyz, mask)
    padded = np.zeros((rows, 4), np.float32)
    padded[:n] = packed
    a = TPL._feats_from_xyzw(torch.as_tensor(packed), None, cfg)
    b = TPL._feats_from_xyzw(torch.as_tensor(padded), None, cfg)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_cloud_rows_bucket():
    assert TPL.cloud_rows_bucket(1) == 1024
    assert TPL.cloud_rows_bucket(14400) == 15360
    assert TPL.cloud_rows_bucket(16384) == 16384
    assert TPL.cloud_rows_bucket(115200) == 122880
    for n in (1000, 5000, 57600, 200000):
        assert TPL.cloud_rows_bucket(n) >= n


def test_static_buffers_keep_strides_and_contents():
    """A value handed across stretches keeps its shape, strides and values
    in its static buffer (an expanded view, a transposed one, a slice), and
    the same name maps to the same buffer from call to call."""
    def values(base):
        return {"e": base[0][None].expand(5, 3), "t": base.T, "s": base[1:]}

    g = SG.StepGraphs("cpu")
    base = torch.arange(12.0).reshape(4, 3)
    v = {}
    g.stretch(("a",), lambda _: values(base), v)
    for k, x in values(base).items():
        assert v[k].stride() == x.stride() and torch.equal(v[k], x)
        assert v[k].data_ptr() != x.data_ptr()
    first = {k: v[k].data_ptr() for k in v}
    g.stretch(("a",), lambda _: values(base * 2), v)
    for k, x in values(base * 2).items():
        assert v[k].data_ptr() == first[k] and torch.equal(v[k], x)


def test_graphs_need_the_card():
    """``graphs=True`` without a CUDA device (or with a mesh) raises; the
    CPU runs the step eagerly."""
    _, cfg = _cfgs()
    assert not TPL.LioPipeline(cfg, device="cpu").graphs
    with pytest.raises(ValueError, match="graphs"):
        TPL.LioPipeline(cfg, device="cpu", graphs=True)
    assert not SG.StepGraphs("cpu").capture
