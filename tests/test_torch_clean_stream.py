"""The port's streaming path reads nothing back: the counterpart of
``tests/test_clean_stream.py`` for ``lio_mapping_tpu_torch``.

On the card a consumed INITED sweep is one CUDA graph whose early exits
(the mini-GN's rounds, the window LM's iterations) are conditional nodes,
and a skipped sweep's predict is another graph: neither reads a device
value back (``tests/test_torch_cuda.py`` runs them under
``torch.cuda.set_sync_debug_mode("error")``; ``cli run --stats-json`` and
``tools/bench`` count the syncs as ``clean_stream``). On the CPU:

* ``LioPipeline.load`` (the resume entry) uploads only: no aten op that
  reads back, and no ``numpy()``, ``tolist()``, ``item()`` or truth value
  of a tensor;
* a checkpoint resumed on the CPU runner (``StepGraphs("cpu")``) streams
  consumed and skipped INITED sweeps with no host decision
  (``stats["decisions"] == 0``) and no trip of the host-read guard (each
  conditional body's flag is read outside it, as an IF node reads it), and
  gives the eager path's poses and state bit for bit;
* its first consumed sweep agrees with the reference's jitted step from the
  same state within ``tests/test_torch_graphs.py``'s tolerances
  (``tests/test_torch_pipeline.py``'s ``STATE_TOL``), in float64.
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
from lio_mapping_tpu_torch.io import synthetic as TSYN
from lio_mapping_tpu_torch.models import pipeline as TPL
from lio_mapping_tpu_torch.models import step_graph as SG
from lio_mapping_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_graphs import _cfgs, _np, _sweeps
from tests.test_torch_pipeline import STATE_TOL

F64 = torch.float64
N_STREAM = 5  # consumed, skipped, consumed, skipped, consumed

#: aten ops that read a tensor back to the host (``step_graph.HOST_READS``
#: without the uploads, which a resume makes)
READBACKS = SG.HOST_READS - {"lift_fresh"}


class _ReadbackTrap:
    """Raises on a tensor read back to the host inside the block: the
    readback ops under a guard, and the ``Tensor`` methods that hand a
    tensor's values to the host."""

    METHODS = ("numpy", "tolist", "item", "__bool__", "__float__", "__int__", "__array__")

    def __enter__(self):
        self._saved = {m: getattr(torch.Tensor, m) for m in self.METHODS}
        for m in self.METHODS:
            def trap(self_, *a, _m=m, **k):
                raise AssertionError(f"Tensor.{_m} on {tuple(self_.shape)}: a readback")
            setattr(torch.Tensor, m, trap)
        self._guard = SG.HostReadGuard(READBACKS, "load")
        self._guard.__enter__()
        return self

    def __exit__(self, *exc):
        self._guard.__exit__(*exc)
        for m, fn in self._saved.items():
            setattr(torch.Tensor, m, fn)
        return False


def _checkpoint(tmp_path, cfg, dtype):
    """A pipeline at the synthetic INITED state, saved; (path, state, t_next,
    trajectory)."""
    traj = TSYN.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    state, t_next = TSYN.synthetic_estimator_state(cfg, traj, dtype=dtype)
    p = TPL.LioPipeline(cfg, device="cpu", dtype=dtype)
    p.est_state = state
    p.stage = "INITED"
    path = str(tmp_path / "inited.npz")
    p.save(path)
    return path, state, t_next, traj


def _resumed(cfg, path, dtype, runner: bool):
    p = TPL.LioPipeline(cfg, device="cpu", dtype=dtype)
    if runner:
        p._step_graphs = SG.StepGraphs("cpu")
        p.graphs = True
    p.load(path)
    assert p.stage == "INITED"
    return p


def _stream_cfgs():
    """``tests/test_torch_graphs.py``'s small config with the shipped loop
    caps (10 mini-GN rounds, 10 LM iterations): its stream stops both loops
    early, so conditional bodies are skipped as well as run."""
    jcfg, cfg = _cfgs()

    def caps(c):
        return dataclasses.replace(c, estimator=dataclasses.replace(
            c.estimator, newest_refine_iters=10, max_solver_iterations=10))
    return caps(jcfg), caps(cfg)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The checkpoint resumed eagerly and on the CPU runner (float64), both
    fed the same N_STREAM sweeps; the reference's jitted step on the first."""
    jcfg, cfg = _stream_cfgs()
    path, state, t_next, traj = _checkpoint(tmp_path_factory.mktemp("ckpt"), cfg, F64)
    sweeps = _sweeps(traj, t_next, cfg, N_STREAM)
    runs = {}
    for runner in (False, True):
        p = _resumed(cfg, path, F64, runner)
        runs[runner] = (p, [p.process(xyz, mask, packed) for xyz, mask, packed in sweeps])

    jst = jax.tree.unflatten(jax.tree.structure(JE.init_state(jcfg, jnp.float64)),
                             [jnp.asarray(_np(x)) for x in tree_leaves(state)])
    xyz, mask, packed = sweeps[0]
    feats = JPP.process_sweep(jnp.asarray(xyz), jnp.asarray(mask), jcfg, None, None)
    step = jax.jit(JE.lio_step_impl, static_argnames=("cfg",))
    jst2, jout = step(jst, feats.surf_less_flat,
                      JPI.unpack_samples(jnp.asarray(packed, jnp.float64)), jcfg)
    return runs, (jst2, jout)


def test_load_is_upload_only(tmp_path):
    """``LioPipeline.load`` of an INITED checkpoint reads nothing back."""
    _, cfg = _cfgs()
    path, state, _, _ = _checkpoint(tmp_path, cfg, torch.float32)
    fresh = TPL.LioPipeline(cfg, device="cpu", dtype=torch.float32)
    with _ReadbackTrap():
        fresh.load(path)
    assert fresh.stage == "INITED"
    for a, b in zip(tree_leaves(fresh.est_state), tree_leaves(state)):
        assert torch.equal(a, b)


def test_resumed_runner_streams_without_decisions(streams):
    """Two or more consumed and one or more skipped INITED sweeps from the
    resumed checkpoint through the CPU runner: no host decision, every
    conditional body met, no guard trip, one graph a sweep."""
    runs, _ = streams
    p, outs = runs[True]
    g = p._step_graphs
    e = p.cfg.estimator
    consumed = [o for o in outs if "body_pose" in o]
    assert len(consumed) >= 2 and sum(bool(o.get("predicted")) for o in outs) >= 1
    assert g.stats["decisions"] == 0
    assert g.stats["conditionals"] == len(consumed) * (
        e.newest_refine_iters - 1 + e.max_solver_iterations - 1)
    assert g.stats["stretches"] == N_STREAM
    assert "_local_scalar_dense" not in g.guard_ops


def test_resumed_runner_equals_the_eager_path(streams):
    """The runner's outputs and final state equal the eager path's bit for
    bit."""
    runs, _ = streams
    (pe, oe), (pr, og) = runs[False], runs[True]
    for i, (a, b) in enumerate(zip(oe, og)):
        assert sorted(a) == sorted(b), i
        for key in a:
            for x, y in zip(tree_leaves(a[key]), tree_leaves(b[key])):
                if torch.is_tensor(x):
                    assert x.dtype == y.dtype and torch.equal(x, y), (i, key)
    for x, y in zip(tree_leaves(pe.est_state), tree_leaves(pr.est_state)):
        assert torch.equal(x, y)


def test_resumed_runner_agrees_with_the_reference_step(streams):
    """The runner's first consumed sweep against the reference's jitted step
    from the same state: the mini-GN's rounds and the LM's iterations
    (the device counters), the body pose, velocity and biases."""
    runs, (_, jout) = streams
    p, outs = runs[True]
    o = outs[0]
    assert "body_pose" in o
    assert int(o["newest_rounds"]) == int(jout["newest_rounds"])
    assert int(o["solver_iterations"]) == int(jout["solver_iterations"])
    for key in ("velocity", "ba", "bg"):
        np.testing.assert_allclose(_np(o[key]), np.asarray(jout[key]), atol=STATE_TOL, rtol=0,
                                   err_msg=key)
    for key in ("q", "t"):
        np.testing.assert_allclose(_np(getattr(o["body_pose"], key)),
                                   np.asarray(getattr(jout["body_pose"], key)),
                                   atol=STATE_TOL, rtol=0, err_msg=key)


def test_device_counters_count_the_bodies_that_ran(streams):
    """``newest_rounds`` and ``solver_iterations`` are the device counters
    bumped inside the conditional bodies: within their loops' bounds, and
    the stream's sweeps stopped both loops early (so skipped bodies were
    met)."""
    runs, _ = streams
    p, outs = runs[True]
    e = p.cfg.estimator
    consumed = [o for o in outs if "body_pose" in o]
    rounds = [int(o["newest_rounds"]) for o in consumed]
    iters = [int(o["solver_iterations"]) for o in consumed]
    assert all(1 <= r <= e.newest_refine_iters for r in rounds)
    assert all(1 <= i <= e.max_solver_iterations for i in iters)
    assert min(rounds) < e.newest_refine_iters and min(iters) < e.max_solver_iterations
