"""The port's distributed estimator (``lio_mapping_tpu_torch/parallel``) on
the CPU: 2 ranks, spawned processes over gloo, against the JAX package's
``shard_map`` programs on 2 of the 8 virtual CPU devices (``tests/
conftest.py``) and against the port's single-device functions, on the same
seeded numpy inputs.

The ranks run ``tests/torch_parallel_worker.run_checks`` once for the whole
module (port code only: no ``jax`` and no ``lio_mapping_tpu`` in their
processes), while this process computes the references. Tolerances are the
reference's own tests':

* ``ring_knn`` (``tests/test_map_sharded.py:46-87``): distances within 1e-10
  of the reference's ring and of the port's ``knn`` on the concatenated map
  (float64), carried coordinates equal to the indexed map points; with the
  gate, exact rows within it and the same gate decisions;
* ``solve_window_sharded`` (``tests/test_sharded.py:61-64``): positions and
  ``sb`` within 1e-6, |q.q'| within 1e-9 of 1; the sharded marginalization's
  information (J^T J, J^T r) at the single-device solver's rounding floor;
* the isolated BA core (``tests/test_map_sharded.py:90-152``): map-sharded
  states within 1e-8 of the replicated step, cost within rtol 1e-8, the
  prior's ``lin_res`` within 1e-7;
* the full step (``tests/test_lio_dist.py:83-94``), over its 10 consumed
  sweeps: every sweep's laser position, and at the end ``ps``, ``vs``,
  ``bas`` and ``bgs``, within 1e-2 of the single-device ``lio_step``, |q.q'|
  within 1e-5 of 1, and the two ranks' states bit-identical. The sums over
  the ranks flip a mini-GN early exit on the third sweep (3 rounds against
  2, in the reference's own distributed step too), after which the window's
  velocities differ by ~0.037 m/s and decay to ~0.007 m/s by the tenth
  sweep, as the reference's do.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from lio_mapping_tpu.ops import marginalization as JMG
from lio_mapping_tpu.ops import preintegration as JPI
from lio_mapping_tpu.ops import solver as JSV
from lio_mapping_tpu.parallel import distributed as JDIST
from lio_mapping_tpu.parallel import map_sharded as JMS
from lio_mapping_tpu.parallel import multihost as JMH
from lio_mapping_tpu.parallel import sharded_ba as JSB
from lio_mapping_tpu.utils import quaternion as jquat
from lio_mapping_tpu_torch.models import estimator as TE
from lio_mapping_tpu_torch.ops import knn as TKNN
from lio_mapping_tpu_torch.ops import marginalization as TMG
from lio_mapping_tpu_torch.ops import preintegration as TPI
from lio_mapping_tpu_torch.ops import solver as TSV
from lio_mapping_tpu_torch.parallel import multihost as MH

from tests import torch_parallel_worker as W
from tests.test_lio_dist import _tiny_cfg
from tests.test_torch_pipeline import port_cfg
from tests.test_solver import _make_window_problem

D = 2
F64 = torch.float64
RING_CASES = ("plain", "gated", "invalid_block")


def _np(tree):
    return tuple(np.asarray(a) for a in tree)


def _window_cfg():
    """``tests/test_map_sharded.test_mapsharded_step_matches_replicated``'s."""
    from lio_mapping_tpu.config import LioConfig

    base = LioConfig.indoor()
    est = dataclasses.replace(
        base.estimator, window_size=5, opt_window_size=3, estimate_extrinsic=0,
        opt_extrinsic=False, extrinsic_translation=(0.0, 0.0, 0.0), surf_stack_cap=256,
        local_map_filtered_cap=1024, max_solver_iterations=4)
    return dataclasses.replace(base, estimator=est)


def _corner_cfg():
    tiny = _tiny_cfg()
    return dataclasses.replace(tiny, estimator=dataclasses.replace(
        tiny.estimator, use_corner=True, corner_stack_cap=512, local_map_corner_cap=1024))


@pytest.fixture(scope="module")
def problem():
    x0, pres, planes = _make_window_problem(s=3, f=96, noise=0.01, seed=7)
    rng = np.random.default_rng(1)
    dq = jnp.asarray(rng.normal(0, 0.01, (4, 3))).at[0].set(0.0)
    x0 = x0._replace(q=jquat.normalize(jquat.qmul(x0.q, jquat.exp(dq))))
    return x0, pres, planes


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, problem):
    """Starts the two rank processes (gloo, CPU) for the module and returns
    a future of their results: one dict of numpy arrays per rank."""
    case_dir = tmp_path_factory.mktemp("ranks")
    cfgs = {"window": port_cfg(_window_cfg()), "tiny": port_cfg(_tiny_cfg()),
            "corner": port_cfg(_corner_cfg())}
    x0, pres, planes = problem
    args = (str(case_dir), cfgs, (_np(x0), _np(pres), _np(planes)))
    pool = ThreadPoolExecutor(1)

    def run():
        rc = MH.launch(D, W.run_checks, *args)
        assert rc == 0, f"a rank failed with exit code {rc}"
        out = []
        for r in range(D):
            with np.load(case_dir / f"rank{r}.npz") as z:
                out.append({k: z[k] for k in z.files})
        return out

    fut = pool.submit(run)
    yield fut
    pool.shutdown(wait=True)


def _jmesh():
    return Mesh(np.array(jax.devices()[:D]), (JMS.AXIS,))


# ---------------------------------------------------------------------------
# the rank processes themselves
# ---------------------------------------------------------------------------


def test_ranks_run_on_gloo_without_jax(ranks):
    for r, res in enumerate(ranks.result()):
        assert str(res["backend"]) == "gloo" and str(res["device"]) == "cpu"
        assert res["imported_jax"].size == 0, res["imported_jax"]


def test_multihost_psum_replicate_and_counters(ranks):
    """The cross-process psum of ``tests/multihost_worker.py``; ``replicate``
    broadcasts rank 0's values (each rank held its own before); every
    collective is counted, none went through the host on the CPU."""
    for res in ranks.result():
        np.testing.assert_array_equal(res["mh/psum"], np.arange(4.0).reshape(D, -1).sum(0))
        np.testing.assert_array_equal(res["mh/replicate_a"], np.ones(3))
        np.testing.assert_array_equal(res["mh/replicate_b"], [True])
        n, nbytes, host = res["mh/counters"]
        assert n == 3 and nbytes == 2 * 8 + 3 * 8 + 1 and host == 0
    # lio_dist.make_mesh: the joined group's mesh, of every rank
    assert [list(res["mh/make_mesh"]) for res in ranks.result()] == [[D, 0], [D, 1]]


def test_is_multiprocess(ranks):
    """True in each rank of the 2-rank group; in this process, which joined
    none, False, as the reference's ``is_multiprocess`` is in one process."""
    assert [bool(res["mh/is_multiprocess"]) for res in ranks.result()] == [True] * D
    assert MH.is_multiprocess() is JMH.is_multiprocess() is False


def test_backend_rule():
    assert MH.choose_backend("cpu", 2, 0) == "gloo"
    assert MH.choose_backend("cpu", 2, 8) == "gloo"
    assert MH.choose_backend("cuda", 2, 1) == "gloo"   # ranks share the card
    assert MH.choose_backend("cuda", 2, 2) == "nccl"
    assert MH.choose_backend("cuda", 4, 8) == "nccl"
    assert [str(MH.rank_device("cuda", r, 1)) for r in range(2)] == ["cuda:0", "cuda:0"]
    assert [str(MH.rank_device("cuda", r, 4)) for r in range(2)] == ["cuda:0", "cuda:1"]
    assert MH.rank_device("cpu", 1, 0).type == "cpu"
    # a collective is staged through the host only where gloo refuses it
    card = MH.Mesh(None, 0, 2, torch.device("cuda", 0), "gloo")
    assert MH._staged(card, "batch_isend_irecv") and not MH._staged(card, "all_reduce")
    assert not MH._staged(MH.Mesh(None, 0, 2, torch.device("cpu"), "gloo"),
                          "batch_isend_irecv")
    assert not MH._staged(MH.Mesh(None, 0, 2, torch.device("cuda", 0), "nccl"),
                          "batch_isend_irecv")


def test_launch_returns_the_worst_exit_code():
    assert MH.launch(2, W.exit_with, (0, 0)) == 0
    assert MH.launch(2, W.exit_with, (0, 3)) == 3


# ---------------------------------------------------------------------------
# ring_knn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_knn_matches(ranks, case):
    q, qm, db, dbm, k, prune = W.ring_inputs(case, D)
    fn = shard_map(lambda a, b, c, d: JMS.ring_knn(a, b, c, d, k=k, prune_beyond=prune),
                   mesh=_jmesh(), in_specs=(P(JMS.AXIS),) * 4, out_specs=(P(JMS.AXIS),) * 3,
                   check_vma=False)
    jd, ji, jx = (np.asarray(a) for a in jax.jit(fn)(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db), jnp.asarray(dbm)))
    td, ti = (a.numpy() for a in TKNN.knn(torch.as_tensor(q), torch.as_tensor(qm),
                                          torch.as_tensor(db), torch.as_tensor(dbm), k=k))
    res = ranks.result()
    for r in range(D):  # every rank gathered the same rows
        for key in ("d", "i", "x"):
            np.testing.assert_array_equal(res[r][f"ring/{case}/{key}"],
                                          res[0][f"ring/{case}/{key}"])
    d, i, x = (res[0][f"ring/{case}/{key}"] for key in ("d", "i", "x"))
    assert d.dtype == np.float64 and i.dtype == np.int32
    fin = np.isfinite(d)
    np.testing.assert_array_equal(x[fin], db[i[fin]])
    assert np.all(dbm[i[fin]])
    if prune is None:
        np.testing.assert_allclose(d, jd, atol=1e-10)
        np.testing.assert_allclose(d, td, atol=1e-10)
    else:
        # exact wherever the true k-th neighbour is inside the gate; the
        # gate's decision d[:, k-1] < gate is the same either way
        inside = td[:, -1] < prune
        np.testing.assert_allclose(d[inside], td[inside], atol=1e-10)
        np.testing.assert_allclose(d[inside], jd[inside], atol=1e-10)
        np.testing.assert_array_equal(d[:, -1] < prune, td[:, -1] < prune)
        np.testing.assert_array_equal(d[:, -1] < prune, jd[:, -1] < prune)


def test_force_tiled_reaches_knn_on_every_ring_step(ranks):
    """Map-sharded with use_corner: every call of the corner closure into
    ``ops.knn.knn`` (a block of the corner map) carries ``force_tiled``, two
    per search (one per ring step), and no surf call does."""
    cfg = port_cfg(_corner_cfg())
    e = cfg.estimator
    corner_rows, surf_rows = e.local_map_corner_cap // D, e.local_map_filtered_cap // D
    assert corner_rows != surf_rows
    for res in ranks.result():
        calls = [tuple(c) for c in res["force_tiled/calls"]]
        corner = [f for m, f in calls if m == corner_rows]
        surf = [f for m, f in calls if m == surf_rows]
        assert len(corner) + len(surf) == len(calls)
        assert corner and all(corner) and len(corner) % D == 0
        assert surf and not any(surf) and len(surf) % D == 0
        # one corner search per surf search (each association round runs both)
        assert len(corner) == len(surf)


# ---------------------------------------------------------------------------
# the sharded solver and marginalization
# ---------------------------------------------------------------------------


def _port_problem(problem):
    x0, pres, planes = problem
    return (TSV.OptStates(*(torch.as_tensor(np.array(a)) for a in x0)),
            TPI.Preintegration(*(torch.as_tensor(np.array(a)) for a in pres)),
            TSV.PlaneFactors(*(torch.as_tensor(np.array(a)) for a in planes)))


def test_solve_window_sharded_matches(ranks, problem):
    x0, pres, planes = problem
    s = 3
    g = jnp.asarray([0.0, 0.0, -9.805])
    jfn = jax.jit(shard_map(
        lambda x_, p_, pl_, pr_: JSB.solve_window_sharded(
            x_, p_, g, pl_, pr_, None, s=s, max_iterations=6,
            opt_extrinsic=jnp.asarray(False), use_marg=jnp.asarray(False)),
        mesh=_jmesh(), in_specs=(P(), P(), P(None, JSB.AXIS), P()), out_specs=P(),
        check_vma=False))
    jx, _ = jfn(x0, pres, planes, JMG.PriorState.empty(s, jnp.float64))
    tx0, tpres, tplanes = _port_problem(problem)
    no = torch.tensor(False)
    tx, _ = TSV.solve_window(tx0, tpres, torch.tensor([0.0, 0.0, -9.805], dtype=F64), tplanes,
                             TMG.PriorState.empty(s, F64), None, s=s, max_iterations=6,
                             opt_extrinsic=no, use_marg=no)
    for res in ranks.result():
        for ref in (jx, tx):
            np.testing.assert_allclose(res["solve/p"], np.asarray(ref.p), atol=1e-6)
            np.testing.assert_allclose(res["solve/sb"], np.asarray(ref.sb), atol=1e-6)
            qd = np.abs(np.sum(res["solve/q"] * np.asarray(ref.q), axis=-1))
            np.testing.assert_allclose(qd, 1.0, atol=1e-9)


def test_marginalize_pivot_psum_matches(ranks, problem):
    """The sharded marginalization at the sharded solution equals the
    single-device one at the same states: the prior's information J^T J
    and J^T r, within the float64 rounding floor of the system's largest
    entry (the IMU bias blocks, ~5e12, cancel in the Schur complement)."""
    tx0, tpres, tplanes = _port_problem(problem)
    s = 3
    res0 = ranks.result()[0]
    x = tx0._replace(q=torch.as_tensor(res0["solve/q"]), p=torch.as_tensor(res0["solve/p"]),
                     sb=torch.as_tensor(res0["solve/sb"]))
    single = TSV.marginalize_pivot(x, TPI.Preintegration(*(a[0] for a in tpres)),
                                   torch.tensor([0.0, 0.0, -9.805], dtype=F64), tplanes,
                                   TMG.PriorState.empty(s, F64), s=s)
    from lio_mapping_tpu_torch.ops import factors as TFA

    w = TFA.sqrt_info_from_covariance(tpres.covariance[0])
    floor = 1e-14 * float(torch.max(torch.abs(w.T @ w)))
    for res in ranks.result():
        jac, r = torch.as_tensor(res["marg/lin_jac"]), torch.as_tensor(res["marg/lin_res"])
        np.testing.assert_allclose((jac.T @ jac).numpy(),
                                   (single.lin_jac.T @ single.lin_jac).numpy(), atol=8 * floor)
        np.testing.assert_allclose((jac.T @ r).numpy(),
                                   (single.lin_jac.T @ single.lin_res).numpy(), atol=8 * floor)


def test_distributed_step_mapsharded_matches(ranks):
    """The isolated BA core, map-sharded, against the JAX package's
    ``make_distributed_step_mapsharded`` and the port's replicated step."""
    cfg = _window_cfg()
    s = cfg.estimator.opt_window_size
    x0_p, map_xyz, stacks_xyz, rel_t = W.window_step_inputs(port_cfg(cfg), D)
    dtype = jnp.float64
    x0 = JSV.OptStates(q=jnp.tile(jquat.identity(dtype), (s + 1, 1)), p=jnp.asarray(x0_p),
                       sb=jnp.zeros((s + 1, 9), dtype), ex_q=jquat.identity(dtype),
                       ex_p=jnp.zeros(3, dtype))
    pres = jax.tree.map(lambda a: jnp.broadcast_to(a, (s,) + a.shape),
                        JPI.Preintegration.identity(dtype)._replace(
                            covariance=jnp.eye(15, dtype=dtype) * 1e-4,
                            sum_dt=jnp.asarray(0.1, dtype)))
    args = (x0, pres, jnp.asarray([0.0, 0.0, -9.805], dtype), jnp.asarray(map_xyz),
            jnp.ones((map_xyz.shape[0],), bool), jnp.asarray(stacks_xyz),
            jnp.ones(stacks_xyz.shape[:2], bool), jnp.tile(jquat.identity(dtype), (s + 1, 1)),
            jnp.asarray(rel_t), JMG.PriorState.empty(s, dtype))
    jx, jprior, jcost = JDIST.make_distributed_step_mapsharded(_jmesh(), cfg)(*args)
    for res in ranks.result():
        for name in ("p", "sb"):
            np.testing.assert_allclose(res[f"dstep/ms/{name}"], res[f"dstep/rep/{name}"],
                                       atol=1e-8)
            np.testing.assert_allclose(res[f"dstep/ms/{name}"], np.asarray(getattr(jx, name)),
                                       atol=1e-8)
        qd = np.abs(np.sum(res["dstep/ms/q"] * np.asarray(jx.q), axis=-1))
        np.testing.assert_allclose(qd, 1.0, atol=1e-12)
        np.testing.assert_allclose(res["dstep/ms/cost"], res["dstep/rep/cost"], rtol=1e-8)
        np.testing.assert_allclose(res["dstep/ms/cost"], float(jcost), rtol=1e-8)
        np.testing.assert_allclose(res["dstep/ms/lin_res"], res["dstep/rep/lin_res"],
                                   atol=1e-7)
        jac, r = res["dstep/ms/lin_jac"], res["dstep/ms/lin_res"]
        jj, jr = np.asarray(jprior.lin_jac), np.asarray(jprior.lin_res)
        scale = max(1.0, float(np.max(np.abs(jj.T @ jj))))
        np.testing.assert_allclose(jac.T @ jac, jj.T @ jj, atol=1e-9 * scale)
        np.testing.assert_allclose(jac.T @ r, jj.T @ jr, atol=1e-9 * scale)


# ---------------------------------------------------------------------------
# the full distributed step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_steps():
    """The port's single-device ``lio_step`` over the same sweeps, on one
    intra-op thread as the ranks run (the thread count changes the order of
    torch's CPU sums, and the closed loop amplifies last-bit differences)."""
    cfg = port_cfg(_tiny_cfg())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.run_steps(cfg, lambda st, c, s, corner: TE.lio_step(st, c, s, cfg, corner))
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("tag", ["plain", "map_shard"])
def test_sharded_lio_step_matches_single_device(ranks, single_steps, tag):
    poses1, st1 = single_steps
    res = ranks.result()
    np.testing.assert_array_equal(res[0][f"full/{tag}/state_bytes"],
                                  res[1][f"full/{tag}/state_bytes"])
    r = res[0]
    np.testing.assert_allclose(r[f"full/{tag}/poses"], poses1, atol=1e-2)
    for name in ("ps", "vs", "bas", "bgs"):
        np.testing.assert_allclose(r[f"full/{tag}/{name}"], getattr(st1, name).numpy(),
                                   atol=1e-2, err_msg=name)
    qd = np.abs(np.sum(r[f"full/{tag}/qs"] * st1.qs.numpy(), axis=-1))
    np.testing.assert_allclose(qd, 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# ingest sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", ["xyzw", "ring"])
def test_ingest_shard_gives_the_front_end_the_same_cloud(ranks, tag):
    """1001 rows over 2 ranks: rank 1's slice is padded by one masked row
    for the gather and cut off after it; the cloud equals the replicated
    upload bit for bit, through ``process`` and ``prefetch_cloud`` alike,
    one gather each."""
    for res in ranks.result():
        want = res[f"ingest/{tag}/replicated"]
        assert want.shape == (W.INGEST_ROWS, 5 if tag == "ring" else 4)
        np.testing.assert_array_equal(res[f"ingest/{tag}/sharded"], want)
        np.testing.assert_array_equal(res[f"ingest/{tag}/prefetched"], want)
        assert int(res[f"ingest/{tag}/collectives"]) == 2
