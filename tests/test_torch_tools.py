"""The port's measurement tools (``lio_mapping_tpu_torch/tools``) against
the JAX package's tools (``bench.py``, ``tools/*.py``) on the CPU, on the
same seeded inputs:

* configurations and inputs are EQUAL: ``build_cfg`` field by field,
  ``CONFIG_DELTAS``, ``gen_frames`` bit for bit, ``SMALL_YAML`` (and both
  packages' profile loaded from it), ``VARIANTS`` and each variant's
  config, ``debug_corner.small_cfg``;
* the cost counter against XLA's ``cost_analysis()``: equal flops on a
  matmul and on elementwise functions, equal bytes on one op, and on two
  unfused ops the sum of each op's bytes (at least XLA's fused count);
* ``bench_scaling``'s inputs equal the JAX tool's leaf by leaf; its 1-rank
  step equals the JAX package's ``make_distributed_step`` on a 1-device
  mesh, and its 2-rank step (gloo, CPU, float64) its 1-rank step, within
  ``tests/test_sharded.py:61-64``'s tolerances;
* without CUDA and without ``--device cpu`` every tool exits non-zero.

The tools' runs (``bench``'s two phases, ``debug_corner``, the truncated
estimator step) are ``tests/test_torch_tools_runs.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JB
from jax.sharding import Mesh
from lio_mapping_tpu.config import LioConfig as JCfg, load_yaml as jload_yaml
from lio_mapping_tpu.ops import marginalization as JMG
from lio_mapping_tpu.ops import preintegration as JPI
from lio_mapping_tpu.ops import solver as JSV
from lio_mapping_tpu.parallel import distributed as JDIST
from lio_mapping_tpu.utils import quaternion as jquat
from lio_mapping_tpu_torch.config import load_yaml as tload_yaml
from lio_mapping_tpu_torch.tools import ab_flags as TAB
from lio_mapping_tpu_torch.tools import bench as TB
from lio_mapping_tpu_torch.tools import bench_cli as TBC
from lio_mapping_tpu_torch.tools import bench_scaling as TBS
from lio_mapping_tpu_torch.tools import debug_corner as TDC
from lio_mapping_tpu_torch.tools import profile_step
from lio_mapping_tpu_torch.utils.profiling import CostCounter
from lio_mapping_tpu_torch.utils.tree import tree_leaves
from tools import ab_flags as JAB
from tools import bench_cli as JBC
from tools import debug_corner as JDC

TOOLS = {"bench": TB, "bench_cli": TBC, "profile_step": profile_step, "ab_flags": TAB,
         "bench_scaling": TBS, "debug_corner": TDC}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small eager ops gain nothing from intra-op threads under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configurations and inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["indoor", "outdoor_64"])
def test_build_cfg_matches_jax(profile):
    assert dataclasses.asdict(TB.build_cfg(profile)) == dataclasses.asdict(JB.build_cfg(profile))
    assert TB.CONFIG_DELTAS == JB.CONFIG_DELTAS


def test_gen_frames_bit_equal():
    got = TB.gen_frames(TB.build_cfg(), 3, start=5)
    want = JB.gen_frames(JB.build_cfg(), 3, start=5)
    assert len(got) == len(want) == 3
    for (tx, tm, timu), (jx, jm, jimu) in zip(got, want):
        for a, b in zip((tx, tm, *timu), (jx, jm, *jimu)):
            np.testing.assert_array_equal(a, b)


def test_tool_configs_match_jax(tmp_path):
    """SMALL_YAML (and both packages' profile loaded from it), VARIANTS and
    each variant's config, and debug_corner's small config."""
    assert TBC.SMALL_YAML == JBC.SMALL_YAML
    path = tmp_path / "small.yaml"
    path.write_text(TBC.SMALL_YAML)
    assert dataclasses.asdict(tload_yaml(str(path))) == dataclasses.asdict(jload_yaml(str(path)))
    assert TAB.VARIANTS == JAB.VARIANTS
    base = JCfg.indoor()
    for name, over in JAB.VARIANTS.items():
        want = dataclasses.replace(base, estimator=dataclasses.replace(base.estimator, **over))
        assert dataclasses.asdict(TAB.variant_cfg(name)) == dataclasses.asdict(want)
    assert dataclasses.asdict(TDC.small_cfg()) == dataclasses.asdict(JDC.small_cfg())


# ---------------------------------------------------------------------------
# the cost counter against XLA's cost model
# ---------------------------------------------------------------------------


def _xla_cost(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"]), float(ca["bytes accessed"])


def _port_cost(fn, *args):
    with CostCounter() as c:
        fn(*args)
    return float(c.flops), float(c.bytes)


def test_cost_counter_matches_xla_on_a_matmul(rng):
    a = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48, 32)).astype(np.float32)
    got = _port_cost(lambda x, y: x @ y, torch.as_tensor(a), torch.as_tensor(b))
    want = _xla_cost(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert got[0] == want[0] == 2 * 64 * 48 * 32
    assert got[1] == want[1] == (64 * 48 + 48 * 32 + 64 * 32) * 4


def test_cost_counter_matches_xla_elementwise(rng):
    """One op: flops and bytes equal. Two ops: flops equal; XLA fuses them
    and counts the fusion's inputs and output once, eager runs each op, so
    the port's bytes are the two ops' sums: here twice XLA's."""
    x, y = (torch.as_tensor(rng.normal(size=1000).astype(np.float32)) for _ in range(2))
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    assert _port_cost(lambda u, v: u * v, x, y) == _xla_cost(lambda u, v: u * v, jx, jy)
    got = _port_cost(lambda u, v: u * v + u, x, y)
    want = _xla_cost(lambda u, v: u * v + u, jx, jy)
    assert got[0] == want[0] == 2000
    assert got[1] == 2 * (3 * 1000 * 4) and got[1] >= want[1]


# ---------------------------------------------------------------------------
# bench_scaling: 2 ranks against 1
# ---------------------------------------------------------------------------


SCALING = {"device": "cpu", "features_total": 512, "map_points": 1024, "iters": 1,
           "dtype": "float64"}


@pytest.fixture(scope="module")
def scaling_runs():
    """``bench_scaling``'s step on 1 and on 2 gloo ranks (CPU, float64)."""
    return {n: TBS.run_mesh(n, SCALING) for n in (1, 2)}


def _jax_scaling_inputs(cfg, f_total, map_n, dtype):
    """The JAX tool's fixed-size inputs, as ``tools/bench_scaling.py:139-157``
    builds them (seed 0)."""
    s = cfg.estimator.opt_window_size
    rng = np.random.default_rng(0)
    x0 = JSV.OptStates(q=jnp.tile(jquat.identity(dtype), (s + 1, 1)),
                       p=jnp.asarray(rng.normal(0, 0.05, (s + 1, 3)), dtype),
                       sb=jnp.zeros((s + 1, 9), dtype), ex_q=jquat.identity(dtype),
                       ex_p=jnp.zeros(3, dtype))
    pres = jax.tree.map(lambda a: jnp.broadcast_to(a, (s,) + a.shape),
                        JPI.Preintegration.identity(dtype)._replace(
                            covariance=jnp.eye(15, dtype=dtype) * 1e-4,
                            sum_dt=jnp.asarray(0.1, dtype)))
    g_vec = jnp.asarray([0.0, 0.0, -9.805], dtype)
    map_xyz = jnp.asarray(rng.uniform(-8, 8, (map_n, 3)), dtype)
    map_mask = jnp.ones((map_n,), bool)
    stacks_xyz = jnp.asarray(rng.uniform(-8, 8, (s, f_total, 3)), dtype)
    stacks_mask = jnp.ones((s, f_total), bool)
    rel_q = jnp.tile(jquat.identity(dtype), (s + 1, 1))
    rel_t = jnp.asarray(rng.normal(0, 0.05, (s + 1, 3)), dtype)
    prior = JMG.PriorState.empty(s, dtype)
    return (x0, pres, g_vec, map_xyz, map_mask, stacks_xyz, stacks_mask, rel_q, rel_t, prior)


def _jax_scaling_cfg():
    base = JCfg.indoor()
    return dataclasses.replace(base, estimator=dataclasses.replace(
        base.estimator, window_size=12, opt_window_size=7, max_solver_iterations=8))


def test_bench_scaling_inputs_and_step_match_jax(scaling_runs):
    """``make_inputs`` equals the JAX tool's inputs leaf by leaf (float32, as
    the tool runs), and the port's 1-rank step equals the JAX package's
    ``make_distributed_step`` on a 1-device mesh (float64) within
    ``tests/test_sharded.py:61-64``'s tolerances."""
    jcfg = _jax_scaling_cfg()
    assert dataclasses.asdict(TBS.scaling_cfg()) == dataclasses.asdict(jcfg)
    f, m = SCALING["features_total"], SCALING["map_points"]
    got = TBS.make_inputs(TBS.scaling_cfg(), f, m, "cpu", torch.float32)
    want = _jax_scaling_inputs(jcfg, f, m, jnp.float32)
    t_leaves, j_leaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)

    jmesh = Mesh(np.array(jax.devices()[:1]), (JDIST.AXIS,))
    jx, _, jcost = JDIST.make_distributed_step(jmesh, jcfg)(
        *_jax_scaling_inputs(jcfg, f, m, jnp.float64))
    one = scaling_runs[1]
    np.testing.assert_allclose(one["p"], np.asarray(jx.p), atol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(one["q"] * np.asarray(jx.q), axis=-1)), 1.0,
                               atol=1e-9)
    np.testing.assert_allclose(one["sb"], np.asarray(jx.sb), atol=1e-6)
    np.testing.assert_allclose(one["cost"], float(jcost), rtol=1e-6)


def test_bench_scaling_two_ranks_match_one(scaling_runs):
    one, two = scaling_runs[1], scaling_runs[2]
    assert one["backend"] == two["backend"] == "gloo"
    np.testing.assert_allclose(two["p"], one["p"], atol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(two["q"] * one["q"], axis=-1)), 1.0, atol=1e-9)
    np.testing.assert_allclose(two["sb"], one["sb"], atol=1e-6)
    report = TBS.make_report(scaling_runs, torch.device("cpu"), 0, 512, 2)
    assert report["mode"] == "multiprocess-cpu (2 procs)" and report["device"] == "cpu"
    assert [s["n_devices"] for s in report["steps"]] == [1, 2]
    assert "NOT speedup" in report["note"]


# ---------------------------------------------------------------------------
# no CUDA, no --device cpu: every tool refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_exits_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        TOOLS[name].main([])
    assert exc.value.code not in (0, None)


# ---------------------------------------------------------------------------
# the search counters (tools/profiling.py) and CUDA graph replays
# ---------------------------------------------------------------------------

def _outer_search(q, db):
    """A path that makes one plain search and reports one kernel launch (the
    kernel itself needs the card)."""
    from lio_mapping_tpu_torch.ops import knn as TK
    from lio_mapping_tpu_torch.ops import knn_kernel as TKK

    TKK.note_search("kernel", q.shape[0], db.shape[0], 5)
    return TK.knn_tiled(q, torch.ones(q.shape[0], dtype=torch.bool), db,
                        torch.ones(db.shape[0], dtype=torch.bool), k=5)


def _replayer(events):
    from lio_mapping_tpu_torch.ops import knn_kernel as TKK

    TKK.replayed(events)


def test_counters_count_searches_by_path_live_and_replayed(rng):
    """``launches_by_path``, ``plain_searches`` and ``kernel_shapes`` count
    a search made in the block by the functions on its stack; a search
    recorded while a CUDA graph is captured counts nothing then, and counts
    at each replay, by the frames inside the capture and the frames that
    replay it (``ops/knn_kernel.recording`` / ``replayed``)."""
    import sys

    from lio_mapping_tpu_torch.ops import knn_kernel as TKK
    from lio_mapping_tpu_torch.tools.profiling import (kernel_shapes, launches_by_path,
                                                       plain_searches)

    me = sys.modules[__name__]
    q = torch.as_tensor(rng.normal(size=(64, 3)))
    db = torch.as_tensor(rng.normal(size=(300, 3)))
    targets = {"outer": (me, "_outer_search"), "replay": (me, "_replayer")}
    kernel, plain, shapes = {}, {}, {}
    before = TKK.launches()
    with launches_by_path(kernel, targets), plain_searches(plain, targets), \
            kernel_shapes(shapes):
        _outer_search(q, db)
        with TKK.recording() as events:
            _outer_search(q, db)
        assert TKK.launches() == before + 1 and plain == {"outer": 1}
        for _ in range(3):
            _replayer(events)
    assert TKK.launches() == before + 4
    assert kernel == {"outer": 4, "replay": 3}
    assert plain == {"outer": 4, "replay": 3}
    assert shapes == {"64x300x5": 4}
    assert not TKK.LISTENERS


def test_stage_breakdown_refuses_a_graphed_step():
    """``stage_breakdown`` times the eager step only: a stretch of the
    graphed runner inside it raises."""
    from lio_mapping_tpu_torch.models import step_graph as SG
    from lio_mapping_tpu_torch.tools.profiling import stage_breakdown

    g = SG.StepGraphs("cpu")
    with pytest.raises(ValueError, match="graphs=False"):
        stage_breakdown(lambda: g.stretch(("x",), lambda v: {"y": torch.ones(2)}, {}), "cpu")
    # restored after the call
    g.stretch(("x",), lambda v: {"y": torch.ones(2)}, {})
