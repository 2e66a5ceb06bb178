"""The port's exact KNN (``lio_mapping_tpu_torch.ops.knn``) against the
reference: the tiled jnp path (``ops/knn.py``, the CPU oracle) and the
Pallas kernel ``knn_pallas`` in interpret mode, on the inputs of
``tests/test_knn_kernel.py`` plus contract cases (duplicate map points,
fewer than k valid points, masked queries, the AABB prune gate).

Tolerances: float64 distances 1e-12 (same formula; only the matmul's
summation order differs). float32 distances 1e-4 on |coords| ~ 10, a few
ulps of |q|^2 + |p|^2 where the cross term cancels (the reference's own
kernel test uses 1e-3). Indices are compared exactly where distances have
no ties, and tie-robustly (the chosen points' float64 distances) otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.ops import knn as JK
from lio_mapping_tpu_torch.ops import knn as TK
from lio_mapping_tpu_torch.ops import knn_kernel as TKK


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _inputs(rng, n_q=300, n_m=2500, scale=3.0, dtype=np.float32):
    q = (rng.normal(size=(n_q, 3)) * scale).astype(dtype)
    db = (rng.normal(size=(n_m, 3)) * scale).astype(dtype)
    qm = rng.random(n_q) > 0.1
    dm = rng.random(n_m) > 0.05
    return q, qm, db, dm


def _d64(q, db, idx):
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    return np.sum((q64[:, None] - db64[idx]) ** 2, axis=-1)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_knn_matches_tiled_reference(rng, k, dtype, tol):
    q, qm, db, dm = _inputs(rng, dtype=dtype)
    td, ti = TK.knn(_t(q), _t(qm), _t(db), _t(dm), k=k, tile=512)
    jd, ji = JK.knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db), jnp.asarray(dm),
                    k=k, tile=512)
    assert td.dtype == torch.from_numpy(q).dtype and ti.dtype == torch.int32
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=tol, rtol=0)
    if dtype == np.float64:
        np.testing.assert_array_equal(_np(ti)[qm], np.asarray(ji)[qm])
    else:
        np.testing.assert_allclose(_d64(q, db, _np(ti))[qm], _d64(q, db, np.asarray(ji))[qm],
                                   atol=tol, rtol=0)


def test_knn_matches_pallas_interpret(rng):
    """Same function as the TPU kernel (run in interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu
    from lio_mapping_tpu.ops.pallas import knn_kernel as PK

    q, _, db, dm = _inputs(rng)
    qm = np.ones(len(q), bool)
    td, ti = TK.knn(_t(q), _t(qm), _t(db), _t(dm), k=5)
    with pltpu.force_tpu_interpret_mode():
        pd, pi = PK.knn_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db),
                               jnp.asarray(dm), k=5)
    np.testing.assert_allclose(_np(td), np.asarray(pd), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_d64(q, db, _np(ti)), _d64(q, db, np.asarray(pi)),
                               atol=1e-4, rtol=0)


def _clustered(rng, n_m=5000, n_q=600):
    """Clustered, spatially sorted map (as the voxel filter emits it), so
    the prune gate actually skips chunks (tests/test_knn_kernel.py)."""
    centers = rng.normal(size=(8, 3)).astype(np.float32) * 20
    db = centers[rng.integers(0, 8, n_m)] + rng.normal(size=(n_m, 3)).astype(np.float32) * 0.5
    db = db[np.argsort(db[:, 0], kind="stable")].astype(np.float32)
    dm = rng.random(n_m) > 0.05
    q = (centers[rng.integers(0, 8, n_q)]
         + rng.normal(size=(n_q, 3)).astype(np.float32) * 0.7).astype(np.float32)
    q = q[np.argsort(q[:, 0], kind="stable")]  # voxel-sorted stacks, as queried
    qm = rng.random(n_q) > 0.02
    return q, qm, db, dm


def _emulate_kernel(q, qm, db, dm, k, prune):
    """What ``csrc/knn.cu`` computes, in numpy: per 256-query block, the
    chunks the prune flags keep, ascending index, lowest index on ties."""
    d = np.sum(q.astype(np.float64)[:, None] ** 2, -1) + np.sum(
        db.astype(np.float64) ** 2, -1)[None] - 2.0 * q.astype(np.float64) @ db.T.astype(
        np.float64)
    d = np.maximum(d, 0.0)
    d[:, ~dm] = np.inf
    for b in range(prune.shape[0]):
        for c in range(prune.shape[1]):
            if prune[b, c]:
                d[b * TKK.BQ:(b + 1) * TKK.BQ, c * TKK.BM:(c + 1) * TKK.BM] = np.inf
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(d, idx, axis=1)
    idx[np.isinf(dist)] = 0
    dist[~qm] = np.inf
    return dist, idx


def test_prune_flags_and_gated_exactness(rng):
    """The wrapper's AABB flags equal ``knn_pallas``'s, and the pruned
    search keeps its contract: exact for rows whose true k-th neighbour is
    within the gate, beyond the gate for the others."""
    from jax.experimental.pallas import tpu as pltpu
    from lio_mapping_tpu.ops.pallas import knn_kernel as PK

    gate = 1.0
    q, qm, db, dm = _clustered(rng)
    flags = _np(TKK.prune_flags(_t(q), _t(qm), _t(db), _t(dm), gate)).astype(bool)

    # the reference's flags (knn_kernel.py:152-163), from its own _aabb
    n_qb, n_ch = -(-len(q) // PK.BQ), -(-len(db) // PK.BM)
    qp = np.concatenate([q, np.zeros((n_qb * PK.BQ - len(q), 3), np.float32)])
    qmp = np.concatenate([qm, np.zeros(n_qb * PK.BQ - len(q), bool)])
    dp = np.concatenate([db, np.zeros((n_ch * PK.BM - len(db), 3), np.float32)])
    dmp = np.concatenate([dm, np.zeros(n_ch * PK.BM - len(db), bool)])
    q_lo, q_hi = PK._aabb(jnp.asarray(qp), jnp.asarray(qmp), n_qb, PK.BQ)
    c_lo, c_hi = PK._aabb(jnp.asarray(dp), jnp.asarray(dmp), n_ch, PK.BM)
    gap = jnp.maximum(0.0, jnp.maximum(q_lo[:, None, :] - c_hi[None, :, :],
                                       c_lo[None, :, :] - q_hi[:, None, :]))
    lb = jnp.sum(gap * gap, axis=-1)
    want = np.asarray(jnp.where(jnp.isnan(lb), True, lb > gate))
    np.testing.assert_array_equal(flags, want)
    assert flags.any() and not flags.all()

    # the semantics in float64 (the emulation's type), so that exactness is
    # exact: the same points, the same flags
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    ref_d, ref_i = TK.knn(_t(q64), _t(qm), _t(db64), _t(dm), k=5)
    ref_d, ref_i = _np(ref_d), _np(ref_i)
    emu_d, emu_i = _emulate_kernel(q64, qm, db64, dm, 5, flags)
    within = qm & (ref_d[:, 4] < gate)
    assert within.any() and (qm & ~within).any()
    np.testing.assert_allclose(emu_d[within], ref_d[within], atol=1e-9, rtol=0)
    np.testing.assert_array_equal(emu_i[within], ref_i[within])
    np.testing.assert_array_equal(emu_d[:, 4] < gate, within)
    # the Pallas kernel (float32, |coords| ~ 60 m, so ~1e-3 m^2 rounding)
    # takes the same gate decisions away from the gate's rounding band
    with pltpu.force_tpu_interpret_mode():
        pd, _ = PK.knn_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db),
                              jnp.asarray(dm), k=5, prune_beyond=gate)
    clear = np.abs(ref_d[:, 4] - gate) > 1e-2
    np.testing.assert_array_equal((np.asarray(pd)[:, 4] < gate)[clear], within[clear])


def test_contract_ties_duplicates_and_short_maps():
    """The pinned contract (the reference's tiled path): distances clamped
    at 0, ascending, the lowest index wins ties, +inf / index 0 where fewer
    than k valid points exist, +inf for masked queries."""
    base = np.array([[1.0, 2.0, 3.0], [1.5, 2.0, 3.0], [4.0, 4.0, 4.0]], np.float32)
    # duplicates of each point at higher indices, one masked duplicate
    db = np.concatenate([base, base, base[:1]]).astype(np.float32)
    dm = np.array([True, True, True, True, True, True, False])
    q = np.array([[1.0, 2.0, 3.0], [1.25, 2.0, 3.0], [9.0, 9.0, 9.0]], np.float32)
    qm = np.array([True, True, False])
    td, ti = TK.knn(_t(q), _t(qm), _t(db), _t(dm), k=4)
    jd, ji = JK.knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db), jnp.asarray(dm), k=4)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    # exact hit: d = 0 (clamped, never negative), the lower duplicate first
    assert _np(td)[0, 0] == 0.0 and (_np(td) >= 0).all()
    np.testing.assert_array_equal(_np(ti)[0], [0, 3, 1, 4])
    # equidistant pair (0 and 1, and their copies 3 and 4): index order
    np.testing.assert_array_equal(_np(ti)[1], [0, 1, 3, 4])
    assert np.isinf(_np(td)[2]).all()

    # fewer valid points than k: the tail is +inf with index 0
    dm2 = np.zeros(len(db), bool)
    dm2[[2, 5]] = True
    td, ti = TK.knn(_t(q), _t(np.ones(3, bool)), _t(db), _t(dm2), k=5)
    jd, ji = JK.knn(jnp.asarray(q), jnp.ones(3, bool), jnp.asarray(db), jnp.asarray(dm2), k=5)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    assert np.isinf(_np(td)[:, 2:]).all() and (_np(ti)[:, 2:] == 0).all()
    np.testing.assert_array_equal(_np(ti)[:, :2], [[2, 5], [2, 5], [2, 5]])


@pytest.mark.parametrize("mode", ["same", "other"])
def test_nearest_and_ring_constrained_match(rng, mode):
    n_q, n_m = 200, 1500
    q = rng.normal(size=(n_q, 3)) * 4
    db = rng.normal(size=(n_m, 3)) * 4
    qm = rng.random(n_q) > 0.1
    dm = rng.random(n_m) > 0.05
    q_ring = rng.integers(0, 16, n_q).astype(np.int32)
    db_ring = rng.integers(0, 16, n_m).astype(np.int32)
    excl = rng.integers(0, n_m, n_q).astype(np.int32)

    td, ti = TK.nearest(_t(q), _t(qm), _t(db), _t(dm), tile=256)
    jd, ji = JK.nearest(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(db), jnp.asarray(dm),
                        tile=256)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(_np(ti)[qm], np.asarray(ji)[qm])

    args_t = (_t(q), _t(q_ring), _t(qm), _t(excl), _t(db), _t(db_ring), _t(dm))
    args_j = tuple(jnp.asarray(a) for a in (q, q_ring, qm, excl, db, db_ring, dm))
    td, ti = TK.ring_constrained_nearest(*args_t, mode=mode, ring_window=2.5, tile=256)
    jd, ji = JK.ring_constrained_nearest(*args_j, mode=mode, ring_window=2.5, tile=256)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    # float32 on the same points
    args_t32 = tuple(a.float() if a.is_floating_point() else a for a in args_t)
    td32, ti32 = TK.ring_constrained_nearest(*args_t32, mode=mode, ring_window=2.5, tile=256)
    ok = np.isfinite(_np(td))
    np.testing.assert_allclose(_np(td32)[ok], _np(td)[ok], atol=1e-4, rtol=0)
    np.testing.assert_allclose(_d64(q, db, _np(ti32))[ok], _d64(q, db, _np(ti))[ok],
                               atol=1e-4, rtol=0)


def test_cpu_tensors_take_the_plain_version(rng):
    """On the CPU the dispatch runs the plain version and the kernel's launch
    count does not move; the wrapper itself refuses CPU tensors."""
    args = tuple(_t(x) for x in _inputs(rng, n_q=50, n_m=300))  # float32
    before = TKK.LAUNCHES
    a = TK.knn(*args, k=5, prune_beyond=1.0)
    c = TK.knn_tiled(*args, k=5)
    assert TKK.LAUNCHES == before
    for x, y in zip(a, c):
        np.testing.assert_array_equal(_np(x), _np(y))
    with pytest.raises(ValueError, match="CUDA tensor"):
        TKK.knn_cuda(*args, k=5, prune_beyond=1.0)
    assert TKK.LAUNCHES == before
