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

from pathlib import Path

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


def _emulate_kernel(q, qm, db, dm, k, prune, d=None):
    """What ``csrc/knn.cu`` computes, in numpy: per 256-query block, the
    chunks the prune flags keep, ascending index, lowest index on ties.
    ``d``: the (Q, M) squared distances to use (default: float64 here)."""
    if d is None:
        d = np.sum(q.astype(np.float64)[:, None] ** 2, -1) + np.sum(
            db.astype(np.float64) ** 2, -1)[None] - 2.0 * q.astype(np.float64) @ db.T.astype(
            np.float64)
        d = np.maximum(d, 0.0)
    else:
        d = d.copy()
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


def test_geometry_constants_match_the_cuda_source():
    """The wrapper's geometry (prune block, chunk, lanes per query, queries
    per CTA, bounds record) is the one ``csrc/knn.cu`` compiles with."""
    import re

    src = (Path(TKK.__file__).resolve().parent.parent / "csrc" / "knn.cu").read_text()
    got = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    want = {"kBQ": TKK.BQ, "kBM": TKK.BM, "kTPQ": TKK.TPQ, "kQPC": TKK.QPC, "kBatch": TKK.BATCH}
    assert {name: got.get(name) for name in want} == want
    assert f"sizeof(Bounds) == {TKK.BOUNDS_BYTES}" in src
    assert TKK.BQ % TKK.QPC == 0 and 32 % TKK.TPQ == 0
    # the scratch holds bounds, the packed map and the per-chunk lists
    n_qb, n_ch = 3, 4
    assert TKK.scratch_bytes(3 * 256 - 40, 3 * 2048 + 300, 5) >= (
        (n_qb + n_ch) * TKK.BOUNDS_BYTES + (3 * 2048 + 300) * 16
        + 2 * n_ch * 5 * (3 * 256 - 40) * 4)


def _insert(bd, bi, dv, iv):
    """The kernel's strict-< insert, one candidate per row into ascending
    (R, K) lists: it lands after every entry <= it, and past K it drops."""
    k = bd.shape[1]
    pos = np.sum(bd <= dv[:, None], axis=1)
    cols = np.arange(k)[None, :]
    src = np.maximum(np.where(cols < pos[:, None], cols, cols - 1), 0)
    at = cols == pos[:, None]
    nd = np.where(at, dv[:, None], np.take_along_axis(bd, src, 1))
    ni = np.where(at, iv[:, None], np.take_along_axis(bi, src, 1))
    return nd, ni


def _merge_lanes(sd, si):
    """The kernel's shuffle rounds over (TPQ, R, K) lane lists: in round m,
    lane s (s a multiple of 2m) inserts lane s + m's list; lane 0 ends with
    the merge."""
    sd, si = sd.copy(), si.copy()
    m = 1
    while m < TKK.TPQ:
        for s in range(0, TKK.TPQ, 2 * m):
            for j in range(sd.shape[2]):
                sd[s], si[s] = _insert(sd[s], si[s], sd[s + m][:, j], si[s + m][:, j])
        m *= 2
    return sd[0], si[0]


def _emulate_decomposition(d, q, qm, db, dm, k, gate):
    """The kernel's decomposition in numpy: bounds and flags per (256-query
    block, 2048-point chunk), empty tiles skipped; per kept tile the chunk's
    valid extent cut into TPQ contiguous sub-ranges of whole BATCH-point
    batches, each scanned in index order with the strict-< insert; the sub-range lists merged as the
    shuffle rounds pair them (lane s inserts lane s + m's list); then the
    chunk lists merged the same way, each lane over a contiguous run of
    chunks, flagged chunks skipped. (The kernel's exchange of k-th bests
    only spares inserts that change no list, so it is not emulated.)
    Returns (dist, idx, flags)."""
    n_q, n_m = d.shape
    n_qb, n_ch = -(-n_q // TKK.BQ), -(-n_m // TKK.BM)
    d = np.where(dm[None, :], d, np.inf)

    def bounds(pts, valid, lo_i):
        v = pts[valid]
        return (v.min(0) if len(v) else None, v.max(0) if len(v) else None,
                lo_i + np.flatnonzero(valid))

    qb = [bounds(q[b * TKK.BQ:(b + 1) * TKK.BQ], qm[b * TKK.BQ:(b + 1) * TKK.BQ], b * TKK.BQ)
          for b in range(n_qb)]
    cb = [bounds(db[c * TKK.BM:(c + 1) * TKK.BM], dm[c * TKK.BM:(c + 1) * TKK.BM], c * TKK.BM)
          for c in range(n_ch)]
    flags = np.zeros((n_qb, n_ch), bool)
    for b in range(n_qb):
        for c in range(n_ch):
            if not len(qb[b][2]) or not len(cb[c][2]):
                flags[b, c] = True
                continue
            g = np.maximum(0, np.maximum(qb[b][0] - cb[c][1], cb[c][0] - qb[b][1]))
            g2 = (g * g).astype(np.float32)
            lb = np.float32(np.float32(g2[0] + g2[2]) + g2[1])
            flags[b, c] = not lb <= np.float32(gate if gate is not None else np.inf)

    out_d = np.full((n_q, k), np.inf)
    out_i = np.zeros((n_q, k), np.int64)
    for b in range(n_qb):
        rows = np.arange(b * TKK.BQ, min((b + 1) * TKK.BQ, n_q))
        part_d, part_i = {}, {}
        for c in range(n_ch):
            if flags[b, c]:
                continue
            first, last = cb[c][2][0], cb[c][2][-1]
            n = last + 1 - first
            length = -(-(-(-n // TKK.TPQ)) // TKK.BATCH) * TKK.BATCH
            sd = np.full((TKK.TPQ, len(rows), k), np.inf)
            si = np.zeros((TKK.TPQ, len(rows), k), np.int64)
            for t in range(length):
                m = first + np.arange(TKK.TPQ) * length + t  # one point per sub-range
                ok = m <= last
                dv = np.where(ok[:, None], d[rows][:, np.minimum(m, n_m - 1)].T, np.inf)
                nd, ni = _insert(sd.reshape(-1, k), si.reshape(-1, k), dv.reshape(-1),
                                 np.repeat(m, len(rows)))
                sd, si = nd.reshape(sd.shape), ni.reshape(si.shape)
            part_d[c], part_i[c] = _merge_lanes(sd, si)
        # the merge: lane s inserts the lists of a contiguous run of chunks,
        # ascending, flagged ones skipped; then the lanes merge as above
        per_lane = -(-n_ch // TKK.TPQ)
        md = np.full((TKK.TPQ, len(rows), k), np.inf)
        mi = np.zeros((TKK.TPQ, len(rows), k), np.int64)
        for s in range(TKK.TPQ):
            for c in range(s * per_lane, min(n_ch, (s + 1) * per_lane)):
                if flags[b, c]:
                    continue
                for j in range(k):
                    md[s], mi[s] = _insert(md[s], mi[s], part_d[c][:, j], part_i[c][:, j])
        out_d[rows], out_i[rows] = _merge_lanes(md, mi)
    out_d[~qm] = np.inf
    out_i[~qm] = 0
    return out_d, out_i, flags


def _tie_heavy(rng):
    """Coordinates on a 0.25 m grid (exact ties everywhere, across chunk and
    sub-range boundaries), spatially sorted so the gate prunes; three query
    blocks with a ragged end and an all-masked middle block; four chunks
    with an empty one, a ragged last one and masked runs at a chunk's ends
    (so the valid extent is cut)."""
    n_q, n_m = 3 * TKK.BQ - 40, 3 * TKK.BM + 300
    db = rng.integers(-12, 13, size=(n_m, 3)).astype(np.float64) * 0.25
    db = db[np.argsort(db[:, 0], kind="stable")]
    db[2 * TKK.BM + 7] = db[11]          # a duplicate straddling chunks 0 and 2
    db[2 * TKK.BM + 300] = db[2 * TKK.BM + 1500]   # and one across sub-ranges
    dm = rng.random(n_m) > 0.05
    dm[TKK.BM:2 * TKK.BM] = False        # chunk 1 empty
    dm[2 * TKK.BM:2 * TKK.BM + 5] = False
    dm[3 * TKK.BM - 200:3 * TKK.BM] = False
    q = rng.integers(-12, 13, size=(n_q, 3)).astype(np.float64) * 0.25
    q = q[np.argsort(q[:, 0], kind="stable")]
    q[5] = db[11]
    qm = rng.random(n_q) > 0.1
    qm[TKK.BQ:2 * TKK.BQ] = False        # query block 1 all masked
    return q, qm, db, dm


@pytest.mark.parametrize("gate", [None, 1.0], ids=["exact", "gated"])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_kernel_decomposition_is_bit_equal(rng, k, gate):
    """The kernel's cut (bounds and flags with empty tiles skipped, the
    per-sub-range lists, the ordered merges) returns exactly what one
    thread per query walking every kept chunk in index order returns, on
    every unmasked row: distances and indices, ties included."""
    q, qm, db, dm = _tie_heavy(rng)
    # elementwise float64 distances: identical points give identical values
    d = np.maximum((q * q).sum(1)[:, None] + (db * db).sum(1)[None, :] - 2.0 * (
        q[:, None, 0] * db[None, :, 0] + q[:, None, 1] * db[None, :, 1]
        + q[:, None, 2] * db[None, :, 2]), 0.0)
    got_d, got_i, flags = _emulate_decomposition(d, q, qm, db, dm, k, gate)
    q_empty = ~np.pad(qm, (0, flags.shape[0] * TKK.BQ - len(qm))).reshape(-1, TKK.BQ).any(1)
    c_empty = ~np.pad(dm, (0, flags.shape[1] * TKK.BM - len(dm))).reshape(-1, TKK.BM).any(1)
    empty = q_empty[:, None] | c_empty[None, :]
    assert q_empty[1] and c_empty[1]
    if gate is None:
        np.testing.assert_array_equal(flags, empty)
        want_d, want_i = _emulate_kernel(q, qm, db, dm, k, np.zeros_like(flags), d=d)
    else:
        plain = _np(TKK.prune_flags(_t(q.astype(np.float32)), _t(qm), _t(db.astype(np.float32)),
                                    _t(dm), gate)).astype(bool)
        np.testing.assert_array_equal(flags, plain)
        assert (flags & ~empty).any() and not flags.all()
        want_d, want_i = _emulate_kernel(q, qm, db, dm, k, flags, d=d)
    np.testing.assert_array_equal(got_d[qm], want_d[qm])
    np.testing.assert_array_equal(got_i[qm], want_i[qm])
    assert np.isinf(got_d[~qm]).all() and (got_i[~qm] == 0).all()
    # the data does hold ties the merges had to order
    fin = np.isfinite(want_d[qm])
    assert k == 1 or np.any((np.diff(want_d[qm], axis=1) == 0) & fin[:, 1:])


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
    before = TKK.launches()
    a = TK.knn(*args, k=5, prune_beyond=1.0)
    c = TK.knn_tiled(*args, k=5)
    assert TKK.launches() == before
    for x, y in zip(a, c):
        np.testing.assert_array_equal(_np(x), _np(y))
    with pytest.raises(ValueError, match="CUDA tensor"):
        TKK.knn_cuda(*args, k=5, prune_beyond=1.0)
    assert TKK.launches() == before
