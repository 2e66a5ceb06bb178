"""The CUDA KNN kernel on the card, against its plain version (float32).

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the reference package, so they also run where only the port is
installed; there, skip the JAX session set-up of ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: distances within 8 float32 ulps of max |q|^2 + max |p|^2
(the cross term cancels there; the kernel rounds through fmaf, the plain
version through a matmul), as ``chip_smoke.py`` checks them. Neighbours
are compared tie-robustly through the chosen points' float64 distances,
and gate decisions away from the gate's rounding band.
"""

import os
import sys

import numpy as np
import pytest
import torch

from lio_mapping_tpu_torch.ops import knn as TK
from lio_mapping_tpu_torch.ops import knn_kernel as TKK

F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _d64(q, db, idx):
    return np.sum((q.astype(np.float64)[:, None] - db.astype(np.float64)[idx]) ** 2, axis=-1)


def _tol(q, db):
    return 8 * F32_EPS * float(np.max(np.sum(q.astype(np.float64) ** 2, axis=1))
                               + np.max(np.sum(db.astype(np.float64) ** 2, axis=1)))


def _clustered(rng, n_m, n_q):
    """Clustered, spatially sorted map and queries (as the voxel filter
    emits them) at indoor ranges, so the prune gate skips chunks."""
    centers = rng.normal(size=(8, 3)).astype(np.float32) * 5
    db = centers[rng.integers(0, 8, n_m)] + rng.normal(size=(n_m, 3)).astype(np.float32) * 0.5
    db = db[np.argsort(db[:, 0], kind="stable")].astype(np.float32)
    dm = rng.random(n_m) > 0.05
    q = (centers[rng.integers(0, 8, n_q)]
         + rng.normal(size=(n_q, 3)).astype(np.float32) * 0.7).astype(np.float32)
    q = q[np.argsort(q[:, 0], kind="stable")]
    qm = rng.random(n_q) > 0.02
    return q, qm, db, dm


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [None, 1.0], ids=["exact", "gated"])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_kernel_matches_plain(dev, k, gate):
    q, qm, db, dm = _clustered(np.random.default_rng(k), n_m=9000, n_q=700)
    args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    before = TKK.LAUNCHES
    gd, gi = TK.knn(*args, k=k, prune_beyond=gate)
    assert TKK.LAUNCHES == before + 1
    rd, ri = TK.knn_tiled(*args, k=k)
    torch.cuda.synchronize()
    gd, gi, rd, ri = (x.cpu().numpy() for x in (gd, gi, rd, ri))
    tol = _tol(q, db)
    assert np.isinf(gd[~qm]).all()
    rows = qm
    if gate is not None:
        clear = np.abs(rd[:, k - 1] - gate) > tol
        rows = qm & (rd[:, k - 1] < gate)
        # beyond-gate rows report a k-th distance beyond the gate
        np.testing.assert_array_equal((gd[:, k - 1] < gate)[qm & clear], rows[qm & clear])
        rows = rows & clear
    assert rows.any()
    np.testing.assert_allclose(gd[rows], rd[rows], atol=tol, rtol=0)
    np.testing.assert_allclose(_d64(q, db, gi)[rows], _d64(q, db, ri)[rows], atol=2 * tol,
                               rtol=0)


@pytest.mark.cuda
def test_kernel_contract_ties_and_short_maps(dev):
    """Clamped at 0, the lowest index wins ties, +inf and index 0 past the
    valid points, +inf for masked queries: the plain version's contract."""
    base = np.array([[1.0, 2.0, 3.0], [1.5, 2.0, 3.0], [4.0, 4.0, 4.0]], np.float32)
    db = np.concatenate([base, base, base[:1]]).astype(np.float32)
    dm = np.array([True, True, True, True, True, True, False])
    q = np.array([[1.0, 2.0, 3.0], [1.25, 2.0, 3.0], [9.0, 9.0, 9.0]], np.float32)
    qm = np.array([True, True, False])
    t = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    d, i = (x.cpu().numpy() for x in TK.knn(*t, k=4))
    assert d[0, 0] == 0.0 and (d >= 0).all()
    np.testing.assert_array_equal(i[0], [0, 3, 1, 4])
    np.testing.assert_array_equal(i[1], [0, 1, 3, 4])
    assert np.isinf(d[2]).all()

    dm2 = np.zeros(len(db), bool)
    dm2[[2, 5]] = True
    t = [torch.as_tensor(x).to(dev) for x in (q, np.ones(3, bool), db, dm2)]
    d, i = (x.cpu().numpy() for x in TK.knn(*t, k=5))
    assert np.isinf(d[:, 2:]).all() and (i[:, 2:] == 0).all()
    np.testing.assert_array_equal(i[:, :2], [[2, 5], [2, 5], [2, 5]])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, qm, db, dm = _clustered(np.random.default_rng(0), n_m=300, n_q=50)
    args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    with pytest.raises(ValueError):
        TKK.knn_cuda(args[0].double(), *args[1:], k=5)
    with pytest.raises(ValueError):
        TKK.knn_cuda(*args, k=9)
    with pytest.raises(ValueError):
        TKK.knn_cuda(args[0][:, :2].contiguous(), *args[1:], k=5)
    with pytest.raises(ValueError):
        TKK.knn_cuda(args[0].t().contiguous().t(), *args[1:], k=5)
    with pytest.raises(ValueError):
        TKK.knn_cuda(args[0], args[1], args[2].cpu(), args[3].cpu(), k=5)


def _grid(rng, n_q, n_m):
    """Coordinates on a 0.25 m grid within 3 m: float32 evaluates every
    distance exactly, so exact ties abound (across chunk and sub-range
    boundaries) and the kernel and a float64 reference agree bit for bit.
    Spatially sorted, with an empty chunk when there are two or more, so
    the gate prunes and empty tiles occur."""
    db = (rng.integers(-12, 13, size=(n_m, 3)) * 0.25).astype(np.float32)
    db = db[np.argsort(db[:, 0], kind="stable")]
    dm = rng.random(n_m) > 0.05
    if n_m > 2 * TKK.BM:
        dm[TKK.BM:2 * TKK.BM] = False
    q = (rng.integers(-12, 13, size=(n_q, 3)) * 0.25).astype(np.float32)
    q = q[np.argsort(q[:, 0], kind="stable")]
    qm = rng.random(n_q) > 0.1
    return q, qm, db, dm


def _exact_reference(q, qm, db, dm, k, flags):
    """float64 distances (exact on the grid), the tiles in ``flags``
    skipped, the k smallest by (distance, index); +inf / 0 past the valid
    points and on masked rows."""
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    d = np.sum((q64[:, None] - db64[None]) ** 2, axis=-1)
    d[:, ~dm] = np.inf
    for b, c in zip(*np.nonzero(flags)):
        d[b * TKK.BQ:(b + 1) * TKK.BQ, c * TKK.BM:(c + 1) * TKK.BM] = np.inf
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(d, idx, axis=1)
    if dist.shape[1] < k:
        pad = k - dist.shape[1]
        dist = np.concatenate([dist, np.full((len(q), pad), np.inf)], axis=1)
        idx = np.concatenate([idx, np.zeros((len(q), pad), np.int64)], axis=1)
    idx[np.isinf(dist)] = 0
    dist[~qm], idx[~qm] = np.inf, 0
    return dist.astype(np.float32), idx


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [None, 1.0], ids=["exact", "gated"])
def test_kernel_flags_equal_prune_flags(dev, gate):
    """The kernel's tile flags: with a gate exactly ``prune_flags``, without
    one exactly the tiles with no valid query or no valid map point."""
    for seed, (n_q, n_m) in enumerate([(700, 9000), (1000, 3 * TKK.BM + 300)]):
        q, qm, db, dm = _clustered(np.random.default_rng(seed), n_m=n_m, n_q=n_q)
        qm[TKK.BQ:2 * TKK.BQ] = False
        args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
        _, _, flags = TKK.search(*args, k=5, prune_beyond=gate)
        flags = flags.cpu().numpy().astype(bool)
        if gate is None:
            q_empty = ~np.pad(qm, (0, flags.shape[0] * TKK.BQ - n_q)).reshape(-1, TKK.BQ).any(1)
            c_empty = ~np.pad(dm, (0, flags.shape[1] * TKK.BM - n_m)).reshape(-1, TKK.BM).any(1)
            np.testing.assert_array_equal(flags, q_empty[:, None] | c_empty[None, :])
        else:
            want = TKK.prune_flags(*args, gate).cpu().numpy().astype(bool)
            np.testing.assert_array_equal(flags, want)
            assert flags.any() and not flags.all()


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [None, 1.0], ids=["exact", "gated"])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_kernel_ties_across_boundaries_bit_equal(dev, k, gate):
    """On grid coordinates (exact ties everywhere, across chunk and
    sub-range boundaries) the kernel returns exactly the k smallest
    (distance, index) pairs of the tiles it keeps: the lowest index wins."""
    q, qm, db, dm = _grid(np.random.default_rng(10 + k), n_q=600, n_m=3 * TKK.BM + 300)
    db[2 * TKK.BM + 7] = db[11]  # one more duplicate straddling chunks 0 and 2
    args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    gd, gi, flags = (x.cpu().numpy() for x in TKK.search(*args, k=k, prune_beyond=gate))
    rd, ri = _exact_reference(q, qm, db, dm, k, flags.astype(bool))
    np.testing.assert_array_equal(gd[qm], rd[qm])
    np.testing.assert_array_equal(gi[qm], ri[qm])
    assert np.isinf(gd[~qm]).all() and (gi[~qm] == 0).all()
    if gate is not None:
        assert flags[:, 1].all() and not flags.all()
    fin = np.isfinite(rd[qm])
    assert k == 1 or np.any((np.diff(rd[qm], axis=1) == 0) & fin[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2 * TKK.BM + 77), (300, 5), (257, 2049)],
                         ids=["q1", "m5", "ragged"])
@pytest.mark.parametrize("k", range(1, 9))
def test_kernel_k_and_ragged_shapes(dev, k, shape):
    """Every k the kernel takes, at one query, at fewer map points than k
    and at ragged edges, against the plain version."""
    n_q, n_m = shape
    q, qm, db, dm = _clustered(np.random.default_rng(100 + k), n_m=n_m, n_q=n_q)
    qm[0] = True
    args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    gd, gi = (x.cpu().numpy() for x in TK.knn(*args, k=k))
    rd, ri = (x.cpu().numpy() for x in TK.knn_tiled(*args, k=k))
    tol = _tol(q, db)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(rd))
    fin = np.isfinite(rd)
    np.testing.assert_allclose(gd[fin], rd[fin], atol=tol, rtol=0)
    np.testing.assert_allclose(_d64(q, db, gi)[fin], _d64(q, db, ri)[fin], atol=2 * tol, rtol=0)
    assert (gi[qm][~fin[qm]] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [None, 1.0], ids=["exact", "gated"])
def test_kernel_is_deterministic(dev, gate):
    """Two calls on the same inputs give the same bits (no atomics on
    distances, a fixed merge order)."""
    q, qm, db, dm = _clustered(np.random.default_rng(7), n_m=9000, n_q=700)
    args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    a = [x.cpu().numpy() for x in TKK.search(*args, k=5, prune_beyond=gate)]
    b = [x.cpu().numpy() for x in TKK.search(*args, k=5, prune_beyond=gate)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _check_gated_at(dev, rng, n_q, n_m, n_valid_q, n_valid_m):
    """A voxel store's shape (valid rows a prefix, sorted by x as the keys
    sort it) against a voxel-filtered stack, k = 5, the 1 m^2 gate: gated
    rows exact, the flags ``prune_flags``. Returns the flags' shape."""
    k, gate = 5, 1.0
    q, qm, db, dm = _clustered(rng, n_m=n_valid_m, n_q=n_valid_q)
    db = np.concatenate([db, np.zeros((n_m - len(db), 3), np.float32)])
    dm = np.concatenate([dm, np.zeros(n_m - len(dm), bool)])
    q = np.concatenate([q, np.zeros((n_q - len(q), 3), np.float32)])
    qm = np.concatenate([qm, np.zeros(n_q - len(qm), bool)])
    args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    gd, gi, flags = TKK.search(*args, k=k, prune_beyond=gate)
    want = TKK.prune_flags(*args, gate)
    np.testing.assert_array_equal(flags.cpu().numpy(), want.cpu().numpy())
    rd, ri = TK.knn_tiled(*args, k=k)
    gd, gi, rd, ri = (x.cpu().numpy() for x in (gd, gi, rd, ri))
    tol = _tol(q, db)
    assert np.isinf(gd[~qm]).all()
    rows = qm & (rd[:, k - 1] < gate - tol)
    beyond = qm & (rd[:, k - 1] >= gate + tol)
    assert rows.sum() > 1000
    assert not (gd[beyond, k - 1] < gate - tol).any()
    np.testing.assert_allclose(gd[rows], rd[rows], atol=tol, rtol=0)
    np.testing.assert_allclose(_d64(q, db, gi)[rows], _d64(q, db, ri)[rows], atol=2 * tol,
                               rtol=0)
    return tuple(flags.shape)


@pytest.mark.cuda
def test_kernel_at_the_scan_to_map_shape(dev):
    """LOAM's scan-to-map surf search: 6144 queries against the 65536-point
    map store (32 chunks)."""
    assert _check_gated_at(dev, np.random.default_rng(21), 6144, 65536, 2500, 40000) == (24, 32)


@pytest.mark.cuda
def test_kernel_at_the_outdoor64_estimator_shape(dev):
    """The outdoor_64 estimator's surf search: 8192 queries (one HDL-64
    stack) against the 32768-row filtered local map (32 query blocks, 16
    chunks), the local map mostly full."""
    assert _check_gated_at(dev, np.random.default_rng(64), 8192, 32768, 3500, 30000) == (32, 16)


@pytest.mark.cuda
def test_viz_normals_association_kernel_against_plain(dev, tmp_path):
    """``viz-normals``' association (``cli.normals_view``: the estimator's
    5-NN plane rows on one sweep against a 10-sweep local map) through the
    kernel and through the forced plain search: the kernel is launched, the
    queries and local map are the same, and at most 0.5% of the accepted
    rows differ (accepted by one only, or normals apart by more than 1e-4:
    KNN near-ties)."""
    from lio_mapping_tpu_torch import cli
    from lio_mapping_tpu_torch.config import LioConfig

    log, gt = str(tmp_path / "seq.liol"), str(tmp_path / "gt.tum")
    assert cli.main(["simulate", "--out", log, "--sweeps", "12", "--gt-out", gt]) == 0
    before = TKK.LAUNCHES
    view = cli.normals_view(log, gt, LioConfig.indoor(), frames=10, device=dev)
    launches = TKK.LAUNCHES - before
    plain = cli.normals_view(log, gt, LioConfig.indoor(), frames=10, device=dev,
                             force_tiled=True)
    assert launches > 0 and TKK.LAUNCHES - before == launches
    np.testing.assert_array_equal(view.xyz, plain.xyz)
    np.testing.assert_array_equal(view.map_xyz, plain.map_xyz)
    both = view.ok & plain.ok
    assert both.sum() > 1000
    apart = np.abs(view.normals[both] - plain.normals[both]).max(axis=1) > 1e-4
    differing = np.sum(view.ok ^ plain.ok) + np.sum(apart)
    assert differing <= 0.005 * np.sum(view.ok | plain.ok)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [None, 1.0], ids=["exact", "gated"])
def test_ring_knn_two_ranks_on_the_card(dev, tmp_path, gate):
    """The map-sharded ring KNN with 2 ranks sharing the card (gloo, the
    ring's send/recv staged through the host) at the estimator's per-rank
    shapes (3072 queries against a 12288-row block, twice): the kernel runs
    on both ranks, distances are bit-identical to ``knn`` on the
    concatenated map (the blocks start on the kernel's 2048-row chunk
    boundaries, so every pair is computed and pruned alike), and indices
    are equal except among equal distances (a block searched earlier wins a
    tie there, the lower index in the concatenated search)."""
    from lio_mapping_tpu_torch.parallel import multihost as MH

    # by path: another installed package may own the name ``tests``; the
    # ranks unpickle ``W.ring_on_card`` through the same sys.path
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_worker as W

    q, qm, db, dm = _clustered(np.random.default_rng(21), n_m=24576, n_q=6144)
    assert MH.launch(2, W.ring_on_card, str(tmp_path), q, qm, db, dm, gate) == 0
    ref_d, ref_i = TK.knn(*(torch.as_tensor(a, device=dev) for a in (q, qm, db, dm)), k=5,
                          prune_beyond=gate)
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
    for r in range(2):
        with np.load(tmp_path / f"card{r}.npz") as z:
            d, i = z["d"], z["i"]
            assert int(z["launches"]) == 2, "one kernel search per ring step"
            assert int(z["host_bytes"]) > 0 and str(z["backend"]) == "gloo"
        np.testing.assert_array_equal(d, ref_d)
        differ = i != ref_i
        # where the indices differ, both points lie at the same distance
        d_ring, d_ref = _d64(q, db, i), _d64(q, db, ref_i)
        np.testing.assert_allclose(d_ring[differ], d_ref[differ], atol=_tol(q, db))
        assert differ.mean() < 1e-3, f"{int(differ.sum())} indices differ"
