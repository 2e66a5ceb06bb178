"""The port's CUDA kernels on the card: the KNN kernel against its plain
version (float32), the ``eigh`` kernel (float64 Householder and implicit
QL) against float64 ``torch.linalg.eigh`` and bit for bit against its
step-by-step reference, the LU solve kernel against float64
``torch.linalg.solve``, and the graphed pipelines (one CUDA graph a
bootstrap sweep, a consumed INITED sweep, a LOAM sweep and a 4D builder
step, conditional nodes for the early exits) against the eager ones.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the reference package, so they also run where only the port is
installed; there, skip the JAX session set-up of ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

KNN tolerances: distances within 8 float32 ulps of max |q|^2 + max |p|^2
(the cross term cancels there; the kernel rounds through fmaf, the plain
version through a matmul), as ``chip_smoke.py`` checks them. Neighbours
are compared tie-robustly through the chosen points' float64 distances,
and gate decisions away from the gate's rounding band.
"""

import contextlib
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
    before = TKK.launches()
    gd, gi = TK.knn(*args, k=k, prune_beyond=gate)
    assert TKK.launches() == before + 1
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
def test_cost_counter_and_count_launches_see_one_search(dev):
    """``utils/profiling`` on the card: ``count_launches`` counts the
    search's kernel launches (>= 1), and the cost counter, which does not see
    a ctypes kernel, counts only the outputs' allocations (0 flops)."""
    from lio_mapping_tpu_torch.utils.profiling import CostCounter, count_launches

    q, qm, db, dm = _clustered(np.random.default_rng(3), n_m=9000, n_q=700)
    args = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    TK.knn(*args, k=5, prune_beyond=1.0)  # built and loaded
    before = TKK.launches()
    with CostCounter() as cost:
        (d, i), counts = count_launches(lambda: TK.knn(*args, k=5, prune_beyond=1.0), dev)
    assert TKK.launches() == before + 1
    assert counts["runtime_launches"] >= 1 and counts["device_kernels"] >= 1
    assert cost.flops == 0 and set(cost.by_op) <= {"aten.empty", "aten.slice", "aten.view"}
    assert d.shape == i.shape == (700, 5)


@pytest.mark.cuda
def test_float64_search_runs_the_kernel_in_float32(dev):
    """A float64 search on the card (the float64 pipeline, ``debug_corner``)
    goes through the float32 kernel, as the reference's Pallas kernel casts
    to float32: the float32 search's neighbours, distances cast back."""
    q, qm, db, dm = _clustered(np.random.default_rng(4), n_m=9000, n_q=700)
    f32 = [torch.as_tensor(x).to(dev) for x in (q, qm, db, dm)]
    f64 = [f32[0].double(), f32[1], f32[2].double(), f32[3]]
    before = TKK.launches()
    d64, i64 = TK.knn(*f64, k=5, prune_beyond=1.0)
    assert TKK.launches() == before + 1 and d64.dtype == torch.float64
    d32, i32 = TK.knn(*f32, k=5, prune_beyond=1.0)
    assert torch.equal(i64, i32) and torch.equal(d64, d32.double())


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
def test_kernel_at_the_builder_corner_shape(dev):
    """The 4D builder's corner search: the indoor corner stack (2048 rows,
    ~2000 valid) against the 65536-row corner store, ~11.5k rows valid (8
    query blocks, 32 chunks)."""
    assert _check_gated_at(dev, np.random.default_rng(16), 2048, 65536, 2000, 11500) == (8, 32)


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
    before = TKK.launches()
    view = cli.normals_view(log, gt, LioConfig.indoor(), frames=10, device=dev)
    launches = TKK.launches() - before
    plain = cli.normals_view(log, gt, LioConfig.indoor(), frames=10, device=dev,
                             force_tiled=True)
    assert launches > 0 and TKK.launches() - before == launches
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


# ---------------------------------------------------------------------------
# the graphed INITED step (models/step_graph.py)
# ---------------------------------------------------------------------------

GRAPH_SWEEPS = 24  # the small config goes INITED on sweep 10; then 7 consumed sweeps


def _graph_cfg():
    """A small closed-loop config (window 5, optimization window 3, every
    2nd sweep consumed, narrow stacks and feature capacities) on the
    indoor profile."""
    import dataclasses

    from lio_mapping_tpu_torch.config import LioConfig

    base = LioConfig.indoor()
    est = dataclasses.replace(
        base.estimator, window_size=5, opt_window_size=3, init_window_factor=1, odom_io=2,
        estimate_extrinsic=0, opt_extrinsic=False, extrinsic_rotation=(1, 0, 0, 0, 1, 0, 0, 0, 1),
        extrinsic_translation=(0.0, 0.0, 0.0), surf_stack_cap=2048, local_map_filtered_cap=8192,
        features_per_frame_cap=2048, max_solver_iterations=8)
    feat = dataclasses.replace(base.feature, corner_sharp_cap=128, corner_less_sharp_cap=1024,
                               surf_flat_cap=256, surf_less_flat_cap=2048)
    return dataclasses.replace(base, estimator=est, feature=feat)


def _graph_sweeps(cfg):
    from lio_mapping_tpu_torch.io import synthetic as S

    traj = S.Trajectory(g_norm=cfg.estimator.imu.g_norm)
    dt = cfg.sensor.scan_period
    out = []
    for i in range(GRAPH_SWEEPS):
        xyz, mask = S.simulate_sweep(traj, i * dt, n_azimuth=540)
        ts, acc, gyr = S.simulate_imu_interval(traj, i * dt, i * dt + dt, 200.0)
        a0, w0 = traj.imu(i * dt)
        out.append((xyz, mask, (np.diff(np.concatenate([[i * dt], ts])), acc, gyr, a0, w0)))
    return out


@pytest.fixture(scope="module")
def graph_runs():
    """The small config's sweeps through a graphed pipeline (the default on
    the card) and an eager one (``graphs=False``): per sweep the outputs
    on the host and the kernel's launches, and both final states."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from lio_mapping_tpu_torch.models.pipeline import LioPipeline
    from lio_mapping_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = _graph_cfg()
    sweeps = _graph_sweeps(cfg)
    runs = {}
    for graphs in (True, False):
        pipe = LioPipeline(cfg, device="cuda", graphs=None if graphs else False)
        assert pipe.graphs == graphs
        outs, launches = [], []
        for xyz, mask, imu in sweeps:
            before = TKK.launches()
            out = pipe.process(xyz, mask, pipe.make_samples(*imu))
            torch.cuda.synchronize()
            launches.append(TKK.launches() - before)
            outs.append(tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t, out))
        runs[graphs] = {"outs": outs, "launches": launches, "pipe": pipe,
                        "state": [t.cpu() for t in tree_leaves((pipe.est_state,
                                                                pipe.odom_state))]}
    return runs


@pytest.mark.cuda
def test_graphed_step_equals_the_eager_step_bit_for_bit(graph_runs):
    """The cold start (each bootstrap sweep's front end and odometry one
    graph), six or more consumed INITED sweeps and the skipped sweeps'
    predicts through the replayed graphs give the eager pipeline's outputs
    and final states bit for bit."""
    from lio_mapping_tpu_torch.utils.tree import tree_leaves

    g, e = graph_runs[True], graph_runs[False]
    consumed = [i for i, o in enumerate(e["outs"]) if o["stage"] == "INITED" and "body_pose" in o]
    assert len(consumed) >= 6
    for i, (og, oe) in enumerate(zip(g["outs"], e["outs"])):
        assert sorted(og) == sorted(oe), i
        for key in oe:
            for a, b in zip(tree_leaves(og[key]), tree_leaves(oe[key])):
                if torch.is_tensor(b):
                    assert torch.equal(a, b), (i, key)
    for a, b in zip(g["state"], e["state"]):
        assert torch.equal(a, b)
    stats = g["pipe"]._step_graphs.stats
    assert stats["replays"] > stats["captures"] > 0
    mem = g["pipe"]._step_graphs.memory_bytes()
    assert mem["pool"] > 0 and mem["static"] > 0


@pytest.mark.cuda
def test_knn_launches_of_a_replay_equal_the_eager_sweep(graph_runs):
    """The kernel's launches counted per sweep, replays included, equal the
    eager sweep's (the searches inside a graph are counted at each replay)."""
    assert graph_runs[True]["launches"] == graph_runs[False]["launches"]
    assert sum(graph_runs[True]["launches"]) > 0


@pytest.mark.cuda
def test_count_launches_sees_the_graphs(graph_runs):
    """``count_launches`` on a graphed consumed sweep counts its graph
    launches and the device kernels inside them, with far fewer launch
    calls than kernels."""
    from lio_mapping_tpu_torch.utils.profiling import count_launches

    pipe = graph_runs[True]["pipe"]
    xyz, mask, imu = _graph_sweeps(pipe.cfg)[-1]
    if not pipe.will_consume():
        pipe.process(xyz, mask, pipe.make_samples(*imu))
    out, c = count_launches(lambda: pipe.process(xyz, mask, pipe.make_samples(*imu)), "cuda")
    assert "body_pose" in out
    assert c["graph_launches"] > 0
    assert c["device_kernels"] > 4 * c["runtime_launches"]


@pytest.mark.cuda
def test_graphed_steady_sweeps_make_no_host_sync(graph_runs):
    """Steady graphed sweeps (a consumed one: one graph launch, the mini-GN's
    and the LM's exits decided by conditional nodes; and a skipped one) run
    under ``torch.cuda.set_sync_debug_mode("error")`` without raising, and
    give the same pose as they did before the mode was set."""
    pipe = graph_runs[True]["pipe"]
    assert pipe.graphs and pipe.stage == "INITED"
    sweeps = _graph_sweeps(pipe.cfg)[-4:]
    outs = []
    torch.cuda.synchronize()
    captures = pipe.graph_captures()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for xyz, mask, imu in sweeps:
            outs.append(pipe.process(xyz, mask, pipe.make_samples(*imu)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert pipe.graph_captures() == captures
    assert sum("body_pose" in o for o in outs) >= 1
    assert sum(bool(o.get("predicted")) for o in outs) >= 1
    assert all(torch.isfinite(o["laser_pose"].t).all() for o in outs)


@pytest.mark.cuda
def test_graphed_bootstrap_sweeps_make_no_host_sync(dev):
    """A fresh graphed pipeline on the small config: after the bootstrap's
    two graphs are captured (a pushed and an unpushed sweep), bootstrap
    sweeps without an init attempt (front end and odometry, the GN's 25
    iterations as conditional nodes, a push's stacks) run under
    ``torch.cuda.set_sync_debug_mode("error")``, one graph launch each,
    and give the eager pipeline's poses bit for bit."""
    from lio_mapping_tpu_torch.models.pipeline import LioPipeline

    cfg = _graph_cfg()
    sweeps = _graph_sweeps(cfg)[:8]
    pipes = [LioPipeline(cfg, device="cuda"), LioPipeline(cfg, device="cuda", graphs=False)]
    outs = [[], []]
    for k, (xyz, mask, imu) in enumerate(sweeps):
        for p, o in zip(pipes, outs):
            steady = p.graphs and k >= 4
            n0, c0 = len(p._init_odom_poses), p.graph_captures()
            torch.cuda.synchronize()
            if steady:
                torch.cuda.set_sync_debug_mode("error")
            try:
                o.append(p.process(xyz, mask, p.make_samples(*imu)))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if steady:
                assert p.graph_captures() == c0 and o[-1]["stage"] == "NOT_INITED"
                o[-1]["pushed"] = len(p._init_odom_poses) > n0
    assert any(o.get("pushed") for o in outs[0]) and any(o.get("pushed") is False
                                                         for o in outs[0])
    assert pipes[0].graph_captures() == 2
    for og, oe in zip(*outs):
        assert torch.equal(og["laser_pose"].q, oe["laser_pose"].q)
        assert torch.equal(og["laser_pose"].t, oe["laser_pose"].t)
        assert torch.equal(og["surf_cloud"].xyz, oe["surf_cloud"].xyz)


@contextlib.contextmanager
def _searches(out: dict):
    """Every KNN search counted inside the block, kernel and plain, into
    ``out[(kind, shape)]``; the searches of conditional bodies that ran on
    the device are settled as the block ends (and those of earlier graphs'
    bodies before it starts, which would be counted in it otherwise)."""
    from lio_mapping_tpu_torch.ops import launches as LC

    def listen(kind, shape, stack):
        if kind in ("kernel", "plain"):
            out[(kind, shape)] = out.get((kind, shape), 0) + 1

    LC.settle()
    LC.LISTENERS.append(listen)
    try:
        yield out
    finally:
        LC.settle()
        LC.LISTENERS.remove(listen)


def _loam_cfg():
    """The small config with a narrow LOAM map store and stacks."""
    import dataclasses

    base = _graph_cfg()
    return dataclasses.replace(
        base, mapping=dataclasses.replace(base.mapping, map_cloud_cap=8192),
        estimator=dataclasses.replace(base.estimator, corner_stack_cap=512,
                                      surf_stack_cap=2048))


@pytest.mark.cuda
def test_graphed_loam_equals_eager_and_makes_no_host_sync(dev):
    """``LoamPipeline`` graphed (the default on the card: the mapped and the
    associated sweep one graph each) against ``graphs=False`` over ten
    sweeps, bit for bit (poses and final states); the sweeps after both
    graphs were captured run under the sync-debug mode's "error"."""
    from lio_mapping_tpu_torch.models.pipeline import LoamPipeline
    from lio_mapping_tpu_torch.utils.tree import tree_leaves

    cfg = _loam_cfg()
    sweeps = _graph_sweeps(cfg)[:10]
    pipes = [LoamPipeline(cfg, device="cuda"), LoamPipeline(cfg, device="cuda", graphs=False)]
    assert pipes[0].graphs and not pipes[1].graphs
    outs = [[], []]
    for k, (xyz, mask, _) in enumerate(sweeps):
        for p, o in zip(pipes, outs):
            torch.cuda.synchronize()
            if p.graphs and k >= 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                o.append(p.process(xyz, mask))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    assert pipes[0].graph_captures() == 2
    for og, oe in zip(*outs):
        for key in ("laser_pose", "odom_pose"):
            assert torch.equal(og[key].q, oe[key].q) and torch.equal(og[key].t, oe[key].t)
    for a, b in zip(tree_leaves((pipes[0].map_state, pipes[0].odom_state)),
                    tree_leaves((pipes[1].map_state, pipes[1].odom_state))):
        assert torch.equal(a, b)
    assert int(pipes[0].map_state.surf_map.mask.sum()) > 100


@pytest.mark.cuda
def test_graphed_loam_corner_search_stays_plain(dev):
    """LOAM's scan-to-map corner search stays on the plain tiled version
    in the graphed pipeline (its surf search takes the kernel): every
    mapped GN body makes one plain corner search and one kernel surf
    search, and no kernel search has the corner shape."""
    from lio_mapping_tpu_torch.models.pipeline import LoamPipeline

    cfg = _loam_cfg()
    e, cap = cfg.estimator, cfg.mapping.map_cloud_cap
    corner, surf = f"{e.corner_stack_cap}x{cap}x5", f"{e.surf_stack_cap}x{cap}x5"
    pipe = LoamPipeline(cfg, device="cuda")
    counts = {}
    with _searches(counts):
        for xyz, mask, _ in _graph_sweeps(cfg)[:8]:
            pipe.process(xyz, mask)
        torch.cuda.synchronize()
    assert pipe.graphs and pipe.graph_captures() == 2
    assert counts.get(("plain", corner), 0) == counts.get(("kernel", surf), 0) > 0
    assert ("kernel", corner) not in counts and ("plain", surf) not in counts


@pytest.mark.cuda
def test_graphed_map_builder_equals_eager(graph_runs):
    """``MapBuilder`` graphed against ``graphs=False`` on the consumed
    INITED sweeps' outputs of the graphed pipeline: poses and final state
    bit for bit; steps after the capture make no host sync. Both builders'
    searches, corner and surf, take the kernel and none the plain
    version; after the capture (whose warm-up runs every GN body once) a
    graphed step makes the eager step's searches, one corner and one surf
    search a GN body that ran. The builder's corner stack is narrowed to
    1024 rows, so that its two searches differ in shape."""
    import dataclasses

    from lio_mapping_tpu_torch.models.map_builder import MapBuilder
    from lio_mapping_tpu_torch.utils.tree import tree_leaves, tree_map

    outs = [o for o in graph_runs[True]["outs"] if o["stage"] == "INITED" and "body_pose" in o]
    cfg = graph_runs[True]["pipe"].cfg
    cfg = dataclasses.replace(cfg, estimator=dataclasses.replace(cfg.estimator,
                                                                 corner_stack_cap=1024))
    e, cap = cfg.estimator, cfg.mapping.map_cloud_cap
    corner, surf = f"{e.corner_stack_cap}x{cap}x5", f"{e.surf_stack_cap}x{cap}x5"
    assert corner != surf
    builders = [MapBuilder(cfg, "cuda"), MapBuilder(cfg, "cuda", graphs=False)]
    assert builders[0].graphs and not builders[1].graphs
    poses, searches = [[], []], [[], []]
    for k, o in enumerate(outs):
        o = tree_map(lambda t: t.cuda() if torch.is_tensor(t) else t, o)
        for b, ps, ss in zip(builders, poses, searches):
            torch.cuda.synchronize()
            with _searches({}) as counts:
                if b.graphs and k >= 1:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    ps.append(b.step(o["corner_cloud"], o["surf_cloud"],
                                     o["laser_pose"])["pose"])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            ss.append(counts)
    assert len(outs) >= 3 and builders[0].graph_captures() == 1
    for a, b in zip(*poses):
        assert torch.equal(a.q, b.q) and torch.equal(a.t, b.t)
    for a, b in zip(tree_leaves(builders[0].state), tree_leaves(builders[1].state)):
        assert torch.equal(a, b)
    for ss in searches:
        assert set().union(*ss) == {("kernel", corner), ("kernel", surf)}
    assert searches[0][1:] == searches[1][1:]
    for counts in searches[1]:
        assert counts.get(("kernel", corner), 0) == counts.get(("kernel", surf), 0)
    assert sum(c.get(("kernel", corner), 0) for c in searches[1][1:]) > 0


@pytest.mark.cuda
def test_capture_meeting_a_host_read_raises(dev):
    """A stretch that reads a tensor back to the host cannot be captured:
    the runner raises (its warm-up ran eagerly) and does not fall back. Run
    in a subprocess: a failed capture leaves the process's CUDA state to
    the test alone."""
    import subprocess

    code = (
        "import torch\n"
        "from lio_mapping_tpu_torch.models.step_graph import StepGraphs\n"
        "g = StepGraphs('cuda')\n"
        "v = {'x': torch.ones(4, device='cuda')}\n"
        "try:\n"
        "    g.stretch(('bad',), lambda v: {'y': v['x'] * float(v['x'].sum())}, v)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "else:\n"
        "    print('CAPTURED', g.stats)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=root, timeout=300)
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the eigh kernel (csrc/eigh.cu, ops/eigh.py)
# ---------------------------------------------------------------------------

def _sym_cases(n, seed):
    """(name, float64 matrix) cases of order ``n``: a Wishart matrix, a
    graded one (a Wishart's correlation scaled by d_i d_j with d over 15
    decades, as the Schur complements' bias blocks), a degenerate one with
    repeated eigenvalues (half zero, the rest in pairs) and a diagonal
    one."""
    rng = np.random.default_rng(seed)
    j = rng.normal(size=(2 * n, n))
    wish = j.T @ j
    s = np.sqrt(np.diag(wish))
    d = 10.0 ** rng.uniform(-3, 12, size=n)
    graded = wish / np.outer(s, s) * np.sqrt(np.outer(d, d))
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.zeros(n)
    ev[n // 2:] = (np.arange(n - n // 2) // 2 + 1).astype(np.float64)
    degenerate = q @ np.diag(ev) @ q.T
    return [("wishart", wish), ("graded", graded), ("degenerate_repeated", degenerate),
            ("diagonal", np.diag(rng.uniform(-5.0, 5.0, size=n)))]


#: eigenvalues within this many float32 ulps of max |lambda| of the float64
#: truth of the float32-rounded matrix, the reconstruction V diag(l) V^T
#: within it (relative, Frobenius) and V^T V - I elementwise (the kernel
#: works in float64 and rounds its outputs to float32 once).
#: The float64 kernel: the same in float64 ulps, vectors within 1e-12 (the
#: CPU rehearsal measured <= 6e-15 at n = 128). Wishart and graded matrices:
#: each float32 eigenvalue within 1e-4 of the float64 kernel's, relative to
#: itself (both entry points run the same float64 arithmetic on the same
#: values, so they differ by the float32 rounding of the outputs)
EIGH_VAL_ULPS = 64
EIGH_VEC_TOL = 2e-4
EIGH_VEC_TOL64 = 1e-12
EIGH_SELF_REL = 1e-4


def _eigh_against(a, vals, vecs, ref_vals, eps, vec_tol):
    """Eigenvalues, ascending order, reconstruction and orthogonality of
    (vals, vecs) of ``a`` against ``ref_vals`` (float64)."""
    n = a.shape[-1]
    a64, v64, w64 = a.double(), vals.double(), vecs.double()
    scale = float(ref_vals.abs().max())
    err = float((v64 - ref_vals).abs().max())
    rec = float(torch.linalg.norm(w64 @ torch.diag(v64) @ w64.T - a64)
                / max(float(torch.linalg.norm(a64)), 1e-30))
    orth = float((w64.T @ w64 - torch.eye(n, dtype=torch.float64, device=a.device)).abs().max())
    assert err <= EIGH_VAL_ULPS * eps * scale, (err, scale)
    assert bool((vals[1:] >= vals[:-1]).all())
    assert rec <= vec_tol and orth <= vec_tol, (rec, orth)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 15, 51, 81, 111, 128])
def test_eigh_kernel_against_float64(dev, n):
    """Eigenvalues, reconstruction, orthogonality and ascending order of the
    kernel against ``torch.linalg.eigh`` in float64 on the same float32
    matrices; its bits equal ``eigh_tridiag_reference``'s on the card; on
    Wishart and graded matrices each eigenvalue agrees with the float64
    kernel's relative to itself; one launch a call, counted."""
    from lio_mapping_tpu_torch.ops import eigh as TEIGH

    for name, m in _sym_cases(n, n):
        a = torch.as_tensor(m, dtype=torch.float32, device=dev)
        before = TEIGH.launches()
        vals, vecs = TEIGH.eigh(a)
        torch.cuda.synchronize()
        assert TEIGH.launches() == before + 1
        _eigh_against(a, vals, vecs, torch.linalg.eigh(a.double())[0], F32_EPS, EIGH_VEC_TOL)
        rv, rw, _ = TEIGH.eigh_tridiag_reference(a)
        assert torch.equal(vals, rv) and torch.equal(vecs, rw), name
        if name in ("wishart", "graded") and n <= TEIGH.MAX_N_F64:
            v64, _ = TEIGH.eigh(a.double())
            rel = float(((vals.double() - v64).abs() / v64.abs()).max())
            assert rel <= EIGH_SELF_REL, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 51, 111, 128])
def test_eigh_kernel_float64(dev, n):
    """The float64 kernel (``tools/debug_corner``'s float64 pipeline) against
    ``torch.linalg.eigh`` in float64 up to its largest order, and its bits
    against ``eigh_tridiag_reference``'s on the card."""
    from lio_mapping_tpu_torch.ops import eigh as TEIGH

    for name, m in _sym_cases(n, n):
        a = torch.as_tensor(m, dtype=torch.float64, device=dev)
        vals, vecs = TEIGH.eigh(a)
        assert vals.dtype == vecs.dtype == torch.float64
        _eigh_against(a, vals, vecs, torch.linalg.eigh(a)[0], 2.0 ** -52, EIGH_VEC_TOL64)
        rv, rw, _ = TEIGH.eigh_tridiag_reference(a)
        assert torch.equal(vals, rv) and torch.equal(vecs, rw), name


def _step_case(name):
    """(kind, float32 matrix, extra) of ``tests/test_torch_eigh.py``'s case
    ``name`` from the same seed, its Schur complements built by the port's
    ``ops/marginalization`` in float64 on the CPU (the card's test imports
    no JAX)."""
    from lio_mapping_tpu_torch.ops import marginalization as TMG

    rng = np.random.default_rng(sum(map(ord, name)))

    def graded(full, null=4):
        j = rng.normal(size=(3 * full, full)) * 10.0 ** rng.uniform(0.0, 6.0, size=full)
        j[:, full - null:] = 0.0
        return j.T @ j, j.T @ rng.normal(size=3 * full)

    if name == "gn6":
        j = rng.normal(size=(400, 6)) * np.array([3.0, 3.0, 3.0, 1.0, 1.0, 1.0])
        j[:, 5] = j[:, 3] + j[:, 4] + 1e-3 * rng.normal(size=400)
        return "gn", np.float32(j.T @ j), None
    if name == "eq15":
        a, _ = graded(15, null=0)
        a_s, d = TMG.equilibrate(torch.as_tensor(a, dtype=torch.float32))
        return "pinv", a_s.numpy(), d.numpy()
    n = {"schur51": 51, "schur111": 111}[name]
    a, b = graded(15 + n)
    a_new, b_new = TMG.schur_marginalize(torch.as_tensor(a), torch.as_tensor(b), 15)
    return "factor", np.float32((0.5 * (a_new + a_new.T)).numpy()), np.float32(b_new.numpy())


def _step_invariants(kind, extra, vals, vecs):
    """What the step makes of (vals, vecs), in float64 on their device:
    ``tests/test_torch_eigh.py``'s invariants."""
    from lio_mapping_tpu_torch.ops import gn as TGN
    from lio_mapping_tpu_torch.ops import marginalization as TMG

    vals, vecs = vals.double(), vecs.double()
    if kind == "gn":
        g = TGN.projection_from_eigh(vals, vecs, 100.0)
        return {"proj": g.proj, "degenerate": bool(g.is_degenerate)}
    extra = torch.as_tensor(extra, dtype=torch.float64, device=vals.device)
    if kind == "pinv":
        return {"pinv": TMG.pinv_from_eigh(vals, vecs, extra, TMG.EPS)}
    jac, res = TMG.factor_from_eigh(vals, vecs, extra)
    return {"jtj": jac.T @ jac, "jtr": jac.T @ res}


#: ``tests/test_torch_eigh.py``'s tolerances of the kernel's algorithm's
#: invariants against the plain version's (relative to the largest entry)
STEP_TOL = {"proj": 1e-4, "pinv": 1e-3, "jtj": 64 * F32_EPS, "jtr": 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gn6", "eq15", "schur51", "schur111"])
def test_eigh_kernel_holds_the_step_invariants(dev, name):
    """On the matrices the step decomposes (the degeneracy projection's
    6x6, the equilibrated 15x15, graded Schur complements with a null
    gauge), what the step makes of the kernel's decomposition against what
    it makes of the plain version's: the projector, the pseudo-inverse and
    J^T J, J^T r of the prior's factor, whose rows the small eigenvalues
    decide."""
    from lio_mapping_tpu_torch.ops import eigh as TEIGH

    kind, a32, extra = _step_case(name)
    a = torch.as_tensor(a32, device=dev)
    mine = _step_invariants(kind, extra, *TEIGH.eigh(a))
    plain = _step_invariants(kind, extra, *TEIGH.eigh_plain(a.double()))
    for key, value in mine.items():
        if isinstance(value, bool):
            assert value == plain[key], key
        else:
            rel = float((value - plain[key]).abs().max() / plain[key].abs().max())
            assert rel <= STEP_TOL[key], (key, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_eigh_kernel_on_tiny_blocks(dev, dtype):
    """Blocks 1e-150 and 1e-160 of the matrix's scale (a near-null space
    reduced below the square root of the least normal number, as a real
    sweep's Schur complement gave): finite, the reference's bits, and
    eigenvalues within 64 ulps of the type of the plain version's."""
    from lio_mapping_tpu_torch.ops import eigh as TEIGH

    rng = np.random.default_rng(5)
    m = np.zeros((40, 40))
    for lo, hi, scale in ((0, 32, 1.0), (32, 36, 1e-150), (36, 40, 1e-160)):
        j = rng.normal(size=(2 * (hi - lo), hi - lo))
        m[lo:hi, lo:hi] = scale * (j.T @ j)
    a = torch.as_tensor(m, dtype=dtype, device=dev)
    vals, vecs = TEIGH.eigh(a)
    assert bool(torch.isfinite(vals).all()) and bool(torch.isfinite(vecs).all())
    rv, rw, _ = TEIGH.eigh_tridiag_reference(a)
    assert torch.equal(vals, rv) and torch.equal(vecs, rw)
    pv = torch.linalg.eigh(a.double())[0]
    eps = float(torch.finfo(dtype).eps)
    assert float((vals.double() - pv).abs().max()) <= EIGH_VAL_ULPS * eps * float(pv.abs().max())


@pytest.mark.cuda
def test_eigh_kernel_batches_and_is_deterministic(dev):
    """A batch of matrices in one launch gives each matrix's own result,
    and repeated launches give the same bits."""
    from lio_mapping_tpu_torch.ops import eigh as TEIGH

    mats = torch.stack([torch.as_tensor(m, dtype=torch.float32)
                        for _, m in _sym_cases(15, 7)]).to(dev)
    vals, vecs = TEIGH.eigh(mats)
    for i in range(mats.shape[0]):
        v1, w1 = TEIGH.eigh(mats[i])
        assert torch.equal(v1, vals[i]) and torch.equal(w1, vecs[i])
    for _ in range(3):
        v2, w2 = TEIGH.eigh(mats)
        assert torch.equal(v2, vals) and torch.equal(w2, vecs)


@pytest.mark.cuda
def test_eigh_kernel_refuses_what_it_does_not_take(dev):
    """Above ``MAX_N`` (float32) or ``MAX_N_F64`` (float64), not square, a
    type other than float32 and float64: raises, nothing falls back."""
    from lio_mapping_tpu_torch.ops import eigh as TEIGH

    before = TEIGH.launches()
    for bad in (torch.zeros((TEIGH.MAX_N + 1,) * 2, device=dev),
                torch.zeros((TEIGH.MAX_N_F64 + 1,) * 2, dtype=torch.float64, device=dev),
                torch.zeros((4, 5), device=dev),
                torch.zeros((4, 4), dtype=torch.float16, device=dev)):
        with pytest.raises(ValueError):
            TEIGH.eigh(bad)
    assert TEIGH.launches() == before
    vals, _ = TEIGH.eigh(torch.eye(4, dtype=torch.float64, device=dev) * 2.0)
    assert TEIGH.launches() == before + 1
    assert vals.dtype == torch.float64 and torch.equal(vals, torch.full((4,), 2.0,
                                                                       dtype=torch.float64,
                                                                       device=dev))


# ---------------------------------------------------------------------------
# the LU solve kernel (csrc/lu_solve.cu, ops/lu_solve.py)
# ---------------------------------------------------------------------------

def _damped(n, seed):
    """An LM-like damped normal-equation system: J^T J over six decades of
    column scales plus a 1e-4 relative diagonal, and a right-hand side."""
    rng = np.random.default_rng(seed)
    j = rng.normal(size=(3 * n, n)) * 10.0 ** rng.uniform(0.0, 3.0, size=n)
    a = j.T @ j
    a += 1e-4 * np.diag(np.diag(a))
    return a, rng.normal(size=n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 66, 96, 126, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_lu_solve_kernel_against_float64(dev, n, dtype):
    """The kernel's x against float64 ``torch.linalg.solve`` on the same
    rounded system: the residual |A x - b| within 64 ulps of the type times
    |A| |x| (LU with partial pivoting is backward stable), and the plain
    version's x (cuSOLVER, same type) within the same error; one launch,
    counted."""
    from lio_mapping_tpu_torch.ops import lu_solve as TLU

    a_np, b_np = _damped(n, n)
    a = torch.as_tensor(a_np, dtype=dtype, device=dev)
    b = torch.as_tensor(b_np, dtype=dtype, device=dev)
    before = TLU.launches()
    x = TLU.solve(a, b)
    torch.cuda.synchronize()
    assert TLU.launches() == before + 1 and x.dtype == dtype
    eps = float(torch.finfo(dtype).eps)
    a64, b64, x64 = a.double(), b.double(), x.double()
    res = float((a64 @ x64 - b64).abs().max())
    scale = float((a64.abs() @ x64.abs()).max())
    assert res <= 64 * eps * scale, (res, scale)
    ref = torch.linalg.solve(a64, b64)
    plain = TLU.solve_plain(a, b).double()
    err_k = float((x64 - ref).abs().max())
    err_p = float((plain - ref).abs().max())
    assert err_k <= max(4 * err_p, 64 * eps * float(ref.abs().max())), (err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 9, 16, 17, 33, 64, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_lu_solve_kernel_every_width(dev, n, dtype):
    """Each padded width the kernel is built for (8, 16, 32, 64, 128; four
    threads a row for float64 at 128) at its edges: the residual within 64
    ulps of |A| |x|, as above."""
    from lio_mapping_tpu_torch.ops import lu_solve as TLU

    a_np, b_np = _damped(n, 100 + n)
    a = torch.as_tensor(a_np, dtype=dtype, device=dev)
    b = torch.as_tensor(b_np, dtype=dtype, device=dev)
    x = TLU.solve(a, b).double()
    res = float((a.double() @ x - b.double()).abs().max())
    scale = float((a.double().abs() @ x.abs()).max())
    assert res <= 64 * float(torch.finfo(dtype).eps) * scale, (res, scale)


@pytest.mark.cuda
def test_lu_solve_kernel_contract(dev):
    """Deterministic across launches; a singular system gives non-finite
    entries; what the kernel does not take raises and launches nothing."""
    from lio_mapping_tpu_torch.ops import lu_solve as TLU

    a_np, b_np = _damped(126, 3)
    a = torch.as_tensor(a_np, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
    x = TLU.solve(a, b)
    for _ in range(3):
        assert torch.equal(TLU.solve(a, b), x)
    sing = TLU.solve(torch.zeros((4, 4), device=dev), torch.ones(4, device=dev))
    assert not bool(torch.isfinite(sing).all())
    before = TLU.launches()
    for bad_a, bad_b in ((torch.zeros((129, 129), device=dev), torch.zeros(129, device=dev)),
                         (torch.zeros((4, 5), device=dev), torch.zeros(4, device=dev)),
                         (torch.zeros((4, 4), device=dev), torch.zeros((4, 2), device=dev)),
                         (torch.zeros((4, 4), dtype=torch.float16, device=dev),
                          torch.zeros(4, dtype=torch.float16, device=dev))):
        with pytest.raises(ValueError):
            TLU.solve(bad_a, bad_b)
    assert TLU.launches() == before


# ---------------------------------------------------------------------------
# the program's tracer (utils/timing.py, csrc/graph_if.cu's stamp kernel)
# ---------------------------------------------------------------------------

@pytest.fixture
def tracer(dev):
    from lio_mapping_tpu_torch.utils import timing as TM

    tr = TM.enable(dev)
    yield tr
    TM.disable()


N_BODIES = 5


def _countdown(g):
    """A graph program: a stretch, ``N_BODIES`` bodies each run while the
    count ``x`` (from the input ``n``) is above 0, and a matrix product
    times what is left of the count."""
    def program(v):
        g.stretch(("head",), lambda v: {"x": v["n"].clone(), "stop": v["n"] <= 0}, v)
        for it in range(N_BODIES):
            g.when(v, "stop", ("body", it),
                   lambda v: {"x": v["x"] - 1, "stop": (v["x"] - 1) <= 0})
        return {"y": (v["m"] @ v["m"]) * v["x"]}
    return program


def _replay_countdown(g, counts, dev):
    m = torch.ones((64, 64), device=dev)
    for n in counts:
        v = {}
        g.bind(v, "m", m)
        g.bind(v, "n", torch.tensor(n, device=dev))
        g.stretch(("countdown",), _countdown(g), v)
        yield v


@pytest.mark.cuda
def test_stamp_kernel_builds_and_stamps_in_order(tracer):
    """Stamps launched from the host land in the ring in launch order, on a
    clock that does not go back, mapped to the host clock between two
    calibrations of a narrow bracket."""
    from lio_mapping_tpu_torch.utils import timing as TM

    tags = [TM.tag("order", f"s.{i}") for i in range(200)]
    x = torch.ones((256, 256), device=tracer.device)
    for t in tags:
        tracer.stamp(t)
        x = x @ x * 1e-3
    rec = tracer.collect()
    st = rec["stamps"]
    assert st["tag"].tolist() == tags
    assert (np.diff(st["ns"]) >= 0).all() and st["ns"][-1] > st["ns"][0]
    cal = rec["clock"]["calibrations"]
    assert len(cal) == 2 and rec["clock"]["lost"] == 0 and rec["clock"]["on_card"]
    assert cal[0][0] <= st["ns"][0] and st["ns"][-1] <= cal[1][0]
    assert (cal[:, 2] < 1_000_000).all(), cal
    print("stamp kernel: brackets", cal[:, 2].tolist(), "ns; drift", rec["clock"]["drift_ppm"])


@pytest.mark.cuda
def test_stamps_in_conditional_bodies_match_the_body_counters(dev, tracer):
    """A graph of conditional bodies replayed with counts 0 to 7: each
    replay stamps the bodies the device ran (start and end), none of those
    it skipped, and the stamps add up to the bodies' device counters."""
    from lio_mapping_tpu_torch.models import step_graph as SG
    from lio_mapping_tpu_torch.utils import timing as TM

    g = SG.StepGraphs(dev)
    counts = [3] + list(range(8)) * 2
    ys = [float(v["y"][0, 0]) for v in _replay_countdown(g, counts, dev)]
    assert g.stats["captures"] == 1 and g.stats["replays"] == len(counts) - 1
    rec = tracer.collect()
    runs = [r for r in TM.graph_instances(rec) if r["graph"] == "countdown"]
    # the first call's warm-up ran eagerly (its bodies stamped), its capture ran nothing
    assert len(runs) == len(counts)
    for r, n in zip(runs, counts):
        bodies = [s for s, e, _ in r["marks"] if s.startswith("body.") and e == "start"]
        ends = [s for s, e, _ in r["marks"] if s.startswith("body.") and e == "end"]
        assert bodies == ends == [f"body.{k}" for k in range(min(n, N_BODIES))], n
        assert [s for s, e, _ in r["marks"] if e == "at"] == ["head"]
    b = rec["bodies"]
    assert b["body"].tolist() == [f"body.{k}" for k in range(N_BODIES)]
    stamped = [sum(1 for r in runs[1:] for s, e, _ in r["marks"]
                   if s == f"body.{k}" and e == "start") for k in range(N_BODIES)]
    assert b["runs"].tolist() == stamped
    assert ys[1:] == [64.0 * max(n - N_BODIES, 0) for n in counts[1:]]


@pytest.mark.cuda
def test_clock_drift_over_50_s(dev, tracer):
    """Over 50 s of stamps: the drift between the first and the last
    calibration is reported, and a calibration taken halfway lies within
    50 us of the straight line through them."""
    import time

    from lio_mapping_tpu_torch.utils import timing as TM

    tick = TM.tag("drift", "tick")
    x = torch.ones((512, 512), device=dev)
    t_end = time.time() + 50.0
    halfway = None
    while time.time() < t_end:
        tracer.stamp(tick)
        x = (x @ x) * 1e-3
        if halfway is None and time.time() > t_end - 25.0:
            tracer.calibrate()
            halfway = tracer._cal[-1]
        time.sleep(0.01)
    rec = tracer.collect()
    cal = rec["clock"]["calibrations"]
    assert len(cal) == 3
    off_us = (int(tracer.to_host_ns(np.array([halfway[1]]))[0]) - halfway[0]) / 1e3
    print(f"clock over {(cal[-1][0] - cal[0][0]) / 1e9:.1f} s: drift "
          f"{rec['clock']['drift_ppm']:.4f} ppm, halfway calibration {off_us:.2f} us off "
          f"the line, brackets {cal[:, 2].tolist()} ns")
    assert abs(off_us) <= 50.0


@pytest.mark.cuda
def test_stamps_lie_on_the_host_clock_beside_the_profiler(dev, tracer):
    """Under ``torch.profiler``, replays one at a time: each replay's start
    stamp, mapped to the host clock, runs after the host's
    ``cudaGraphLaunch`` began (within 200 us) and its end stamp before the
    host's synchronize returned. Printed beside it: how far the profiler's
    own kernel times (found by the launch's correlation id) lie outside
    each replay's stamps."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from lio_mapping_tpu_torch.models import step_graph as SG
    from lio_mapping_tpu_torch.utils import timing as TM

    g = SG.StepGraphs(dev)
    counts = [3] + [5, 1, 4, 2] * 5
    synced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in _replay_countdown(g, counts, dev):
            torch.cuda.synchronize(dev)
            synced.append(time.time_ns())
    rec = tracer.collect()
    runs = [r for r in TM.graph_instances(rec) if r["graph"] == "countdown"][1:]
    launches, kernels = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.name() == "cudaGraphLaunch":
            launches.append((e.start_ns(), e.correlation_id()))
        elif e.device_type().name == "CUDA":
            for c in (e.correlation_id(), e.linked_correlation_id()):
                kernels.setdefault(c, []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    launches.sort()
    assert len(launches) == len(runs) == len(counts) - 1
    lag, done, early, late = [], [], [], []
    for (at, corr), r, t_sync in zip(launches, runs, synced[1:]):
        lag.append(r["start"] - at)
        done.append(t_sync - r["end"])
        ks = kernels.get(corr, [])
        assert ks, corr
        early.append(r["start"] - min(a for a, _ in ks))
        late.append(max(b for _, b in ks) - r["end"])
    us = {name: (float(np.min(x)) / 1e3, float(np.median(x)) / 1e3, float(np.max(x)) / 1e3)
          for name, x in (("lag", lag), ("done", done), ("early", early), ("late", late))}
    print("replays on the host clock, us (min, median, max): start stamp after the host's "
          "cudaGraphLaunch {lag}, end stamp before the host's synchronize returned {done}; "
          "the profiler's first kernel before the start stamp {early}, its last kernel "
          "after the end stamp {late}".format(**us))
    assert 0 < min(lag) and max(lag) <= 200_000
    assert min(done) > 0


@pytest.mark.cuda
def test_traced_graphed_pipeline_stamps_its_bodies(graph_runs):
    """The graphed pipeline built with the tracer on gives the untraced
    graphed pipeline's outputs bit for bit; each consumed INITED sweep's
    graph has its ``front`` boundary and stamps ``solver_iterations`` - 1
    LM bodies, and every call's device interval holds its graph."""
    from lio_mapping_tpu_torch.models.pipeline import LioPipeline
    from lio_mapping_tpu_torch.utils import timing as TM
    from lio_mapping_tpu_torch.utils.tree import tree_leaves

    tr = TM.enable("cuda")
    try:
        pipe = LioPipeline(graph_runs[True]["pipe"].cfg, device="cuda")
        outs = [pipe.process(xyz, mask, pipe.make_samples(*imu))
                for xyz, mask, imu in _graph_sweeps(pipe.cfg)]
        rec = tr.collect()
    finally:
        TM.disable()
    for i, (og, oe) in enumerate(zip(outs, graph_runs[True]["outs"])):
        for key in oe:
            for a, b in zip(tree_leaves(og[key]), tree_leaves(oe[key])):
                if torch.is_tensor(b):
                    assert torch.equal(a.cpu(), b), (i, key)
    iters = [int(o["solver_iterations"]) for o in outs
             if o["stage"] == "INITED" and "solver_iterations" in o]
    steps = [r for r in TM.graph_instances(rec) if r["graph"].startswith("step.")]
    assert len(steps) == len(iters) >= 6
    for r, n in zip(steps, iters):
        marks = [(s, e) for s, e, _ in r["marks"]]
        assert ("front", "at") in marks
        assert [s for s, e in marks if s.startswith("lm.") and e == "start"] == \
            [f"lm.{k}" for k in range(1, n)]
    sp = rec["spans"]
    for r in TM.graph_instances(rec):
        i = r["span"]
        assert sp["dev_start_ns"][i] <= r["start"] <= r["end"] <= sp["dev_end_ns"][i]
