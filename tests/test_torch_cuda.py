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
