"""The step's symmetric eigendecompositions (``lio_mapping_tpu_torch/ops/eigh.py``)
on the CPU: the plain version against the reference package's
``jnp.linalg.eigh``, and the kernel's algorithm rehearsed step by step
(``eigh_tridiag_reference``: a float64 Householder tridiagonalization and
implicit QL) against the plain version, on the matrices the step
decomposes, made from a numpy seed:

* ``gn6``: the mini-GN's 6x6 normal equations with one near-null direction
  (a column that nearly repeats two others): the degeneracy projection;
* ``eq15``: the equilibrated 15x15 leading block of a graded marginal
  system (diag -> 1): the Schur complement's pseudo-inverse;
* ``schur51``, ``schur111``: Schur complements built by the reference's
  ``marginalization.schur_marginalize`` from graded systems (column
  scales over six decades, so bias-like blocks near 1e12, and four null
  columns, the gauge): the prior's factorization (51 = 15 S + 6 with the
  tests' S = 3, 111 indoor's S = 7).

Eigenvectors are compared through what the step makes of them (sign and
basis free): ``GN.projection_from_eigh``'s projector, ``MG.pinv_from_eigh``
and ``J^T J``, ``J^T r`` of ``MG.factor_from_eigh``. Tolerances, each
relative to the matrix's largest eigenvalue (or the product's largest
entry): the plain version (float64 ``eigh`` of the float32 matrix) against
the reference's float64 ``eigh`` of the same matrix within 1e-9; the
rehearsal on the float32 matrix (float64 arithmetic, outputs rounded to
float32) against the plain version within 64 float32 ulps for eigenvalues
and ``J^T J``, 1e-4 for the projector and the reconstruction, and 1e-3 for
the pseudo-inverse and ``J^T r`` (the float32 rounding of the
eigenvectors, amplified by the inverted small eigenvalues). The rehearsal
on the float64 matrix (the float64 kernel's) against the plain version in
float64: eigenvalues within 64 float64 ulps, vectors within 1e-12 and the
invariants within 1e-9. Its stages alone: the reduction gives Q T Q^T = A
within 1e-12 (relative, Frobenius) and an orthogonal Q within 1e-13; QL on
a tridiagonal with a four-fold zero eigenvalue and a tight cluster gives
float64 ``torch.linalg.eigh``'s eigenvalues within 64 float64 ulps and its
projectors onto the null space and the cluster within 1e-12.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.ops import gn as JGN
from lio_mapping_tpu.ops import marginalization as JMG
from lio_mapping_tpu_torch.ops import eigh as TEIGH
from lio_mapping_tpu_torch.ops import gn as TGN
from lio_mapping_tpu_torch.ops import marginalization as TMG

F32_EPS = float(np.finfo(np.float32).eps)
EIGEN_TH = 100.0  # the mini-GN's degeneracy threshold (estimator._st_gn)


def _graded_system(rng, full: int, null: int = 4):
    """(A, b) = (J^T J, J^T r) of a full-column system whose column scales
    span six decades, with ``null`` zero columns (a gauge)."""
    j = rng.normal(size=(3 * full, full)) * 10.0 ** rng.uniform(0.0, 6.0, size=full)
    j[:, full - null:] = 0.0
    r = rng.normal(size=3 * full)
    return j.T @ j, j.T @ r


def _case(name):
    """(kind, float32 matrix, extra) of case ``name``, from its own seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "gn6":
        j = rng.normal(size=(400, 6)) * np.array([3.0, 3.0, 3.0, 1.0, 1.0, 1.0])
        j[:, 5] = j[:, 3] + j[:, 4] + 1e-3 * rng.normal(size=400)
        return "gn", np.float32(j.T @ j), None
    if name == "eq15":
        a, _ = _graded_system(rng, 15, null=0)
        a_s, d = TMG.equilibrate(torch.as_tensor(a, dtype=torch.float32))
        return "pinv", a_s.numpy(), (None, d.numpy())
    n = {"schur51": 51, "schur111": 111}[name]
    a, b = _graded_system(rng, 15 + n)
    a_new, b_new = JMG.schur_marginalize(jnp.asarray(a), jnp.asarray(b), 15)
    a_sym = 0.5 * (np.asarray(a_new) + np.asarray(a_new).T)
    return "factor", np.float32(a_sym), np.float32(np.asarray(b_new))


CASES = ["gn6", "eq15", "schur51", "schur111"]


def _invariants(kind, a32, extra, vals, vecs):
    """What the step makes of (vals, vecs) of ``a32`` (float64 arrays)."""
    vals = torch.as_tensor(np.asarray(vals, np.float64))
    vecs = torch.as_tensor(np.asarray(vecs, np.float64))
    if kind == "gn":
        g = TGN.projection_from_eigh(vals, vecs, EIGEN_TH)
        return {"proj": g.proj.numpy(), "degenerate": bool(g.is_degenerate)}
    if kind == "pinv":
        _, d = extra
        return {"pinv": TMG.pinv_from_eigh(vals, vecs, torch.as_tensor(d, dtype=torch.float64),
                                           TMG.EPS).numpy()}
    jac, res = TMG.factor_from_eigh(vals, vecs, torch.as_tensor(extra, dtype=torch.float64))
    return {"jtj": (jac.T @ jac).numpy(), "jtr": (jac.T @ res).numpy()}


def _reference(kind, a32, extra):
    """The reference package's results in float64 on the same matrix."""
    a64 = jnp.asarray(a32, jnp.float64)
    vals, vecs = jnp.linalg.eigh(a64)
    out = {"vals": np.asarray(vals)}
    if kind == "gn":
        g = JGN.degeneracy_projection(a64, EIGEN_TH)
        out.update(proj=np.asarray(g.proj), degenerate=bool(g.is_degenerate))
    elif kind == "pinv":
        # the system the float32 (a_s, d) stand for: D a_s D
        _, d = extra
        d64 = np.asarray(d, np.float64)
        a = d64[:, None] * np.asarray(a32, np.float64) * d64[None, :]
        out["pinv"] = np.asarray(JMG.psd_pinv(jnp.asarray(a)))
    else:
        jac, res = JMG.factorize_prior(a64, jnp.asarray(extra, jnp.float64))
        out.update(jtj=np.asarray(jac.T @ jac), jtr=np.asarray(jac.T @ res))
    return out


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(np.asarray(b)))), 1e-300))


@pytest.mark.parametrize("name", CASES)
def test_plain_eigh_matches_the_reference(name):
    """The CPU's ``eigh`` (float64 ``torch.linalg.eigh`` of the float32
    matrix, returned in float32) against the reference's float64
    ``jnp.linalg.eigh`` of the same matrix, and what the step makes of both."""
    kind, a32, extra = _case(name)
    vals, vecs = TEIGH.eigh(torch.as_tensor(a32))
    assert vals.dtype == vecs.dtype == torch.float32
    ref = _reference(kind, a32, extra)
    scale = float(np.max(np.abs(ref["vals"])))
    # the float32 return rounds each eigenvalue
    np.testing.assert_allclose(vals.double().numpy(), ref["vals"], rtol=0,
                               atol=2 * F32_EPS * scale)
    # the same decomposition in float64, before the float32 return
    v64, w64 = TEIGH.eigh_plain(torch.as_tensor(a32, dtype=torch.float64))
    np.testing.assert_allclose(v64.numpy(), ref["vals"], rtol=0, atol=1e-9 * scale)
    port = _invariants(kind, a32, extra, v64, w64)
    for key, value in port.items():
        if isinstance(value, bool):
            assert value == ref[key], key
        else:
            assert _rel(value, ref[key]) <= 1e-9, key


@pytest.mark.parametrize("name", CASES)
def test_tridiag_reference_matches_plain(name):
    """The kernel's algorithm (float64 Householder and implicit QL, outputs
    rounded to float32) against the plain version on the same float32
    matrix: eigenvalues, reconstruction, orthogonality, order and the
    step's invariants."""
    kind, a32, extra = _case(name)
    a = torch.as_tensor(a32)
    vals, vecs, iters = TEIGH.eigh_tridiag_reference(a)
    n = a.shape[0]
    assert vals.dtype == torch.float32 and 1 <= iters <= TEIGH.MAX_ITERS * n
    pv, pw = TEIGH.eigh_plain(a.double())
    scale = float(pv.abs().max())
    assert float((vals.double() - pv).abs().max()) <= 64 * F32_EPS * scale
    assert bool((vals[1:] >= vals[:-1]).all())
    v64, w64 = vals.double(), vecs.double()
    a64 = a.double()
    rec = float(torch.linalg.norm(w64 @ torch.diag(v64) @ w64.T - a64) / torch.linalg.norm(a64))
    assert rec <= 1e-4
    assert float((w64.T @ w64 - torch.eye(n, dtype=torch.float64)).abs().max()) <= 1e-4
    mine = _invariants(kind, a32, extra, v64, w64)
    plain = _invariants(kind, a32, extra, pv, pw)
    tol = {"proj": 1e-4, "pinv": 1e-3, "jtj": 64 * F32_EPS, "jtr": 1e-3}
    for key, value in mine.items():
        if isinstance(value, bool):
            assert value == plain[key], key
        else:
            assert _rel(value, plain[key]) <= tol[key], (key, _rel(value, plain[key]))


@pytest.mark.parametrize("name", CASES)
def test_tridiag_reference_float64_matches_plain(name):
    """The kernel's algorithm on a float64 matrix (the type of
    ``tools/debug_corner``'s pipeline) against the plain version on the same
    matrix: eigenvalues within 64 float64 ulps of the largest,
    reconstruction and orthogonality within 1e-12, ascending order, and the
    step's invariants within 1e-9."""
    kind, a32, extra = _case(name)
    a = torch.as_tensor(a32, dtype=torch.float64)
    vals, vecs, iters = TEIGH.eigh_tridiag_reference(a)
    n = a.shape[0]
    assert vals.dtype == torch.float64 and 1 <= iters <= TEIGH.MAX_ITERS * n
    pv, pw = TEIGH.eigh_plain(a)
    assert float((vals - pv).abs().max()) <= 64 * 2.0 ** -52 * float(pv.abs().max())
    assert bool((vals[1:] >= vals[:-1]).all())
    rec = float(torch.linalg.norm(vecs @ torch.diag(vals) @ vecs.T - a) / torch.linalg.norm(a))
    assert rec <= 1e-12
    assert float((vecs.T @ vecs - torch.eye(n, dtype=torch.float64)).abs().max()) <= 1e-12
    mine = _invariants(kind, a32, extra, vals, vecs)
    plain = _invariants(kind, a32, extra, pv, pw)
    for key, value in mine.items():
        if isinstance(value, bool):
            assert value == plain[key], key
        else:
            assert _rel(value, plain[key]) <= 1e-9, (key, _rel(value, plain[key]))


def _tridiagonal(d, e):
    n = len(d)
    t = torch.diag(torch.tensor(d, dtype=torch.float64))
    off = torch.tensor(e[:n - 1], dtype=torch.float64)
    return t + torch.diag(off, 1) + torch.diag(off, -1)


@pytest.mark.parametrize("name", CASES)
def test_householder_reduction_alone(name):
    """The kernel's first stage on the float64 matrix: Q T Q^T equals the
    (scaled) matrix within 1e-12 relative (Frobenius) and Q is orthogonal
    within 1e-13 elementwise; the scale is a power of two that brings the
    largest |a_ij| into [0.5, 1)."""
    _, a32, _ = _case(name)
    a = torch.as_tensor(a32, dtype=torch.float64)
    d, e, q, unscale = TEIGH.householder_reference(a)
    n = a.shape[0]
    assert math.frexp(unscale)[0] == 0.5
    assert 0.5 <= float(a.abs().max()) / unscale < 1.0
    rec = q @ _tridiagonal(d, e) @ q.T * unscale
    assert float(torch.linalg.norm(rec - a) / torch.linalg.norm(a)) <= 1e-12
    assert float((q.T @ q - torch.eye(n, dtype=torch.float64)).abs().max()) <= 1e-13


def test_ql_alone_on_a_null_space_and_a_cluster():
    """The kernel's QL stage on a tridiagonal whose spectrum has a
    four-fold zero eigenvalue (the prior's gauge) and a cluster of five
    eigenvalues 1e-9 apart: eigenvalues against float64
    ``torch.linalg.eigh`` of the same tridiagonal within 64 float64 ulps
    of the largest, the rotations' product orthogonal within 1e-13, and the
    basis-free invariants (the projectors onto the null space and onto the
    cluster) within 1e-12."""
    rng = np.random.default_rng(12)
    n = 40
    lam = np.concatenate([np.zeros(4), 1.0 + 1e-9 * np.arange(5), rng.uniform(2.0, 50.0, n - 9)])
    basis, _ = np.linalg.qr(rng.normal(size=(n, n)))
    a = torch.as_tensor(basis @ np.diag(lam) @ basis.T)
    d, e, _, _ = TEIGH.householder_reference(a)
    t = _tridiagonal(d, e)
    z = np.eye(n)
    iters = TEIGH.ql_reference(d, e, z)
    assert 1 <= iters <= TEIGH.MAX_ITERS * n
    z = torch.as_tensor(z)
    d = torch.tensor(d, dtype=torch.float64)
    order = torch.argsort(d, stable=True)
    vals, vecs = d[order], z[:, order]
    pv, pw = torch.linalg.eigh(t)
    assert float((vals - pv).abs().max()) <= 64 * 2.0 ** -52 * float(pv.abs().max())
    assert float((vecs.T @ vecs - torch.eye(n, dtype=torch.float64)).abs().max()) <= 1e-13
    for block in (slice(0, 4), slice(4, 9)):
        mine = vecs[:, block] @ vecs[:, block].T
        plain = pw[:, block] @ pw[:, block].T
        assert float((mine - plain).abs().max()) <= 1e-12, block


def _tiny_blocks(seed: int = 5):
    """A 40x40 float64 matrix: a Wishart block beside blocks scaled by
    1e-150 and 1e-160 (a near-null space that reduces to entries below the
    square root of the least normal number, as a real sweep's Schur
    complement did)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((40, 40))
    for lo, hi, scale in ((0, 32, 1.0), (32, 36, 1e-150), (36, 40, 1e-160)):
        j = rng.normal(size=(2 * (hi - lo), hi - lo))
        out[lo:hi, lo:hi] = scale * (j.T @ j)
    return out


def test_tridiag_reference_on_tiny_blocks():
    """Entries far below eps |A| (1e-150, 1e-160 of |A|) take the rotation's
    scaled path or deflate at LAPACK's safe minimum: finite eigenvalues
    within 64 float64 ulps of the plain version's, reconstruction and
    orthogonality within 1e-12."""
    a = torch.as_tensor(_tiny_blocks())
    vals, vecs, iters = TEIGH.eigh_tridiag_reference(a)
    assert bool(torch.isfinite(vals).all()) and bool(torch.isfinite(vecs).all())
    pv, _ = TEIGH.eigh_plain(a)
    assert float((vals - pv).abs().max()) <= 64 * 2.0 ** -52 * float(pv.abs().max())
    rec = float(torch.linalg.norm(vecs @ torch.diag(vals) @ vecs.T - a) / torch.linalg.norm(a))
    assert rec <= 1e-12
    assert float((vecs.T @ vecs - torch.eye(40, dtype=torch.float64)).abs().max()) <= 1e-12


def test_gn6_is_degenerate_and_schur_carries_its_gauge():
    """The cases are what they say: the 6x6 system has one direction below
    the mini-GN's threshold, and the Schur complements span twelve decades
    with their four null columns left in."""
    _, a32, _ = _case("gn6")
    vals = np.linalg.eigvalsh(a32.astype(np.float64))
    assert vals[0] < EIGEN_TH < vals[1]
    for name in ("schur51", "schur111"):
        _, a32, _ = _case(name)
        d = np.abs(np.diag(a32.astype(np.float64)))
        assert d.max() > 1e11 and np.sum(d == 0.0) == 4


def test_eigh_on_the_cpu_never_reaches_the_kernel():
    """On a CPU tensor ``eigh`` is the plain version and counts no launch;
    the kernel's own wrapper refuses a CPU tensor."""
    before = TEIGH.launches()
    a = torch.eye(5) * 3.0
    vals, vecs = TEIGH.eigh(a)
    assert torch.equal(vals, torch.full((5,), 3.0)) and torch.equal(vecs.abs(), torch.eye(5))
    assert TEIGH.launches() == before
    with pytest.raises(ValueError, match="CUDA"):
        TEIGH.eigh_cuda(a)
