"""The step's dense solves (``lio_mapping_tpu_torch/ops/lu_solve.py``) on the
CPU: the plain version against the reference package's ``jnp.linalg.solve``,
and the LU kernel's algorithm rehearsed in torch (``lu_solve_reference``)
against the plain version, on the systems the step solves, made from a
numpy seed: the mini-GN's 6x6 normal equations (``A^T A + 1e-9 I``) and the
window LM's damped systems at the tests' small config (66 = 15 (3 + 1) + 6)
and indoor (126 = 15 (7 + 1) + 6), column scales over three decades.

Tolerances, relative to max |x|: the plain version against the
reference's float64 solve of the same float32 system within 1e-9 (both
float64 LU with partial pivoting); the rehearsal (float32) against the
plain version (float32) within 256 float32 ulps times the system's
condition estimate |A| |A^-1|, the forward error bound of a backward
stable solve. A singular system gives non-finite entries in all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu_torch.ops import gn as TGN
from lio_mapping_tpu_torch.ops import lu_solve as TLU

F32_EPS = float(np.finfo(np.float32).eps)


def _system(n, seed):
    rng = np.random.default_rng(seed)
    if n == 6:
        j = rng.normal(size=(400, 6)) * np.array([3.0, 3.0, 3.0, 1.0, 1.0, 1.0])
        return j.T @ j + 1e-9 * np.eye(6), rng.normal(size=6)
    j = rng.normal(size=(3 * n, n)) * 10.0 ** rng.uniform(0.0, 3.0, size=n)
    a = j.T @ j
    return a + 1e-4 * np.diag(np.diag(a)), rng.normal(size=n)


@pytest.mark.parametrize("n", [6, 66, 126])
def test_plain_solve_matches_the_reference(n):
    """``solve`` on the CPU (``torch.linalg.solve_ex``; ``GN.solve`` goes
    through it) against ``jnp.linalg.solve`` on the same float64 system."""
    a, b = _system(n, n)
    x = TLU.solve(torch.as_tensor(a), torch.as_tensor(b))
    ref = np.asarray(jnp.linalg.solve(jnp.asarray(a), jnp.asarray(b)))
    assert np.max(np.abs(x.numpy() - ref)) <= 1e-9 * np.max(np.abs(ref))
    assert torch.equal(TGN.solve(torch.as_tensor(a), torch.as_tensor(b)), x)


@pytest.mark.parametrize("n", [6, 66, 126])
def test_lu_reference_matches_plain(n):
    """The kernel's algorithm in float32 against the plain version on the
    same float32 system."""
    a, b = _system(n, n + 1)
    a32, b32 = torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(b, dtype=torch.float32)
    x = TLU.lu_solve_reference(a32, b32)
    plain = TLU.solve_plain(a32, b32)
    assert x.dtype == torch.float32
    cond = float(np.linalg.norm(a, np.inf) * np.linalg.norm(np.linalg.inv(a), np.inf))
    err = float((x.double() - plain.double()).abs().max() / plain.double().abs().max())
    assert err <= 256 * F32_EPS * cond, (err, cond)


def test_singular_systems_give_non_finite_entries():
    """A singular system: non-finite entries from the plain version and
    the rehearsal, as ``jnp.linalg.solve`` gives; the kernel's own wrapper
    refuses a CPU tensor."""
    a = torch.zeros((4, 4))
    b = torch.ones(4)
    for x in (TLU.solve(a, b), TLU.lu_solve_reference(a, b)):
        assert not bool(torch.isfinite(x).all())
    assert not np.all(np.isfinite(np.asarray(jnp.linalg.solve(jnp.zeros((4, 4)),
                                                               jnp.ones(4)))))
    with pytest.raises(ValueError, match="CUDA"):
        TLU.solve_cuda(a, b)
