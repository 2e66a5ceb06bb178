"""The port's fits, GN step, factors, marginalization and window solver
against the reference on shared inputs (``tests/test_solver.py``'s window
problem), plus the factor Jacobians against ``torch.func.jacfwd``.

Tolerances: float64 1e-9 (closed forms and dense solves; the two
frameworks sum and factor in different orders). Eigenvectors are compared
up to sign; the factored prior through J^T J and J^T r, which are
sign-free. Window solves compare states after the same number of LM
iterations at 1e-8 (a 15S+6 system solved up to 10 times). float32 cases
at the looser bounds stated beside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.ops import factors as JFA
from lio_mapping_tpu.ops import fits as JFI
from lio_mapping_tpu.ops import gn as JGN
from lio_mapping_tpu.ops import marginalization as JMG
from lio_mapping_tpu.ops import solver as JSV
from lio_mapping_tpu_torch.ops import factors as TFA
from lio_mapping_tpu_torch.ops import fits as TFI
from lio_mapping_tpu_torch.ops import gn as TGN
from lio_mapping_tpu_torch.ops import marginalization as TMG
from lio_mapping_tpu_torch.ops import preintegration as TPI
from lio_mapping_tpu_torch.ops import solver as TSV
from lio_mapping_tpu_torch.utils import quaternion as tq

from tests.test_solver import G, _make_window_problem

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x))


def _port(jtree, cls):
    """A reference NamedTuple as the port's (same field order)."""
    return cls(*(_t(x) for x in jtree))


def _close(a, b, atol, rtol=0.0, msg=""):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol, err_msg=msg)


def _cols_up_to_sign(a, b, atol):
    """Columns of ``a`` equal those of ``b`` up to each column's sign."""
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b, axis=-2, keepdims=True))
    np.testing.assert_allclose(a * s, b, atol=atol, rtol=0)


def _neighbors(rng, n=200, k=5):
    """Noisy 5-point patches on random planes, plus some non-planar ones."""
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    d = rng.uniform(1, 5, n)
    t1 = np.cross(w, [0.3, 0.2, 1.0])
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(w, t1)
    uv = rng.uniform(-0.5, 0.5, size=(n, k, 2))
    pts = (-d[:, None, None] * w[:, None, :] + uv[..., :1] * t1[:, None] + uv[..., 1:] * t2[:, None]
           + rng.normal(scale=0.01, size=(n, k, 3)))
    pts[: n // 5] += rng.normal(scale=0.5, size=(n // 5, k, 3))
    return pts


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-3)],
                         ids=["f64", "f32"])
def test_fits_match(rng, dtype, tol):
    """float32: a plane through a 1 m patch 1-5 m away solves a 3x3 system
    of condition ~1e2-1e3, so normals agree to ~1e-4 rad (1e-3 gate)."""
    pts = _neighbors(rng).astype(dtype)
    valid = rng.random(len(pts)) > 0.1
    tw, td, tok = TFI.plane_fit(_t(pts), _t(valid), 0.2)
    jw, jd, jok = JFI.plane_fit(jnp.asarray(pts), jnp.asarray(valid), 0.2)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # the accepted (planar) fits; a non-planar patch's normal is
    # ill-conditioned and only gated out
    ok = np.asarray(jok)
    _close(tw[ok], np.asarray(jw)[ok], tol)
    _close(td[ok], np.asarray(jd)[ok], tol * 10, rtol=tol)

    cov = np.einsum("nki,nkj->nij", pts - pts.mean(1, keepdims=True),
                    pts - pts.mean(1, keepdims=True)).astype(dtype)
    tv, tvec = TFI.sym_eig3x3(_t(cov))
    jv, jvec = JFI.sym_eig3x3(jnp.asarray(cov))
    _close(tv, jv, tol)
    sep = np.min(np.diff(np.asarray(jv), axis=-1), axis=-1) > 1e-3  # well-separated
    _cols_up_to_sign(tvec.numpy()[sep], np.asarray(jvec)[sep], tol * 100)

    tc, tdir, tlok = TFI.line_fit(_t(pts), _t(valid))
    jc, jdir, jlok = JFI.line_fit(jnp.asarray(pts), jnp.asarray(valid))
    np.testing.assert_array_equal(tlok.numpy(), np.asarray(jlok))
    _close(tc, jc, tol)
    sgn = np.sign(np.sum(tdir.numpy() * np.asarray(jdir), -1, keepdims=True))
    _close(tdir.numpy()[sep] * sgn[sep], np.asarray(jdir)[sep], tol * 100)
    p = (rng.normal(size=(len(pts), 3)) * 2).astype(dtype)
    tld, tn = TFI.point_to_line_residual(_t(p), tc, tdir)
    jld, jn = JFI.point_to_line_residual(jnp.asarray(p), jnp.asarray(tc.numpy()),
                                         jnp.asarray(tdir.numpy()))
    _close(tld, jld, tol)
    _close(tn, jn, tol * 10)

    m = rng.normal(size=(50, 3, 3)).astype(dtype) + 3 * np.eye(3, dtype=dtype)
    b = rng.normal(size=(50, 3)).astype(dtype)
    _close(TFI.solve3x3(_t(m), _t(b)), JFI.solve3x3(jnp.asarray(m), jnp.asarray(b)), tol)


def test_gn_step_matches(rng):
    jac = rng.normal(size=(300, 6))
    jac[:, 5] *= 1e-4  # one weak direction: the degeneracy projection bites
    rhs = rng.normal(size=300)
    w = (rng.random(300) > 0.2).astype(np.float64)
    ata = (jac * w[:, None]).T @ jac
    tg = TGN.degeneracy_projection(_t(ata), 10.0)
    jg = JGN.degeneracy_projection(jnp.asarray(ata), 10.0)
    assert bool(tg.is_degenerate) == bool(jg.is_degenerate) is True
    _close(tg.proj, jg.proj, 1e-9)  # a projector: sign-free
    tx, _ = TGN.solve_normal_equations(_t(jac), _t(rhs), _t(w), None, 10.0)
    jx, _ = JGN.solve_normal_equations(jnp.asarray(jac), jnp.asarray(rhs), jnp.asarray(w),
                                       None, 10.0)
    _close(tx, jx, 1e-9)


def _rand_q(rng, scale):
    return tq.exp(torch.as_tensor(rng.normal(0, scale, 3)))


def _jac_fd(f, n):
    return torch.func.jacfwd(f)(torch.zeros(n, dtype=F64))


def test_imu_factor_matches_and_jacobians(rng):
    x_gt, pres, _ = _make_window_problem()
    jpre = jax.tree.map(lambda a: a[1], pres)
    pre = _port(jpre, TPI.Preintegration)
    g = torch.tensor([0.0, 0.0, -G], dtype=F64)
    p0, q0, v0 = _t(x_gt.p[1]), _t(x_gt.q[1]), _t(x_gt.sb[1, :3])
    p1 = _t(x_gt.p[2]) + _t(rng.normal(0, 0.05, 3))
    q1 = tq.qmul(_t(x_gt.q[2]), _rand_q(rng, 0.02))
    v1 = _t(x_gt.sb[2, :3])
    ba, bg = _t(rng.normal(0, 0.05, 3)), _t(rng.normal(0, 0.005, 3))
    states = (p0, q0, v0, ba, bg, p1, q1, v1, ba, bg)

    res, jacs = TFA.imu_factor(pre, g, *states)
    jres, jjacs = JFA.imu_factor(jpre, jnp.asarray(g.numpy()),
                                 *(jnp.asarray(s.numpy()) for s in states))
    _close(res, jres, 1e-8, rtol=1e-9)
    for a, b in zip(jacs, jjacs):
        _close(a, b, 1e-7, rtol=1e-9)

    sqrt_info = TFA.sqrt_info_from_covariance(pre.covariance)
    _close(sqrt_info, JFA.sqrt_info_from_covariance(jpre.covariance), 1e-6, rtol=1e-9)
    _close(TFA.chol_unrolled(pre.covariance + 1e-6 * torch.eye(15, dtype=F64)),
           JFA.chol_unrolled(jpre.covariance + 1e-6 * jnp.eye(15)), 1e-12)

    def f(dx):
        return sqrt_info @ TPI.evaluate(
            pre, g, p0 + dx[0:3], tq.qmul(q0, tq.exp(dx[3:6])), v0 + dx[6:9], ba + dx[9:12],
            bg + dx[12:15], p1 + dx[15:18], tq.qmul(q1, tq.exp(dx[18:21])), v1 + dx[21:24],
            ba + dx[24:27], bg + dx[27:30])

    j_num = _jac_fd(f, 30).numpy()
    # the reference's tolerances (tests/test_preintegration.py): the bias
    # columns of frame i are first-order in the bias correction
    for ja, sl, tol in [(jacs[0], slice(0, 6), 1e-4), (jacs[1], slice(6, 15), 5e-2),
                        (jacs[2], slice(15, 21), 1e-4), (jacs[3], slice(21, 30), 1e-6)]:
        err = np.abs(ja.numpy() - j_num[:, sl]) / (1.0 + np.abs(j_num[:, sl]))
        assert err.max() < tol, f"block {sl}: {err.max()}"


def test_plane_and_prior_factors_match_and_jacobians(rng):
    point = _t(rng.normal(size=3))
    w = rng.normal(size=3)
    coeff = _t(np.concatenate([w / np.linalg.norm(w), [rng.normal()]]))
    p_pv, q_pv = _t(rng.normal(size=3)), _rand_q(rng, 0.5)
    p_i, q_i = _t(rng.normal(size=3)), _rand_q(rng, 0.5)
    t_lb, q_lb = _t(rng.normal(size=3) * 0.1), _rand_q(rng, 0.2)
    args = (point, coeff, p_pv, q_pv, p_i, q_i, t_lb, q_lb)
    # the port's factor takes a batch of F rows per pose; one row here
    res, jacs = TFA.pivot_point_plane_factor(point[None], coeff[None], *args[2:])
    res, jacs = res[0], [j[0] for j in jacs]
    jres, jjacs = JFA.pivot_point_plane_factor(*(jnp.asarray(a.numpy()) for a in args))
    _close(res, jres, 1e-12)
    for a, b in zip(jacs, jjacs):
        _close(a, b, 1e-12)

    def f(dx):
        r, _ = TFA.pivot_point_plane_factor(
            point[None], coeff[None], p_pv + dx[0:3], tq.qmul(q_pv, tq.exp(dx[3:6])),
            p_i + dx[6:9], tq.qmul(q_i, tq.exp(dx[9:12])),
            t_lb + dx[12:15], tq.qmul(q_lb, tq.exp(dx[15:18])))
        return r[0]

    j_num = _jac_fd(f, 18).numpy()
    for k, ja in enumerate(jacs):
        _close(ja, j_num[6 * k:6 * k + 6], 1e-9)

    pos, rot = _t(rng.normal(size=3)), _rand_q(rng, 0.4)
    pr, pj = TFA.prior_factor(p_i, q_i, pos, rot)
    jpr, jpj = JFA.prior_factor(*(jnp.asarray(a.numpy()) for a in (p_i, q_i, pos, rot)))
    _close(pr, jpr, 1e-12)
    _close(pj, jpj, 1e-12)
    j_num = _jac_fd(lambda dx: TFA.prior_factor(p_i + dx[:3], tq.qmul(q_i, tq.exp(dx[3:])),
                                                pos, rot)[0], 6)
    _close(pj, j_num, 1e-9)

    sq = _t(rng.uniform(0, 20, 40))
    for a, b in zip(TFA.cauchy_scaling(sq, 0.5), JFA.cauchy_scaling(jnp.asarray(sq.numpy()), 0.5)):
        _close(a, b, 1e-12)


def test_marginalization_algebra_matches(rng):
    m, n = 9, 21
    j = rng.normal(size=(120, m + n))
    r = rng.normal(size=120)
    a, b = j.T @ j, j.T @ r
    ta, tb = TMG.schur_marginalize(_t(a), _t(b), m)
    ja, jb = JMG.schur_marginalize(jnp.asarray(a), jnp.asarray(b), m)
    _close(ta, ja, 1e-9, rtol=1e-10)
    _close(tb, jb, 1e-9, rtol=1e-10)
    tj, tr = TMG.factorize_prior(ta, tb)
    jj, jr = JMG.factorize_prior(ja, jb)
    # rows are eigenvectors (sign-free only through the products)
    _close(tj.T @ tj, np.asarray(jj.T @ jj), 1e-8)
    _close(tj.T @ tr, np.asarray(jj.T @ jr), 1e-8)
    _close(torch.abs(tj), np.abs(np.asarray(jj)), 1e-7)
    v = rng.normal(size=(5, 5))
    s = v @ np.diag([2.0, 1.0, 0.5, 1e-12, 0.0]) @ v.T
    _close(TMG.psd_pinv(_t(s)), JMG.psd_pinv(jnp.asarray(s)), 1e-8)


def _window(noise=0.0, seed=0):
    x_gt, pres, planes = _make_window_problem(noise=noise, seed=seed)
    rng = np.random.default_rng(3)
    s = 3
    dq = rng.normal(0, 0.01, (s + 1, 3))
    dp = rng.normal(0, 0.05, (s + 1, 3))
    dq[0] = dp[0] = 0.0
    from lio_mapping_tpu.utils import quaternion as jq

    x0 = x_gt._replace(q=jq.normalize(jq.qmul(x_gt.q, jq.exp(jnp.asarray(dq)))),
                       p=x_gt.p + jnp.asarray(dp),
                       sb=x_gt.sb + jnp.asarray(rng.normal(0, 0.02, (s + 1, 9))))
    return x0, pres, planes, s


def test_evaluate_and_normal_equations_match():
    x0, pres, planes, s = _window(noise=0.01, seed=5)
    g = jnp.asarray([0.0, 0.0, -G])
    jprior = JMG.PriorState.empty(s, jnp.float64)
    flags = {"cauchy_scale": 1.0}
    jg = JSV._evaluate(x0, pres, g, planes, jprior, None, flags, s)
    tg = TSV._evaluate(_port(x0, TSV.OptStates), _port(pres, TPI.Preintegration), _t(g),
                       _port(planes, TSV.PlaneFactors), TMG.PriorState.empty(s, F64), None,
                       flags, s)
    jc, tc = JSV.group_costs(jg), TSV.group_costs(tg)
    assert sorted(jc) == sorted(tc)
    for k in jc:
        _close(tc[k], jc[k], 1e-9, rtol=1e-10, msg=k)
    ja, jb = JSV.assemble_normal_equations(jg, s)[:2]
    ta, tb = TSV.assemble_normal_equations(tg, s)[:2]
    _close(ta, ja, 1e-7, rtol=1e-10)
    _close(tb, jb, 1e-7, rtol=1e-10)


@pytest.mark.parametrize("use_marg", [False, True])
def test_solve_window_and_marginalize_match(use_marg):
    x0, pres, planes, s = _window(noise=0.01, seed=5)
    g = jnp.asarray([0.0, 0.0, -G])
    jprior = JMG.PriorState.empty(s, jnp.float64)
    tprior = TMG.PriorState.empty(s, F64)
    tx0, tpres, tplanes = (_port(x0, TSV.OptStates), _port(pres, TPI.Preintegration),
                           _port(planes, TSV.PlaneFactors))
    if use_marg:
        # a valid prior from one marginalization at the start state
        jprior = JSV.marginalize_pivot(x0, jax.tree.map(lambda a: a[0], pres), g, planes,
                                       jprior, s=s)
        tprior = _port(jprior, TMG.PriorState)
    jx, jd = JSV.solve_window(x0, pres, g, planes, jprior, None, s=s, max_iterations=10,
                              opt_extrinsic=jnp.asarray(False),
                              use_marg=jnp.asarray(use_marg))
    tx, td = TSV.solve_window(tx0, tpres, _t(g), tplanes, tprior, None, s=s, max_iterations=10,
                              opt_extrinsic=torch.tensor(False),
                              use_marg=torch.tensor(use_marg))
    assert int(td.iterations) == int(jd.iterations)
    assert int(td.n_plane) == int(jd.n_plane)
    for a, b in zip(tx, jx):
        _close(a, b, 1e-8)

    jp = JSV.marginalize_pivot(jx, jax.tree.map(lambda a: a[0], pres), g, planes, jprior, s=s)
    tp = TSV.marginalize_pivot(tx, TPI.Preintegration(*(a[0] for a in tpres)), _t(g), tplanes,
                               tprior, s=s)
    assert bool(tp.valid) and bool(jp.valid)
    # the system's bias blocks reach ~5e12 (the IMU factor's bias random
    # walk information) and cancel in the Schur complement down to ~1e2:
    # its rounding floor in float64 is ~1e-14 of that largest entry
    w = TFA.sqrt_info_from_covariance(tpres.covariance[0])
    floor = 1e-14 * float(torch.max(torch.abs(w.T @ w)))
    for a, b in ((tp.lin_jac.T @ tp.lin_jac, jp.lin_jac.T @ jp.lin_jac),
                 (tp.lin_jac.T @ tp.lin_res, jp.lin_jac.T @ jp.lin_res)):
        _close(a, b, floor)
    for name in ("x0_q", "x0_p", "x0_sb", "x0_ex_q", "x0_ex_p"):
        _close(getattr(tp, name), getattr(jp, name), 1e-8, msg=name)


def _jcast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _prior_products(p):
    """(J^T J, J^T r) of a factored prior, in float64."""
    jac = np.asarray(p.lin_jac, np.float64)
    return jac.T @ jac, jac.T @ np.asarray(p.lin_res, np.float64)


# F32_STATE_TOL[use_marg] = (q and p in rad / m, sb)
F32_STATE_TOL = {False: (1e-3, 1e-3), True: (2e-2, 5e-2)}


@pytest.mark.parametrize("use_marg", [False, True])
def test_solve_window_f32(use_marg):
    """float32, the working type on the card: the port against the reference,
    both in float32 on the same float32 inputs and the same prior.

    * ``solve_window``: equal LM iteration counts; states within
      F32_STATE_TOL. Without a prior the reference's own float32 states lie
      within 2e-4 of its float64 ones here, so 1e-3. With the float32 prior,
      whose bias blocks are rounding noise (below), they lie ~1e-2 (sb)
      from them and two float32 solvers meet within 2e-2 (q, p) and 5e-2
      (sb); measured 3.9e-3 and 1.7e-2.
    * ``marginalize_pivot`` (the first one, at the start state, and the one
      after the solve, both at the same states): J^T J within 8 floors,
      the floor being float32's eps times the largest entry of the IMU
      factor's J^T J (~5e12 in the bias blocks, which the Schur complement
      cancels to ~1e2, so the float32 prior carries rounding noise of
      ~6e5 in either package); measured <= 4.4 floors over seeds 0-5.
      J^T r within 4x the reference's own float32 error, max |J^T r (f32)
      - J^T r (f64)| on the same float32 states and prior; measured <= 3.6x.
    """
    eps32 = float(np.finfo(np.float32).eps)
    f32, f64 = torch.float32, jnp.float64
    x0, pres, planes, s = _window(noise=0.01, seed=5)
    x0, pres, planes = (_jcast(t, jnp.float32) for t in (x0, pres, planes))
    g = jnp.asarray([0.0, 0.0, -G], jnp.float32)
    pre0 = jax.tree.map(lambda a: a[0], pres)
    tx0, tpres, tplanes, tg = (_port(x0, TSV.OptStates), _port(pres, TPI.Preintegration),
                               _port(planes, TSV.PlaneFactors), _t(g))
    tpre0 = TPI.Preintegration(*(a[0] for a in tpres))

    def check_marg(x, jprior, tprior):
        jp = JSV.marginalize_pivot(x, pre0, g, planes, jprior, s=s)
        tp = TSV.marginalize_pivot(_port(x, TSV.OptStates), tpre0, tg, tplanes, tprior, s=s)
        assert bool(tp.valid) and bool(jp.valid)
        jp64 = JSV.marginalize_pivot(*(_jcast(t, f64) for t in (x, pre0, g, planes, jprior)),
                                     s=s)
        _, jacs = TFA.imu_factor(TPI.Preintegration(*(a.double() for a in tpre0)),
                                 tg.double(), *(_t(a).double() for a in (
                                     x.p[0], x.q[0], x.sb[0, :3], x.sb[0, 3:6], x.sb[0, 6:],
                                     x.p[1], x.q[1], x.sb[1, :3], x.sb[1, 3:6], x.sb[1, 6:])))
        j01 = torch.cat(jacs, dim=1)
        floor_a = eps32 * float(torch.max(torch.abs(j01.T @ j01)))
        (ta, tb), (ja, jb), (_, jb64) = map(_prior_products, (tp, jp, jp64))
        _close(ta, ja, 8 * floor_a, msg="J^T J")
        _close(tb, jb, 4 * float(np.max(np.abs(jb - jb64))), msg="J^T r")
        for name in ("x0_q", "x0_p", "x0_sb", "x0_ex_q", "x0_ex_p"):
            _close(getattr(tp, name), getattr(jp, name), 0.0, msg=name)
        return jp

    jprior = JMG.PriorState.empty(s, jnp.float32)
    if use_marg:
        jprior = check_marg(x0, jprior, TMG.PriorState.empty(s, f32))
    tprior = _port(jprior, TMG.PriorState)
    jx, jd = JSV.solve_window(x0, pres, g, planes, jprior, None, s=s, max_iterations=10,
                              opt_extrinsic=jnp.asarray(False),
                              use_marg=jnp.asarray(use_marg))
    tx, td = TSV.solve_window(tx0, tpres, tg, tplanes, tprior, None, s=s, max_iterations=10,
                              opt_extrinsic=torch.tensor(False),
                              use_marg=torch.tensor(use_marg))
    assert tx.p.dtype == f32 and jx.p.dtype == jnp.float32
    assert int(td.iterations) == int(jd.iterations)
    tol_qp, tol_sb = F32_STATE_TOL[use_marg]
    for name, tol in (("q", tol_qp), ("p", tol_qp), ("sb", tol_sb)):
        _close(getattr(tx, name), getattr(jx, name), tol, msg=name)
    check_marg(jx, jprior, tprior)
