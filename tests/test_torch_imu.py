"""The port's IMU preintegration and deskew against the reference on the
same simulated IMU stream.

Tolerances: float64 1e-12 absolute on deltas and world states, and 1e-9
relative on the covariance (entries up to ~1e-3 built from ~20 products;
the two frameworks order the prefix-scan products differently, so only
rounding separates them). float32: 1e-5 on deltas (|values| <= ~2), 1e-4
relative on the covariance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lio_mapping_tpu.io import synthetic
from lio_mapping_tpu.models import estimator as JE
from lio_mapping_tpu.ops import cloud as JC
from lio_mapping_tpu.ops import deskew as JDS
from lio_mapping_tpu.ops import preintegration as JPI
from lio_mapping_tpu_torch.models import estimator as TE
from lio_mapping_tpu_torch.ops import cloud as TC
from lio_mapping_tpu_torch.ops import deskew as TDS
from lio_mapping_tpu_torch.ops import preintegration as TPI

NOISE = (0.2, 0.02, 2e-4, 2e-5)
G = np.array([0.0, 0.0, -9.805])
DT = [(np.float64, 1e-12, 1e-9), (np.float32, 1e-5, 1e-4)]
IDS = ["f64", "f32"]


def _port(jtree, cls):
    """A reference NamedTuple as the port's (same field order)."""
    return cls(*(torch.as_tensor(np.asarray(x)) for x in jtree))


def _close(t, j, atol, rtol=0.0):
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol)


def _packed(t0=0.3, t1=0.5, cap=48, rate=200.0):
    traj = synthetic.Trajectory(pitch_amp=0.4, roll_amp=0.35, rp_freq=0.45)
    ts, acc, gyr = synthetic.simulate_imu_interval(traj, t0, t1, rate)
    a0, w0 = traj.imu(t0)
    dts = np.diff(np.concatenate([[t0], ts]))
    return (dts, acc, gyr, a0, w0), cap


def test_pack_merge_unpack_equal():
    (dts, acc, gyr, a0, w0), cap = _packed()
    h = len(dts) // 2
    a = TPI.pack_samples_np(dts[:h], acc[:h], gyr[:h], a0, w0, cap)
    b = TPI.pack_samples_np(dts[h:], acc[h:], gyr[h:], acc[h - 1], gyr[h - 1], cap)
    np.testing.assert_array_equal(a, JPI.pack_samples_np(dts[:h], acc[:h], gyr[:h], a0, w0, cap))
    m = TPI.merge_packed_np([a, b], cap)
    np.testing.assert_array_equal(m, JPI.merge_packed_np([a, b], cap))
    _close(TPI.unpack_samples(torch.as_tensor(m)), JPI.unpack_samples(jnp.asarray(m)), 0.0)
    np.testing.assert_array_equal(TPI.noise_matrix(*NOISE, torch.float64).numpy(),
                                  np.asarray(JPI.noise_matrix(*NOISE, jnp.float64)))


@pytest.mark.parametrize("dtype,atol,rtol", DT, ids=IDS)
def test_integrate_with_prefixes_and_world_states(rng, dtype, atol, rtol):
    (dts, acc, gyr, a0, w0), cap = _packed()
    packed = TPI.pack_samples_np(dts, acc, gyr, a0, w0, cap).astype(dtype)
    js = JPI.unpack_samples(jnp.asarray(packed))
    ts = TPI.unpack_samples(torch.as_tensor(packed))
    ba, bg = (rng.normal(size=3) * 0.05).astype(dtype), (rng.normal(size=3) * 0.005).astype(dtype)
    jn = JPI.noise_matrix(*NOISE, dtype=jnp.dtype(dtype))
    tn = torch.as_tensor(np.array(jn))

    jpre, jpref = JPI.integrate(js, jnp.asarray(ba), jnp.asarray(bg), jn, with_prefixes=True)
    tpre, tpref = TPI.integrate(ts, torch.as_tensor(ba), torch.as_tensor(bg), tn,
                                with_prefixes=True)
    for name in TPI.Preintegration._fields:
        a, b = getattr(tpre, name).numpy(), np.asarray(getattr(jpre, name))
        scale = np.max(np.abs(b)) if name in ("covariance", "jacobian") else 1.0
        np.testing.assert_allclose(a, b, atol=max(atol, rtol * scale), rtol=0, err_msg=name)
    _close(tpref, jpref, atol)
    # the plain (no prefixes) call gives the same preintegration
    _close(TPI.integrate(ts, torch.as_tensor(ba), torch.as_tensor(bg), tn), tpre, 0.0)

    jmean = JPI.integrate_mean(js, jnp.asarray(ba), jnp.asarray(bg))
    tmean = TPI.integrate_mean(ts, torch.as_tensor(ba), torch.as_tensor(bg))
    for name in ("delta_p", "delta_q", "delta_v", "sum_dt"):
        np.testing.assert_allclose(getattr(tmean, name).numpy(),
                                   np.asarray(getattr(jmean, name)), atol=atol, err_msg=name)

    q0 = rng.normal(size=4)
    q0 = (q0 / np.linalg.norm(q0)).astype(dtype)
    p0, v0 = rng.normal(size=3).astype(dtype), rng.normal(size=3).astype(dtype)
    g = G.astype(dtype)
    jx = [jnp.asarray(x) for x in (q0, p0, v0, g)]
    tx = [torch.as_tensor(x) for x in (q0, p0, v0, g)]
    _close(TPI.apply_deltas(tpre, *tx), JPI.apply_deltas(jpre, *jx), atol * 10)
    for t_off in (-0.01, 0.0, 0.0731, 0.1, 0.2):
        _close(TPI.state_at_offset(tpref, torch.tensor(t_off, dtype=tx[1].dtype), *tx),
               JPI.state_at_offset(jpref, jnp.asarray(t_off, dtype), *jx), atol * 10)

    # the residual at perturbed end states
    q1 = rng.normal(size=4)
    q1 = (q1 / np.linalg.norm(q1)).astype(dtype)
    st_j = [rng.normal(size=3).astype(dtype) for _ in range(8)]
    j_args = (jx[1], jx[0], jx[2], *map(jnp.asarray, st_j[:2]), jnp.asarray(st_j[2]),
              jnp.asarray(q1), *map(jnp.asarray, st_j[3:6]))
    t_args = (tx[1], tx[0], tx[2], *map(torch.as_tensor, st_j[:2]), torch.as_tensor(st_j[2]),
              torch.as_tensor(q1), *map(torch.as_tensor, st_j[3:6]))
    np.testing.assert_allclose(TPI.evaluate(tpre, tx[3], *t_args).numpy(),
                               np.asarray(JPI.evaluate(jpre, jx[3], *j_args)), atol=atol * 100)


def test_batched_integrate_matches(rng):
    """The window's batched preintegration (a leading frame axis)."""
    packs = []
    for i in range(3):
        (dts, acc, gyr, a0, w0), cap = _packed(0.2 * i, 0.2 * i + 0.2)
        packs.append(TPI.pack_samples_np(dts, acc, gyr, a0, w0, cap).astype(np.float64))
    jn = JPI.noise_matrix(*NOISE, dtype=jnp.float64)
    z = np.zeros(3)
    want = [JPI.integrate(JPI.unpack_samples(jnp.asarray(p)), jnp.asarray(z), jnp.asarray(z),
                          jn) for p in packs]
    want = jax.tree.map(lambda *a: jnp.stack(a), *want)
    ts = [TPI.unpack_samples(torch.as_tensor(p)) for p in packs]
    got = [TPI.integrate(s, torch.zeros(3, dtype=torch.float64),
                         torch.zeros(3, dtype=torch.float64), torch.as_tensor(np.array(jn)))
           for s in ts]
    for name in TPI.Preintegration._fields:
        a = torch.stack([getattr(g, name) for g in got]).numpy()
        b = np.asarray(getattr(want, name))
        np.testing.assert_allclose(a, b, atol=1e-12 * max(1.0, np.max(np.abs(b))), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-5)], ids=IDS)
def test_deskew_matches(rng, dtype, atol):
    n = 500
    xyz = (rng.normal(size=(n, 3)) * 8).astype(dtype)
    rel = rng.uniform(0, 0.1, n).astype(dtype)
    q = np.array([0.999, 0.01, -0.02, 0.03])
    q = (q / np.linalg.norm(q)).astype(dtype)
    t = np.array([0.1, -0.05, 0.02], dtype)
    for fn in ("transform_to_start", "transform_to_end"):
        for enabled in (True, False):
            a = getattr(TDS, fn)(torch.as_tensor(xyz), torch.as_tensor(rel), torch.as_tensor(q),
                                 torch.as_tensor(t), 0.1, enabled=enabled)
            b = getattr(JDS, fn)(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(q),
                                 jnp.asarray(t), 0.1, enabled=enabled)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol * 10, rtol=0)
    ring = np.arange(n, dtype=np.int32) % 16
    mask = rng.random(n) > 0.2
    tc = TDS.cloud_to_end(TC.Cloud(*(torch.as_tensor(x) for x in (xyz, rel, ring, mask))),
                          torch.as_tensor(q), torch.as_tensor(t), 0.1)
    jc = JDS.cloud_to_end(JC.Cloud(*(jnp.asarray(x) for x in (xyz, rel, ring, mask))),
                          jnp.asarray(q), jnp.asarray(t), 0.1)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol * 10, rtol=0)


def test_propagate_world_matches():
    """The midpoint world-state propagation over one frame's samples (a
    Python loop in the port, a scan in the reference), float64."""
    (dts, acc, gyr, a0, w0), cap = _packed()
    packed = TPI.pack_samples_np(dts, acc, gyr, a0, w0, cap).astype(np.float64)
    q0 = np.array([0.96, 0.1, -0.2, 0.15])
    args = (q0 / np.linalg.norm(q0), np.array([1.0, -2.0, 0.5]), np.array([0.3, 0.1, -0.05]),
            np.array([0.02, -0.01, 0.03]), np.array([0.001, 0.002, -0.003]), G)
    got = TE.propagate_world(*(torch.as_tensor(a) for a in args),
                             TPI.unpack_samples(torch.as_tensor(packed)))
    want = JE.propagate_world(*(jnp.asarray(a) for a in args),
                              JPI.unpack_samples(jnp.asarray(packed)))
    _close(got, want, 1e-12)


SCHEMES = {"sequential": ("integrate_sequential", "noise_matrix"),
           "euler": ("integrate_euler", "noise_matrix_euler")}


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("dtype,atol,rtol", DT, ids=IDS)
def test_sequential_and_euler_schemes_match(rng, scheme, dtype, atol, rtol):
    """The per-sample recursions (a Python loop in the port, a scan in the
    reference): the midpoint transcription and the first-order Euler
    scheme, on a padded buffer with biases."""
    fn, noise = SCHEMES[scheme]
    (dts, acc, gyr, a0, w0), cap = _packed()
    packed = TPI.pack_samples_np(dts, acc, gyr, a0, w0, cap).astype(dtype)
    ba, bg = (rng.normal(size=3) * 0.05).astype(dtype), (rng.normal(size=3) * 0.005).astype(dtype)
    jn = getattr(JPI, noise)(*NOISE, jnp.dtype(dtype))
    tn = getattr(TPI, noise)(*NOISE, torch.float64 if dtype == np.float64 else torch.float32)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    want = getattr(JPI, fn)(JPI.unpack_samples(jnp.asarray(packed)), jnp.asarray(ba),
                            jnp.asarray(bg), jn)
    got = getattr(TPI, fn)(TPI.unpack_samples(torch.as_tensor(packed)), torch.as_tensor(ba),
                           torch.as_tensor(bg), tn)
    for name in TPI.Preintegration._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        scale = np.max(np.abs(b)) if name in ("covariance", "jacobian") else 1.0
        np.testing.assert_allclose(a, b, atol=max(atol, rtol * scale), rtol=0, err_msg=name)


def test_euler_scheme_agrees_with_midpoint():
    """The reference's own check (tests/test_preintegration.py:181) on the
    port: Euler and midpoint agree to first order on a smooth trajectory,
    and the Euler covariance is PSD; the batched midpoint equals the
    sequential one."""
    traj = synthetic.Trajectory()  # the reference test's trajectory and span
    ts, acc, gyr = synthetic.simulate_imu_interval(traj, 0.3, 0.8, 200.0)
    a0, w0 = traj.imu(0.3)
    dts = np.diff(np.concatenate([[0.3], ts]))
    s = TPI.unpack_samples(torch.as_tensor(
        TPI.pack_samples_np(dts, acc, gyr, a0, w0, len(ts)).astype(np.float64)))
    z = torch.zeros(3, dtype=torch.float64)
    mid = TPI.integrate(s, z, z, TPI.noise_matrix(*NOISE, torch.float64))
    seq = TPI.integrate_sequential(s, z, z, TPI.noise_matrix(*NOISE, torch.float64))
    eu = TPI.integrate_euler(s, z, z, TPI.noise_matrix_euler(*NOISE, torch.float64))
    _close(mid[:3], seq[:3], 1e-12)
    assert abs(float(torch.dot(eu.delta_q, mid.delta_q))) > 1 - 1e-6
    np.testing.assert_allclose(eu.delta_p.numpy(), mid.delta_p.numpy(), atol=2e-2)
    np.testing.assert_allclose(eu.delta_v.numpy(), mid.delta_v.numpy(), atol=5e-2)
    assert float(eu.sum_dt) == pytest.approx(float(mid.sum_dt), abs=1e-14)
    cov = eu.covariance.numpy()
    assert np.linalg.eigvalsh(0.5 * (cov + cov.T)).min() > -1e-16
