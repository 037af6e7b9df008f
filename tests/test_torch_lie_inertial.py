"""vislam_tpu_torch against vislam_tpu: quaternion/SO(3) math, the Madgwick
filter and IMU preintegration, on the same float32 inputs.

Tolerances: the same formulas on the same float32 inputs differ only by
float32 round-off and operation order (~1e-7 relative per op); 1e-5
relative/absolute covers the chains of tens of ops here (16-sample scans
included), while any formula error shows at 1e-2 or more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu import lie as jlie
from vislam_tpu.inertial import filters as jfil
from vislam_tpu.inertial import preintegration as jpre
from vislam_tpu_torch import lie as tlie
from vislam_tpu_torch.inertial import filters as tfil
from vislam_tpu_torch.inertial import preintegration as tpre

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _rotvecs(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    # Probes: zero, tiny (Taylor branch), 180 degrees about each axis.
    w[0] = 0.0
    w[1] = [1e-7, -2e-7, 5e-8]
    w[2:5] = np.pi * np.eye(3, dtype=np.float32)
    return w


@pytest.mark.parametrize("fn", ["so3_hat", "so3_exp", "so3_left_jacobian"])
def test_so3_maps_match_reference(rng, fn):
    w = _rotvecs(rng)
    _close(getattr(tlie, fn)(_t(w)), getattr(jlie, fn)(jnp.asarray(w)))


def test_quaternion_ops_match_reference(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                       # zero -> identity probe
    p = rng.normal(size=(64, 4)).astype(np.float32)
    _close(tlie.quat_normalize(_t(q)), jlie.quat_normalize(jnp.asarray(q)))
    qn = np.asarray(jlie.quat_normalize(jnp.asarray(q)))
    pn = np.asarray(jlie.quat_normalize(jnp.asarray(p)))
    _close(tlie.quat_mul(_t(qn), _t(pn)), jlie.quat_mul(jnp.asarray(qn), jnp.asarray(pn)))
    _close(tlie.quat_to_mat(_t(qn)), jlie.quat_to_mat(jnp.asarray(qn)))
    np.testing.assert_array_equal(tlie.quat_normalize(_t(q))[0].numpy(), [1, 0, 0, 0])


def test_mat_to_quat_180_degree_chain_matches_reference(rng):
    # quat -> mat -> quat through rotations near and at 180 degrees (trace -1).
    w = _rotvecs(rng)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    qt = tlie.mat_to_quat(_t(R))
    _close(qt, jlie.mat_to_quat(jnp.asarray(R)), rtol=1e-5, atol=2e-5)
    _close(tlie.quat_to_mat(qt), R, rtol=1e-5, atol=2e-5)


def test_orthonormalize_matches_reference(rng):
    R = np.asarray(jlie.so3_exp(jnp.asarray(_rotvecs(rng))))
    Rn = (R + 1e-3 * rng.normal(size=R.shape)).astype(np.float32)
    out = tlie.orthonormalize(_t(Rn))
    _close(out, jlie.orthonormalize(jnp.asarray(Rn)))
    eye = np.broadcast_to(np.eye(3), R.shape)
    np.testing.assert_allclose((out.transpose(-1, -2) @ out).numpy(), eye, atol=1e-5)


def _imu_window(rng, n_valid=10, S=16):
    gyro = np.zeros((S, 3), np.float32)
    accel = np.zeros((S, 3), np.float32)
    dt = np.zeros(S, np.float32)
    gyro[:n_valid] = rng.normal(scale=0.3, size=(n_valid, 3))
    accel[:n_valid] = rng.normal(scale=0.5, size=(n_valid, 3)) + [0.0, 0.0, 9.81]
    dt[:n_valid] = 1.0 / 200.0
    return gyro, accel, dt


def test_madgwick_scan_matches_reference(rng):
    gyro, accel, dt = _imu_window(rng)
    q0 = np.asarray(jlie.quat_normalize(jnp.asarray(rng.normal(size=4).astype(np.float32))))
    jq, jall = jfil.madgwick_scan(jnp.asarray(q0), jnp.asarray(gyro), jnp.asarray(accel),
                                  jnp.asarray(dt), beta=0.02, gravity=9.81)
    tq, tall = tfil.madgwick_scan(_t(q0), _t(gyro), _t(accel), _t(dt), beta=0.02,
                                  gravity=9.81)
    _close(tq, jq)
    _close(tall, jall)
    # Padded samples (dt = 0) are exact no-ops.
    np.testing.assert_array_equal(tall[10:].numpy(), np.repeat(tall[9:10].numpy(), 6, 0))


def _pre_pair(rng):
    gyro, accel, dt = _imu_window(rng)
    bg = rng.normal(scale=0.01, size=3).astype(np.float32)
    ba = rng.normal(scale=0.05, size=3).astype(np.float32)
    j = jpre.preintegrate(jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(dt),
                          bias_gyro=jnp.asarray(bg), bias_accel=jnp.asarray(ba))
    t = tpre.preintegrate(_t(gyro), _t(accel), _t(dt), bias_gyro=_t(bg), bias_accel=_t(ba))
    return t, j


def test_preintegrate_matches_reference(rng):
    t, j = _pre_pair(rng)
    for name in tpre.Preintegrated._fields:
        _close(getattr(t, name), getattr(j, name))


def test_compose_and_bias_correct_match_reference(rng):
    ta, ja = _pre_pair(rng)
    tb, jb = _pre_pair(rng)
    tc = tpre.compose(ta, tb, dt_b=torch.tensor(0.05))
    jc = jpre.compose(ja, jb, dt_b=jnp.asarray(0.05, jnp.float32))
    for name in tpre.Preintegrated._fields:
        _close(getattr(tc, name), getattr(jc, name))
    dbg = rng.normal(scale=0.01, size=3).astype(np.float32)
    dba = rng.normal(scale=0.05, size=3).astype(np.float32)
    tk = tpre.bias_correct(tc, _t(dbg), _t(dba))
    jk = jpre.bias_correct(jc, jnp.asarray(dbg), jnp.asarray(dba))
    for name in tpre.Preintegrated._fields:
        _close(getattr(tk, name), getattr(jk, name))
