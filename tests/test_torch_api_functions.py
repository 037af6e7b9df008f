"""The functions that closed the port's public surface, against the JAX
package on the same float32 inputs made from a numpy seed: the quaternion
and SE(3) helpers, the complementary filter and the tilt from a static
accelerometer sample, dead-reckoning and state prediction, the epipolar
inlier mask, the matched-pair gather and the Perona-Malik conductivity;
then the JAX package's own behavioural cases (tests/test_inertial.py,
tests/test_lie.py) run through the port at their tolerances.

Tolerances:
- elementwise maps (quat_conj, quat_rotate, quat_from_axis_angle,
  se3_matrix, pm_g2, ...): 1e-6 absolute and relative. The same few float32
  operations on O(1) values differ by at most a few ulps (1.2e-7 each);
  a formula error shows at 1e-2 or more.
- complementary_scan and dead_reckon over S samples at 200 Hz, a fifth of
  the rows padding (dt = 0, garbage IMU values): each step adds a few
  ulps of round-off to the carried state and nothing damps it, so the
  bound grows with S. S = 10: 1e-6 on everything. S = 200: 2e-6 on the
  unit quaternions, 1e-5 on v (m/s) and p (m), whose magnitudes reach
  ~1-2, i.e. ~40 ulps over 200 steps (measured: 1.2e-7, 5.1e-7, 2.4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsp

from vislam_tpu import lie as jlie
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.frontend import match as jmatch
from vislam_tpu.frontend import nonlinear as jnonlin
from vislam_tpu.frontend import pose as jpose
from vislam_tpu.inertial import filters as jfil
from vislam_tpu.inertial import preintegration as jpre
from vislam_tpu_torch import lie as tlie
from vislam_tpu_torch.frontend import Matches
from vislam_tpu_torch.frontend import match as tmatch
from vislam_tpu_torch.frontend import nonlinear as tnonlin
from vislam_tpu_torch.frontend import pose as tpose
from vislam_tpu_torch.inertial import (
    complementary_scan,
    dead_reckon,
    orientation_from_accel,
    preintegrate,
)
from vislam_tpu_torch.inertial import filters as tfil
from vislam_tpu_torch.inertial.preintegration import predict_state

torch.set_num_threads(2)
ELEMENTWISE = dict(rtol=1e-6, atol=1e-6)
# S -> (quaternion atol, v and p atol); see the module's docstring.
SCAN_TOL = {10: (1e-6, 1e-6), 200: (2e-6, 1e-5)}


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or ELEMENTWISE))


def _unit_quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------ lie helpers

def test_creators_match_reference_and_default_to_the_card():
    np.testing.assert_array_equal(tlie.quat_identity(device="cpu").numpy(),
                                  np.asarray(jlie.quat_identity()))
    for a, b in zip(tlie.se3_identity(device="cpu"), jlie.se3_identity()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q64 = tlie.quat_identity(torch.float64, device="cpu")
    assert q64.dtype == torch.float64
    if not torch.cuda.is_available():
        # The default device is the card; nothing falls back to the CPU.
        for make in (tlie.quat_identity, tlie.se3_identity, tlie.sim3_identity):
            with pytest.raises((RuntimeError, AssertionError)):
                make()


def test_quat_helpers_match_reference(rng):
    q = _unit_quats(rng)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    axis = rng.normal(size=(64, 3))
    axis = (axis / np.linalg.norm(axis, axis=-1, keepdims=True)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, size=64).astype(np.float32)
    angle[0] = 0.0
    _close(tlie.quat_conj(_t(q)), jlie.quat_conj(jnp.asarray(q)))
    _close(tlie.quat_rotate(_t(q), _t(v)), jlie.quat_rotate(jnp.asarray(q), jnp.asarray(v)))
    # Broadcast: one quaternion rotating every vector.
    _close(tlie.quat_rotate(_t(q[0]), _t(v)),
           jlie.quat_rotate(jnp.asarray(q[0]), jnp.asarray(v)))
    _close(tlie.quat_from_axis_angle(_t(axis), _t(angle)),
           jlie.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)))


def test_se3_matrix_helpers_match_reference(rng):
    xi = (rng.normal(size=(64, 6)) * 0.5).astype(np.float32)
    T = tuple(np.asarray(x) for x in jax.jit(jlie.se3_exp)(jnp.asarray(xi)))
    M_j = np.asarray(jlie.se3_matrix(tuple(jnp.asarray(x) for x in T)))
    M_t = tlie.se3_matrix(tuple(_t(x) for x in T))
    _close(M_t, M_j)
    # Unbatched.
    _close(tlie.se3_matrix((_t(T[0][0]), _t(T[1][0]))), M_j[0])
    for a, b in zip(tlie.se3_from_matrix(_t(M_j)), jlie.se3_from_matrix(jnp.asarray(M_j))):
        _close(a, b)


def test_quat_rotate_matches_matrix(rng):
    """tests/test_lie.py::test_quat_rotate_matches_matrix through the port."""
    q = _t(_unit_quats(rng))
    v = _t(rng.normal(size=(64, 3)))
    out1 = tlie.quat_rotate(q, v).numpy()
    out2 = np.einsum("nij,nj->ni", tlie.quat_to_mat(q).numpy(), v.numpy())
    np.testing.assert_allclose(out1, out2, atol=1e-5)
    # The conjugate rotates back.
    np.testing.assert_allclose(tlie.quat_rotate(tlie.quat_conj(q), tlie.quat_rotate(q, v)).numpy(),
                               v.numpy(), atol=1e-5)


def test_se3_matrix_round_trip(rng):
    """tests/test_lie.py::test_se3_apply_matches_matrix through the port,
    and se3_from_matrix(se3_matrix(T)) == T exactly."""
    T = tlie.se3_exp(_t(rng.normal(size=(64, 6)) * 0.5))
    p = _t(rng.normal(size=(64, 3)))
    M = tlie.se3_matrix(T)
    np.testing.assert_array_equal(M[:, 3].numpy(), np.broadcast_to([0, 0, 0, 1], (64, 4)))
    ph = torch.cat([p, torch.ones(64, 1)], -1)
    np.testing.assert_allclose(tlie.se3_apply(T, p).numpy(),
                               torch.einsum("nij,nj->ni", M, ph)[:, :3].numpy(), atol=1e-5)
    for a, b in zip(tlie.se3_from_matrix(M), T):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bad_shapes_raise():
    with pytest.raises(RuntimeError):
        tlie.quat_rotate(torch.ones(4), torch.ones(2))
    with pytest.raises(RuntimeError):
        tlie.se3_matrix((torch.eye(3).expand(2, 3, 3), torch.zeros(3, 3)))
    with pytest.raises(RuntimeError):
        tlie.quat_from_axis_angle(torch.ones(5, 3), torch.ones(4))


# ------------------------------------------------ filters and integration

@pytest.fixture(scope="module")
def imu_seq():
    return make_synthetic_sequence(SyntheticConfig(n_frames=30, n_landmarks=10, seed=3))


def _padded_window(seq, S, rng):
    """The sequence's first S IMU samples at 200 Hz, a fifth of the rows
    turned into padding (dt = 0, garbage values)."""
    g = seq["imu_gyro"][:S].astype(np.float32)
    a = seq["imu_accel"][:S].astype(np.float32)
    dt = np.full(S, 1.0 / 200.0, np.float32)
    pad = rng.random(S) < 0.2
    g[pad], a[pad], dt[pad] = 99.0, -99.0, 0.0
    return g, a, dt


def test_orientation_from_accel_matches_reference(rng):
    accel = (rng.normal(size=(64, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    _close(orientation_from_accel(_t(accel)), jfil.orientation_from_accel(jnp.asarray(accel)))


def test_complementary_step_matches_reference(rng, imu_seq):
    g, a, dt = _padded_window(imu_seq, 32, rng)
    q = _unit_quats(rng, 32)
    _close(tfil.complementary_step(_t(q), _t(g), _t(a), _t(dt), 0.05),
           jax.jit(jfil.complementary_step)(jnp.asarray(q), jnp.asarray(g), jnp.asarray(a),
                                   jnp.asarray(dt), 0.05))


@pytest.mark.parametrize("S", sorted(SCAN_TOL))
def test_complementary_scan_matches_reference(rng, imu_seq, S):
    g, a, dt = _padded_window(imu_seq, S, rng)
    q0 = imu_seq["gt_quat"][0].astype(np.float32)
    tq, tall = complementary_scan(_t(q0), _t(g), _t(a), _t(dt), alpha=0.02)
    jq, jall = jfil.complementary_scan(jnp.asarray(q0), jnp.asarray(g), jnp.asarray(a),
                                       jnp.asarray(dt), alpha=0.02)
    atol = SCAN_TOL[S][0]
    assert tall.shape == (S, 4)
    _close(tq, jq, atol=atol, rtol=0)
    _close(tall, jall, atol=atol, rtol=0)


@pytest.mark.parametrize("S", sorted(SCAN_TOL))
def test_dead_reckon_matches_reference(rng, imu_seq, S):
    g, a, dt = _padded_window(imu_seq, S, rng)
    q0, v0, p0 = (imu_seq[k][0].astype(np.float32) for k in ("gt_quat", "gt_vel", "gt_pos"))
    t_out = dead_reckon(_t(q0), _t(v0), _t(p0), _t(g), _t(a), _t(dt))
    j_out = jpre.dead_reckon(*(jnp.asarray(x) for x in (q0, v0, p0, g, a, dt)))
    q_tol, vp_tol = SCAN_TOL[S]
    assert t_out[3].shape == (S, 3)
    for t, j, tol in zip(t_out, j_out, (q_tol, vp_tol, vp_tol, vp_tol)):
        _close(t, j, atol=tol, rtol=0)


def test_predict_state_matches_reference(rng):
    gyro = rng.normal(scale=0.3, size=(40, 3)).astype(np.float32)
    accel = (rng.normal(scale=0.5, size=(40, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    dt = np.full(40, 1.0 / 200.0, np.float32)
    R_i = Rsp.from_rotvec(rng.normal(size=3)).as_matrix().astype(np.float32)
    v_i, p_i = (rng.normal(size=3).astype(np.float32) for _ in range(2))
    t_out = predict_state(preintegrate(_t(gyro), _t(accel), _t(dt)), _t(R_i), _t(v_i), _t(p_i),
                          gravity=9.8)
    j_out = jpre.predict_state(jpre.preintegrate(jnp.asarray(gyro), jnp.asarray(accel),
                                                 jnp.asarray(dt)),
                               jnp.asarray(R_i), jnp.asarray(v_i), jnp.asarray(p_i), gravity=9.8)
    for t, j in zip(t_out, j_out):
        _close(t, j, rtol=1e-5, atol=1e-5)  # a 40-sample preintegration first


def _seq(**kw):
    cfg = SyntheticConfig(n_frames=60, n_landmarks=10, **kw)
    return cfg, make_synthetic_sequence(cfg)


def test_orientation_from_accel_static():
    """tests/test_inertial.py::test_orientation_from_accel_static."""
    rpy_true = np.array([0.2, -0.3, 0.0])
    R = Rsp.from_euler("ZYX", rpy_true[::-1]).as_matrix()
    q = orientation_from_accel(_t(R.T @ np.array([0.0, 0.0, 9.81])))
    np.testing.assert_allclose(tlie.quat_to_rpy(q).numpy()[:2], rpy_true[:2], atol=1e-5)


def test_complementary_tracks_roll_pitch():
    """tests/test_inertial.py::test_complementary_tracks_roll_pitch."""
    cfg, seq = _seq(seed=7, trans_amp=(0.08, 0.05, 0.03))
    dt = np.full(len(seq["imu_t_ns"]), 1.0 / 200.0, np.float32)
    qf, qs = complementary_scan(_t(seq["gt_quat"][0]), _t(seq["imu_gyro"]),
                                _t(seq["imu_accel"]), _t(dt), alpha=0.01)
    assert qs.shape == (len(dt), 4)
    np.testing.assert_allclose(tlie.quat_to_rpy(qf).numpy(),
                               tlie.quat_to_rpy(_t(seq["gt_quat"][-1])).numpy(), atol=0.05)


def test_padding_rows_are_noops():
    """tests/test_inertial.py::test_padding_rows_are_noops for the
    complementary filter and dead-reckoning: garbage rows with dt = 0
    appended leave the result unchanged."""
    cfg, seq = _seq(seed=8)
    g, a = _t(seq["imu_gyro"][:10]), _t(seq["imu_accel"][:10])
    dt = torch.full((10,), 1.0 / 200.0)
    g2 = torch.cat([g, torch.full((6, 3), 99.0)])
    a2 = torch.cat([a, torch.full((6, 3), -99.0)])
    dt2 = torch.cat([dt, torch.zeros(6)])
    q0, v0, p0 = (_t(seq[k][0]) for k in ("gt_quat", "gt_vel", "gt_pos"))
    np.testing.assert_allclose(complementary_scan(q0, g, a, dt)[0].numpy(),
                               complementary_scan(q0, g2, a2, dt2)[0].numpy(), atol=1e-6)
    for x, y in zip(dead_reckon(q0, v0, p0, g, a, dt)[:3],
                    dead_reckon(q0, v0, p0, g2, a2, dt2)[:3]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


def test_predict_state_reproduces_gt():
    """The predict_state half of
    tests/test_inertial.py::test_preintegration_matches_gt_relative_motion."""
    cfg, seq = _seq(seed=9)
    i, j = 10, 20
    lo, hi = i * 10, j * 10
    pre = preintegrate(_t(seq["imu_gyro"][lo:hi]), _t(seq["imu_accel"][lo:hi]),
                       torch.full((hi - lo,), 1.0 / 200.0))
    R_i = Rsp.from_quat(np.roll(seq["gt_quat"][i], -1)).as_matrix()
    _, v_j, p_j = predict_state(pre, _t(R_i), _t(seq["gt_vel"][i]), _t(seq["gt_pos"][i]),
                                gravity=cfg.gravity)
    np.testing.assert_allclose(p_j.numpy(), seq["gt_pos"][j], atol=0.01)
    np.testing.assert_allclose(v_j.numpy(), seq["gt_vel"][j], atol=0.02)


def test_dead_reckon_short_window():
    """tests/test_inertial.py::test_dead_reckon_short_window."""
    cfg, seq = _seq(seed=11)
    n = 100  # 0.5 s
    q, v, p, ps = dead_reckon(_t(seq["gt_quat"][0]), _t(seq["gt_vel"][0]), _t(seq["gt_pos"][0]),
                              _t(seq["imu_gyro"][:n]), _t(seq["imu_accel"][:n]),
                              torch.full((n,), 1.0 / 200.0), gravity=cfg.gravity)
    np.testing.assert_allclose(p.numpy(), seq["gt_pos"][10], atol=0.01)
    np.testing.assert_allclose(v.numpy(), seq["gt_vel"][10], atol=0.02)
    assert ps.shape == (n, 3)


# ------------------------------------------------------------- frontend

def test_epipolar_inlier_mask_matches_reference(rng):
    """The mask is |n . t| < thresh; rows within 1e-5 of the threshold
    (where a last-bit difference of n may flip it) are left out."""
    M, thresh = 512, 0.05
    rays_i = np.concatenate([rng.normal(scale=0.4, size=(M, 2)), np.ones((M, 1))], 1)
    rays_j = np.concatenate([rng.normal(scale=0.4, size=(M, 2)), np.ones((M, 1))], 1)
    rays_i, rays_j = rays_i.astype(np.float32), rays_j.astype(np.float32)
    R = Rsp.from_rotvec(rng.normal(scale=0.1, size=3)).as_matrix().astype(np.float32)
    t_dir = rng.normal(size=3)
    t_dir = (t_dir / np.linalg.norm(t_dir)).astype(np.float32)
    got = tpose.epipolar_inlier_mask(_t(rays_i), _t(rays_j), _t(R), _t(t_dir), thresh).numpy()
    want = np.asarray(jpose.epipolar_inlier_mask(jnp.asarray(rays_i), jnp.asarray(rays_j),
                                                 jnp.asarray(R), jnp.asarray(t_dir), thresh))
    n, _ = jpose.epipolar_normals(jnp.asarray(rays_i), jnp.asarray(rays_j), jnp.asarray(R))
    clear = np.abs(np.abs(np.asarray(n) @ t_dir) - thresh) > 1e-5
    assert got.dtype == np.bool_ and got.shape == (M,)
    assert clear.sum() > 0.99 * M and 0 < want.sum() < M
    np.testing.assert_array_equal(got[clear], want[clear])


def test_gather_matched_matches_reference(rng):
    K, N = 64, 80
    uv_a = rng.uniform(0, 700, size=(K, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 700, size=(N, 2)).astype(np.float32)
    idx = rng.integers(0, N, size=K).astype(np.int32)
    dist = rng.random(K).astype(np.float32)
    mask = rng.random(K) < 0.7
    got = tmatch.gather_matched(_t(uv_a), _t(uv_b), Matches(torch.from_numpy(idx), _t(dist),
                                                            torch.from_numpy(mask)))
    want = jmatch.gather_matched(jnp.asarray(uv_a), jnp.asarray(uv_b),
                                 jmatch.Matches(jnp.asarray(idx), jnp.asarray(dist),
                                                jnp.asarray(mask)))
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pm_g2_matches_reference(rng):
    gx, gy = (rng.normal(scale=20.0, size=(48, 64)).astype(np.float32) for _ in range(2))
    _close(tnonlin.pm_g2(_t(gx), _t(gy), 7.5),
           jnonlin.pm_g2(jnp.asarray(gx), jnp.asarray(gy), 7.5))
