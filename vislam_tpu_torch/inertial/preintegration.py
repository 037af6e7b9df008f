"""IMU preintegration, Forster-style, with first-order bias Jacobians, and
world-frame Euler dead-reckoning (port of
`vislam_tpu/inertial/preintegration.py`). dt == 0 rows are padding and
exact no-ops."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vislam_tpu_torch.lie.quat import mat_to_quat, quat_mul, quat_normalize, quat_to_mat
from vislam_tpu_torch.lie.so3 import so3_exp, so3_hat, so3_left_jacobian


class Preintegrated(NamedTuple):
    """Preintegrated IMU factor between two frames.

    dR: (3,3) rotation from frame i body to frame j body
    dv, dp: (3,) velocity / position change in frame-i body coords
    dt: () total integration time
    J_*: (3,3) bias Jacobians
    """

    dR: torch.Tensor
    dv: torch.Tensor
    dp: torch.Tensor
    dt: torch.Tensor
    J_dR_bg: torch.Tensor
    J_dv_bg: torch.Tensor
    J_dv_ba: torch.Tensor
    J_dp_bg: torch.Tensor
    J_dp_ba: torch.Tensor


def preintegrate(gyro, accel, dt, bias_gyro=None, bias_accel=None) -> Preintegrated:
    """Integrate a window of IMU samples: gyro/accel (S,3) raw, dt (S,)
    (0 = padded row). Biases are subtracted if given."""
    dtype, dev = gyro.dtype, gyro.device
    if bias_gyro is not None:
        gyro = gyro - bias_gyro
    if bias_accel is not None:
        accel = accel - bias_accel

    dR = torch.eye(3, dtype=dtype, device=dev)
    dv = torch.zeros(3, dtype=dtype, device=dev)
    dp = torch.zeros(3, dtype=dtype, device=dev)
    T = torch.zeros((), dtype=dtype, device=dev)
    J_R_bg = J_v_bg = J_v_ba = J_p_bg = J_p_ba = torch.zeros(
        (3, 3), dtype=dtype, device=dev)
    for s in range(gyro.shape[0]):
        w, a, d = gyro[s], accel[s], dt[s]
        # Bias Jacobian propagation (Forster eq. 69-71) with the
        # pre-update dR.
        dRa = dR @ so3_hat(a)
        J_p_bg = J_p_bg + J_v_bg * d - 0.5 * dRa @ J_R_bg * (d * d)
        J_p_ba = J_p_ba + J_v_ba * d - 0.5 * dR * (d * d)
        J_v_bg = J_v_bg - dRa @ J_R_bg * d
        J_v_ba = J_v_ba - dR * d

        acc_i = dR @ a  # accel rotated into frame-i body coords
        dp = dp + dv * d + 0.5 * acc_i * d * d
        dv = dv + acc_i * d
        dRk = so3_exp(w * d)
        Jr = so3_left_jacobian(-w * d)  # right Jacobian of exp at (w d)
        J_R_bg = dRk.T @ J_R_bg - Jr * d
        dR = dR @ dRk
        T = T + d
    return Preintegrated(dR, dv, dp, T, J_R_bg, J_v_bg, J_v_ba, J_p_bg, J_p_ba)


def compose(a: Preintegrated, b: Preintegrated, dt_b=None) -> Preintegrated:
    """Chain factor a (i->m) with factor b (m->j) into one factor (i->j);
    both share one bias linearization point. dt_b overrides b's time."""
    T_b = b.dt if dt_b is None else dt_b
    dR = a.dR @ b.dR
    dv = a.dv + a.dR @ b.dv
    dp = a.dp + a.dv * T_b + a.dR @ b.dp
    J_dR_bg = b.dR.T @ a.J_dR_bg + b.J_dR_bg
    J_dv_bg = a.J_dv_bg + a.dR @ b.J_dv_bg - a.dR @ so3_hat(b.dv) @ a.J_dR_bg
    J_dv_ba = a.J_dv_ba + a.dR @ b.J_dv_ba
    J_dp_bg = (a.J_dp_bg + a.J_dv_bg * T_b + a.dR @ b.J_dp_bg
               - a.dR @ so3_hat(b.dp) @ a.J_dR_bg)
    J_dp_ba = a.J_dp_ba + a.J_dv_ba * T_b + a.dR @ b.J_dp_ba
    return Preintegrated(dR, dv, dp, a.dt + T_b,
                         J_dR_bg, J_dv_bg, J_dv_ba, J_dp_bg, J_dp_ba)


def bias_correct(pre: Preintegrated, dbg, dba) -> Preintegrated:
    """First-order re-linearization of a factor to bias + (dbg, dba)
    (Forster eq. 44); the Jacobians are unchanged."""
    dR = pre.dR @ so3_exp(pre.J_dR_bg @ dbg)
    dv = pre.dv + pre.J_dv_bg @ dbg + pre.J_dv_ba @ dba
    dp = pre.dp + pre.J_dp_bg @ dbg + pre.J_dp_ba @ dba
    return pre._replace(dR=dR, dv=dv, dp=dp)


def _gravity_w(like, gravity):
    return torch.eye(3, dtype=like.dtype, device=like.device)[2] * -gravity


def predict_state(pre: Preintegrated, R_i, v_i, p_i, gravity=9.81):
    """Propagate world-frame state (R, v, p) through a preintegrated factor."""
    g_w = _gravity_w(v_i, gravity)
    T = pre.dt
    R_j = R_i @ pre.dR
    v_j = v_i + g_w * T + R_i @ pre.dv
    p_j = p_i + v_i * T + 0.5 * g_w * T * T + R_i @ pre.dp
    return R_j, v_j, p_j


def dead_reckon(q0, v0, p0, gyro, accel, dt, gravity=9.81):
    """World-frame Euler dead-reckoning over a window: the reference's
    computeAcceleration / computeVelocity / computePosition chain
    (a_world = R a_meas + g_w, g_w = (0, 0, -g)), position first, then
    velocity, then the attitude by the gyro's rotation vector. Returns
    (q, v, p) after the window and the per-sample positions (S,3)."""
    g_w = _gravity_w(v0, gravity)
    q, v, p = q0, v0, p0
    ps = []
    for s in range(gyro.shape[0]):
        w, a, d = gyro[s], accel[s], dt[s]
        a_w = quat_to_mat(q) @ a + g_w
        p = p + v * d + 0.5 * a_w * d * d
        v = v + a_w * d
        q = quat_normalize(quat_mul(q, mat_to_quat(so3_exp(w * d))))
        ps.append(p)
    return q, v, p, torch.stack(ps)
