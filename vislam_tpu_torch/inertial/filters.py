"""The Madgwick and complementary orientation filters and the tilt from a
static accelerometer sample (port of `vislam_tpu/inertial/filters.py`).

Conventions: quaternions [w,x,y,z] rotate body->world; the accelerometer
measures specific force. Padded samples carry dt = 0, which makes the
update a no-op, so a fixed 16-sample window needs no host-side trimming.
"""

from __future__ import annotations

import torch

from vislam_tpu_torch.lie.quat import quat_mul, quat_normalize, quat_rotate


def _unit(accel):
    return accel / torch.clamp(torch.linalg.vector_norm(accel, dim=-1, keepdim=True), min=1e-9)


def orientation_from_accel(accel):
    """Tilt-only quaternion (zero yaw) from a (quasi-)static accelerometer
    sample: the roll/pitch that align the body z axis with gravity."""
    ax, ay, az = _unit(accel).unbind(-1)
    roll = torch.atan2(ay, az)
    pitch = torch.atan2(-ax, torch.sqrt(ay * ay + az * az))
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    return torch.stack([cr * cp, sr * cp, cr * sp, -sr * sp], dim=-1)


def madgwick_step(q, gyro, accel, dt, beta=0.1, gravity=9.81):
    """One Madgwick IMU update (gyro + gravity-gated accel correction)."""
    w, x, y, z = q.unbind(-1)
    ax, ay, az = _unit(accel).unbind(-1)

    # Objective: predicted gravity direction in body frame minus measured.
    f1 = 2.0 * (x * z - w * y) - ax
    f2 = 2.0 * (w * x + y * z) - ay
    f3 = 2.0 * (0.5 - x * x - y * y) - az
    # J^T f, the Madgwick gradient.
    g1 = -2.0 * y * f1 + 2.0 * x * f2
    g2 = 2.0 * z * f1 + 2.0 * w * f2 - 4.0 * x * f3
    g3 = -2.0 * w * f1 + 2.0 * z * f2 - 4.0 * y * f3
    g4 = 2.0 * x * f1 + 2.0 * y * f2
    grad = torch.stack([g1, g2, g3, g4], dim=-1)
    gn = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    grad = grad / torch.clamp(gn, min=1e-12)
    # Full correction weight when |accel| ~= g, decaying with dynamic
    # acceleration; 0 in freefall.
    a_mag = torch.linalg.vector_norm(accel, dim=-1, keepdim=True)
    rel_dev = torch.abs(a_mag - gravity) / gravity
    acc_w = torch.exp(-(rel_dev / 0.1) ** 2) * (a_mag > 1e-6).to(q.dtype)

    omega = torch.cat([torch.zeros_like(gyro[..., :1]), gyro], dim=-1)
    q_dot = 0.5 * quat_mul(q, omega) - beta * acc_w * grad
    q_new = q + q_dot * dt[..., None]
    return quat_normalize(q_new)


def madgwick_scan(q0, gyro, accel, dt, beta=0.1, gravity=9.81):
    """Run the filter over a window: gyro/accel (S,3), dt (S,) with 0 for
    padded rows. Returns (q_final, q_all (S,4)). The reference's lax.scan
    is a Python loop over the S samples here."""
    q = q0
    qs = []
    for s in range(gyro.shape[0]):
        q = madgwick_step(q, gyro[s], accel[s], dt[s], beta, gravity)
        qs.append(q)
    return q, torch.stack(qs)


def complementary_step(q, gyro, accel, dt, alpha=0.02, gravity=9.81):
    """One complementary-filter update: gyro integration, then a tilt
    correction towards the measured gravity, blended by alpha and gated by
    dynamic acceleration as the Madgwick path is. A padded row (dt = 0)
    leaves q unchanged."""
    omega = torch.cat([torch.zeros_like(gyro[..., :1]), gyro], dim=-1)
    q_gyro = quat_normalize(q + 0.5 * quat_mul(q, omega) * dt[..., None])

    # The measured accel rotated to world should be ~+z; the rotation from
    # it to +z (axis g x z, angle arccos(g_z)) is the correction.
    gx, gy, gz = quat_rotate(q_gyro, _unit(accel)).unbind(-1)
    axis = torch.stack([gy, -gx, torch.zeros_like(gx)], dim=-1)
    axis_n = torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-9)
    angle = torch.acos(torch.clamp(gz, -1.0 + 1e-7, 1.0 - 1e-7))
    a_mag = torch.linalg.vector_norm(accel, dim=-1, keepdim=True)
    acc_w = torch.exp(-(torch.abs(a_mag - gravity) / (0.1 * gravity)) ** 2)
    half = 0.5 * alpha * acc_w * angle[..., None]
    dq = torch.cat([torch.cos(half), axis / axis_n * torch.sin(half)], dim=-1)
    active = (dt > 0).to(q.dtype)[..., None]
    ident = torch.cat([torch.ones_like(dq[..., :1]), torch.zeros_like(dq[..., 1:])], dim=-1)
    dq = active * dq + (1.0 - active) * ident
    return quat_normalize(quat_mul(dq, q_gyro))


def complementary_scan(q0, gyro, accel, dt, alpha=0.02, gravity=9.81):
    """complementary_step over a window, as madgwick_scan: returns
    (q_final, q_all (S,4))."""
    q = q0
    qs = []
    for s in range(gyro.shape[0]):
        q = complementary_step(q, gyro[s], accel[s], dt[s], alpha, gravity)
        qs.append(q)
    return q, torch.stack(qs)
