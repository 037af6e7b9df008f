"""Madgwick orientation filter (port of `vislam_tpu/inertial/filters.py`).

Conventions: quaternions [w,x,y,z] rotate body->world; the accelerometer
measures specific force. Padded samples carry dt = 0, which makes the
update a no-op, so a fixed 16-sample window needs no host-side trimming.
"""

from __future__ import annotations

import torch

from vislam_tpu_torch.lie.quat import quat_mul, quat_normalize


def madgwick_step(q, gyro, accel, dt, beta=0.1, gravity=9.81):
    """One Madgwick IMU update (gyro + gravity-gated accel correction)."""
    w, x, y, z = q.unbind(-1)
    a = accel / torch.clamp(
        torch.linalg.vector_norm(accel, dim=-1, keepdim=True), min=1e-9)
    ax, ay, az = a.unbind(-1)

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
