"""Quaternion math, Hamilton convention, layout [w, x, y, z] (port of
`vislam_tpu/lie/quat.py`). Everything broadcasts over leading dims; the
NaN-safe branches are `torch.where` on guarded inputs."""

from __future__ import annotations

import torch

_EPS = 1e-12


def quat_identity(dtype=torch.float32, *, device="cuda"):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    """Normalize to unit quaternion; safe for zero input (returns identity)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ok = n > _EPS
    out = q / torch.where(ok, n, torch.ones_like(n))
    # Built without an element write: writing a Python scalar into a CUDA
    # tensor is a host->device copy, a host sync.
    ident = torch.cat([torch.ones_like(q[..., :1]), torch.zeros_like(q[..., 1:])], dim=-1)
    return torch.where(ok, out, ident)


def quat_canonical(q):
    """Flip sign so w >= 0 (q and -q are the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(a, b):
    """Hamilton product a*b: rotation b followed by rotation a."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion q (same as quat_to_mat(q) @ v)."""
    qw = q[..., :1]
    # linalg.cross broadcasts only between operands of one rank.
    qv, v = torch.broadcast_tensors(q[..., 1:], v)
    # v' = v + 2 qv x (qv x v + w v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_mat(q):
    """Unit quaternion -> 3x3 rotation matrix (batched)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """3x3 rotation matrix -> unit quaternion [w,x,y,z], branch-free: the
    4-candidate construction selected by the largest diagonal combination
    (stable for all rotations, including trace -1)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(t):
        return torch.sqrt(torch.clamp(t, min=_EPS))

    qw = torch.stack([tw, m21 - m12, m02 - m20, m10 - m01], dim=-1) / (
        2.0 * safe_sqrt(tw)[..., None])
    qx = torch.stack([m21 - m12, tx, m01 + m10, m02 + m20], dim=-1) / (
        2.0 * safe_sqrt(tx)[..., None])
    qy = torch.stack([m02 - m20, m01 + m10, ty, m12 + m21], dim=-1) / (
        2.0 * safe_sqrt(ty)[..., None])
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, tz], dim=-1) / (
        2.0 * safe_sqrt(tz)[..., None])

    idx = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)[..., None]
    q = torch.where(idx == 0, qw,
                    torch.where(idx == 1, qx, torch.where(idx == 2, qy, qz)))
    return quat_canonical(quat_normalize(q))


def quat_from_axis_angle(axis, angle):
    """Unit axis (...,3) + angle (...) -> quaternion."""
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_slerp(q0, q1, t):
    """Spherical linear interpolation along the shortest arc; linear where
    the two are nearly equal (sin of the angle < 1e-5). t broadcasts as
    (..., 1)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    theta = torch.acos(torch.clamp(dot.abs(), 0.0, 1.0 - _EPS))
    sin_theta = torch.sin(theta)
    lerp = sin_theta < 1e-5
    den = torch.where(lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / den)
    w1 = torch.where(lerp, t * torch.ones_like(theta), torch.sin(t * theta) / den)
    return quat_normalize(w0 * q0 + w1 * q1)
