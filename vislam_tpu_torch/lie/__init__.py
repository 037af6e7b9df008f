"""Quaternion, SO(3), SE(3), Sim(3) and roll-pitch-yaw math (port of vislam_tpu.lie)."""

from vislam_tpu_torch.lie.quat import (
    mat_to_quat,
    quat_canonical,
    quat_conj,
    quat_from_axis_angle,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_slerp,
    quat_to_mat,
)
from vislam_tpu_torch.lie.so3 import (
    orthonormalize,
    so3_exp,
    so3_hat,
    so3_left_jacobian,
    so3_left_jacobian_inv,
    so3_log,
    so3_vee,
)
from vislam_tpu_torch.lie.se3 import (
    se3_adjoint,
    se3_apply,
    se3_compose,
    se3_exp,
    se3_from_matrix,
    se3_identity,
    se3_inverse,
    se3_log,
    se3_matrix,
)
from vislam_tpu_torch.lie.sim3 import (
    sim3_apply,
    sim3_compose,
    sim3_exp,
    sim3_identity,
    sim3_inverse,
    sim3_log,
)
from vislam_tpu_torch.lie.euler import (
    angle_diff,
    mat_to_rpy,
    quat_to_rpy,
    rpy_to_mat,
    rpy_to_quat,
    wrap_angle,
)

__all__ = [k for k in dir() if not k.startswith("_")]
