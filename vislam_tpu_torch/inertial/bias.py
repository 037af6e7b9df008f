"""IMU bias calibration from static intervals (port of
`vislam_tpu/inertial/bias.py`): variance-windowed static detection and
masked-mean bias estimates with gravity removal, on tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_sum(x, window: int):
    """Sum over the centred window [j - window//2, j + window - 1 - window//2]
    of each sample j along dim 0 of x (N,) or (N, C), the ends edge-extended:
    the reference's edge pad, convolve(..., "same") and slice, as one valid
    convolution of the padded signal."""
    h = window // 2
    cols = x.reshape(x.shape[0], -1).T[:, None, :]          # (C, 1, N)
    xp = torch.cat([cols[..., :1].expand(-1, -1, h), cols,
                    cols[..., -1:].expand(-1, -1, h)], dim=-1)
    w = torch.ones((1, 1, window), dtype=x.dtype, device=x.device)
    out = F.conv1d(xp, w)[:, 0, : x.shape[0]]               # (C, N)
    return out.T.reshape(x.shape)


def _windowed_std(x, window: int):
    """Per-sample centred-window standard deviation along dim 0, edge-padded."""
    mean = _window_sum(x, window) / window
    mean2 = _window_sum(x * x, window) / window
    return torch.sqrt(torch.clamp(mean2 - mean * mean, min=0.0))


def static_mask(gyro, accel, window: int = 20, gyro_std_thresh: float = 0.01,
                accel_std_thresh: float = 0.08, gravity: float = 9.81,
                accel_mag_thresh: float = 1.5, gyro_mag_thresh: float = 0.2):
    """Per-sample boolean mask of quasi-static samples: windowed std of each
    axis under a threshold (invariant to the sensor bias), |accel| near
    gravity and a loose bound on |gyro| (constant-rate rotation has no
    variance but is not static); then eroded by the window so samples next
    to motion do not count."""
    gyro_std = torch.amax(_windowed_std(gyro, window), dim=-1)
    accel_std = torch.amax(_windowed_std(accel, window), dim=-1)
    accel_dev = torch.abs(torch.linalg.vector_norm(accel, dim=-1) - gravity)
    gyro_mag = torch.linalg.vector_norm(gyro, dim=-1)
    ok = ((gyro_std < gyro_std_thresh) & (accel_std < accel_std_thresh)
          & (accel_dev < accel_mag_thresh) & (gyro_mag < gyro_mag_thresh))
    counts = _window_sum(ok.to(gyro.dtype), window)
    return counts >= (window - 0.5)


def calibrate_gyro_bias(gyro, mask=None):
    """Mean gyro over the static samples."""
    if mask is None:
        return torch.mean(gyro, dim=0)
    w = mask.to(gyro.dtype)[:, None]
    return torch.sum(gyro * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)


def calibrate_accel_bias(accel, mask=None, gravity: float = 9.81, R_wb=None):
    """Accel bias from the static samples: mean(accel) - R_wb^T [0, 0, g]
    with the body attitude R_wb; without one, gravity is removed along the
    measured mean direction (the bias is then entangled with the tilt)."""
    if mask is None:
        mean = torch.mean(accel, dim=0)
    else:
        w = mask.to(accel.dtype)[:, None]
        mean = torch.sum(accel * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    if R_wb is not None:
        g = torch.tensor([0.0, 0.0, gravity], dtype=accel.dtype, device=accel.device)
        return mean - R_wb.T @ g
    direction = mean / torch.clamp(torch.linalg.vector_norm(mean), min=1e-9)
    return mean - gravity * direction
