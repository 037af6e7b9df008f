"""Synthetic visual-inertial scenes with exact ground truth (port of
`vislam_tpu/data/synthetic.py`; host-side numpy only), and the EuRoC
directory fixture written from one (`write_euroc_fixture`).

A smooth analytic camera trajectory over a textured 3D landmark field,
rendered to images, with IMU measurements derived from the same trajectory
(gyro from relative rotations, accelerometer as specific force incl.
gravity). For the same config and seed the output is byte-identical to the
reference generator's (a test holds it so).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
from scipy.spatial.transform import Rotation as _Rot

from vislam_tpu_torch.calib.camera_model import CameraCalib
from vislam_tpu_torch.data.png import write_png


def synthetic_calib(width: int = 752, height: int = 480) -> CameraCalib:
    """Distortion-free pinhole used by the synthetic scenes."""
    return CameraCalib(
        fx=400.0, fy=400.0, cx=width / 2.0, cy=height / 2.0,
        dist=(0.0, 0.0, 0.0, 0.0), width=width, height=height,
        rate_cam_hz=20.0, rate_imu_hz=200.0,
    )


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    n_frames: int = 60
    n_landmarks: int = 400
    seed: int = 0
    trans_amp: tuple = (1.2, 0.8, 0.4)    # meters
    rot_amp: tuple = (0.06, 0.08, 0.15)   # roll, pitch, yaw (radians)
    gravity: float = 9.81
    gyro_noise: float = 0.0
    accel_noise: float = 0.0
    gyro_bias: tuple = (0.0, 0.0, 0.0)
    accel_bias: tuple = (0.0, 0.0, 0.0)
    # Linear in-run bias drift (units/s): bias(t) = bias + drift * t.
    gyro_bias_drift: tuple = (0.0, 0.0, 0.0)
    accel_bias_drift: tuple = (0.0, 0.0, 0.0)
    patch_half: int = 3                   # landmark texture patch half-size
    background_noise: float = 6.0


def _trajectory(cfg: SyntheticConfig, t: np.ndarray):
    """Analytic world-frame position/velocity/acceleration and body->world
    rotations at times t (seconds); world z is up, the camera looks along
    world +y toward the landmark field."""
    ax_, ay_, az_ = cfg.trans_amp
    w1, w2, w3 = 2 * np.pi * 0.25, 2 * np.pi * 0.17, 2 * np.pi * 0.11
    pos = np.stack(
        [ax_ * np.sin(w1 * t), ay_ * np.sin(w2 * t), az_ * np.sin(w3 * t)], -1
    )
    vel = np.stack(
        [ax_ * w1 * np.cos(w1 * t), ay_ * w2 * np.cos(w2 * t), az_ * w3 * np.cos(w3 * t)], -1
    )
    acc = np.stack(
        [-ax_ * w1 ** 2 * np.sin(w1 * t), -ay_ * w2 ** 2 * np.sin(w2 * t),
         -az_ * w3 ** 2 * np.sin(w3 * t)], -1
    )
    rr, rp, ry = cfg.rot_amp
    wr, wp, wy = 2 * np.pi * 0.21, 2 * np.pi * 0.13, 2 * np.pi * 0.09
    rpy = np.stack(
        [rr * np.sin(wr * t), rp * np.sin(wp * t), ry * np.sin(wy * t)], -1
    )
    R_wb = _Rot.from_euler("ZYX", rpy[:, ::-1]).as_matrix()
    return pos, vel, acc, R_wb, rpy


def imu_measurements(cfg: SyntheticConfig, t_imu: np.ndarray, rng_imu):
    """Body-frame gyro/accel at times t_imu, with the configured bias, bias
    drift and white noise applied."""
    dt_imu = float(t_imu[1] - t_imu[0]) if len(t_imu) > 1 else 1.0
    _, _, acc_i, R_wb_i, _ = _trajectory(cfg, t_imu)
    dR = np.einsum("nij,nik->njk", R_wb_i[:-1], R_wb_i[1:])  # R_i^T R_{i+1}
    rotvec = _Rot.from_matrix(dR).as_rotvec() / dt_imu
    gyro = np.vstack([rotvec, rotvec[-1:]])
    g_w = np.array([0.0, 0.0, -cfg.gravity])
    accel = np.einsum("nji,nj->ni", R_wb_i, acc_i - g_w)
    t_imu_col = t_imu[:, None]
    gyro = (gyro + np.asarray(cfg.gyro_bias)
            + np.asarray(cfg.gyro_bias_drift) * t_imu_col
            + cfg.gyro_noise * rng_imu.standard_normal(gyro.shape))
    accel = (accel + np.asarray(cfg.accel_bias)
             + np.asarray(cfg.accel_bias_drift) * t_imu_col
             + cfg.accel_noise * rng_imu.standard_normal(accel.shape))
    return gyro, accel


def make_synthetic_sequence(
    cfg: SyntheticConfig = SyntheticConfig(),
    calib: Optional[CameraCalib] = None,
) -> Dict[str, np.ndarray]:
    """Generate a full sequence.

    Returns a dict:
      images        (N, H, W) uint8
      t_cam_ns      (N,) int64
      gt_pos/gt_vel (N, 3), gt_quat (N, 4) [w,x,y,z], gt_rpy (N, 3)
      imu_t_ns      (M,) int64
      imu_gyro/imu_accel (M, 3) float32   body-frame measurements
      landmarks     (L, 3) world points
      calib         the CameraCalib used
    """
    calib = calib or synthetic_calib()
    rng = np.random.default_rng(cfg.seed)
    N = cfg.n_frames
    dt_cam = 1.0 / calib.rate_cam_hz
    dt_imu = 1.0 / calib.rate_imu_hz
    t_cam = np.arange(N) * dt_cam
    n_imu = int(round((N - 1) * dt_cam / dt_imu)) + 1
    t_imu = np.arange(n_imu) * dt_imu

    # Landmarks in front of the camera path (z in [4, 12]).
    L = cfg.n_landmarks
    lm = np.stack(
        [
            rng.uniform(-6, 6, L),
            rng.uniform(-4, 4, L),
            rng.uniform(4.0, 12.0, L),
        ],
        -1,
    )

    pos_c, vel_c, _, R_wb_c, rpy_c = _trajectory(cfg, t_cam)
    quat_c = _Rot.from_matrix(R_wb_c).as_quat()  # xyzw
    quat_wxyz = np.roll(quat_c, 1, axis=-1)

    # IMU noise comes from a dedicated child generator so that sequences
    # stay prefix-stable across lengths.
    rng_imu = np.random.default_rng(int(rng.integers(2 ** 62)))
    gyro, accel = imu_measurements(cfg, t_imu, rng_imu)

    # Each landmark gets a fixed random texture patch, splatted with
    # bilinear sub-pixel placement.
    H, W = calib.height, calib.width
    ph = cfg.patch_half
    psz = 2 * ph + 1
    patches = rng.uniform(40, 255, size=(L, psz, psz)).astype(np.float32)
    kernel = np.array([0.25, 0.5, 0.25])
    patches = np.apply_along_axis(lambda r: np.convolve(r, kernel, "same"), 1, patches)
    patches = np.apply_along_axis(lambda r: np.convolve(r, kernel, "same"), 2, patches)

    images = np.zeros((N, H, W), np.uint8)
    fx, fy, cx, cy = calib.fx, calib.fy, calib.cx, calib.cy
    for n in range(N):
        img = cfg.background_noise * rng.standard_normal((H, W)).astype(np.float32) + 20.0
        Xc = (lm - pos_c[n]) @ R_wb_c[n]  # world -> camera(body): R^T (X - p)
        z = Xc[:, 2]
        vis = z > 0.5
        u = fx * Xc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * Xc[:, 1] / np.maximum(z, 1e-6) + cy
        vis &= (u > ph + 1) & (u < W - ph - 2) & (v > ph + 1) & (v < H - ph - 2)
        for k in np.nonzero(vis)[0]:
            ui, vi = int(np.floor(u[k])), int(np.floor(v[k]))
            du, dv = u[k] - ui, v[k] - vi
            p = patches[k]
            w00, w01, w10, w11 = (1 - du) * (1 - dv), du * (1 - dv), (1 - du) * dv, du * dv
            sl = np.s_[vi - ph : vi + ph + 2, ui - ph : ui + ph + 2]
            blk = np.zeros((psz + 1, psz + 1), np.float32)
            blk[:-1, :-1] += w00 * p
            blk[:-1, 1:] += w01 * p
            blk[1:, :-1] += w10 * p
            blk[1:, 1:] += w11 * p
            img[sl] = np.maximum(img[sl], blk)
        images[n] = np.clip(img, 0, 255).astype(np.uint8)

    t0_ns = 1_000_000_000_000  # arbitrary epoch, EUROC-style absolute ns
    return {
        "images": images,
        "t_cam_ns": (t0_ns + (t_cam * 1e9)).astype(np.int64),
        "gt_pos": pos_c,
        "gt_vel": vel_c,
        "gt_quat": quat_wxyz,
        "gt_rpy": rpy_c,
        "imu_t_ns": (t0_ns + (t_imu * 1e9)).astype(np.int64),
        "imu_gyro": gyro.astype(np.float32),
        "imu_accel": accel.astype(np.float32),
        "landmarks": lm,
        "calib": calib,
    }


def write_euroc_fixture(
    path: str,
    cfg: SyntheticConfig = SyntheticConfig(n_frames=20, n_landmarks=150),
    calib: Optional[CameraCalib] = None,
    static_prefix_s: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Write a synthetic sequence in the EuRoC mav0/ directory layout:
    cam0/data/<t_ns>.png, imu0/data.csv and state_groundtruth_estimate0/
    data.csv with the EuRoC column schema (the reference's fixture, the
    same CSV text; the PNGs through `data/png.py`).

    static_prefix_s prepends stationary IMU samples (bias calibration).
    """
    seq = make_synthetic_sequence(cfg, calib)
    root = os.path.join(path, "mav0")
    cam_dir = os.path.join(root, "cam0", "data")
    imu_dir = os.path.join(root, "imu0")
    gt_dir = os.path.join(root, "state_groundtruth_estimate0")
    for d in (cam_dir, imu_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    for img, t in zip(seq["images"], seq["t_cam_ns"]):
        write_png(os.path.join(cam_dir, f"{int(t)}.png"), img)

    dt_imu_ns = int(1e9 / (seq["calib"].rate_imu_hz or 200.0))
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        if static_prefix_s > 0:
            n_static = int(static_prefix_s * (seq["calib"].rate_imu_hz or 200.0))
            t_start = int(seq["imu_t_ns"][0]) - n_static * dt_imu_ns
            # A static, biased sensor reads its bias (gyro) and bias plus
            # the gravity reaction (accel).
            bg, ba = cfg.gyro_bias, cfg.accel_bias
            g = cfg.gravity
            for k in range(n_static):
                f.write(
                    f"{t_start + k * dt_imu_ns},{bg[0]},{bg[1]},{bg[2]},"
                    f"{ba[0]},{ba[1]},{ba[2] + g}\n"
                )
        for t, w, a in zip(seq["imu_t_ns"], seq["imu_gyro"], seq["imu_accel"]):
            f.write(f"{int(t)},{w[0]},{w[1]},{w[2]},{a[0]},{a[1]},{a[2]}\n")

    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x,v_y,v_z,"
                "b_w_x,b_w_y,b_w_z,b_a_x,b_a_y,b_a_z\n")
        for t, p, q, v in zip(seq["t_cam_ns"], seq["gt_pos"], seq["gt_quat"], seq["gt_vel"]):
            bg, ba = cfg.gyro_bias, cfg.accel_bias
            f.write(
                f"{int(t)},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]},"
                f"{v[0]},{v[1]},{v[2]},{bg[0]},{bg[1]},{bg[2]},{ba[0]},{ba[1]},{ba[2]}\n"
            )
    return seq
