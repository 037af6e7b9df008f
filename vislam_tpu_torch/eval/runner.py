"""Host-loop VIO runner for evaluation harnesses and tests (port of
`vislam_tpu/eval/runner.py`).

One way to drive `VIOEngine` over an in-memory sequence dict (the schema
of `data/synthetic.py` and `data/adversarial.py`): per frame, gather the
IMU window, inject the GT step length in the GT-scale parity mode, step,
and optionally refine the window on keyframes. The engine runs on
`device` ("cuda" unless the caller asks for the CPU; no fallback).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


def run_vio_sequence(
    seq: Dict,
    cfg=None,
    gt_scale: bool = True,
    online_ba: bool = False,
    vi_factors: Optional[bool] = None,
    init_bias: bool = False,
    n_frames: Optional[int] = None,
    device="cuda",
    seed: int = 0,
) -> Dict:
    """Run the engine over seq; returns a dict with poses (N-1, 3), gt,
    ate and the final state.

    gt_scale=True is the reference's parity mode (translation scaled by the
    GT step norm); gt_scale=False uses the IMU (visual-inertial) scale.
    online_ba runs refine_window after each keyframe promotion (host loop).
    vi_factors overrides cfg.backend.vi_factors (None leaves it as
    configured). seed is the engine's RANSAC seed (`VIOEngine(seed=...)`):
    the reference's stream, so the run draws the hypotheses the reference
    harness's run at that seed draws, on the card and on the CPU alike.
    """
    import torch

    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.engine.refine import refine_window
    from vislam_tpu_torch.eval.metrics import ate_rmse
    from vislam_tpu_torch.utils.config import SystemConfig

    calib = seq["calib"]
    cfg = cfg or SystemConfig()
    if vi_factors is not None:
        cfg = dataclasses.replace(
            cfg, backend=dataclasses.replace(cfg.backend, vi_factors=vi_factors))
    eng = VIOEngine(calib, cfg, seed, device=device)
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                           v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])
    if init_bias:
        zero = torch.zeros(3, dtype=torch.float32, device=eng.device)
        state = state._replace(bias_g=zero, bias_a=zero.clone())

    n = n_frames or len(seq["images"])
    spf = int(round((calib.rate_imu_hz or 200.0) / (calib.rate_cam_hz or 20.0)))
    pad = cfg.engine.imu_window
    dt_imu = 1.0 / (calib.rate_imu_hz or 200.0)
    last_kf = 0
    poses = []
    for j in range(1, n):
        lo, hi = (j - 1) * spf, j * spf
        imu = np.zeros((pad, 6), np.float32)
        if len(seq["imu_gyro"]) >= hi:
            imu[:spf] = np.concatenate([seq["imu_gyro"][lo:hi], seq["imu_accel"][lo:hi]], -1)
        dt = np.zeros(pad, np.float32)
        dt[:spf] = dt_imu
        gt_norm = (float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
                   if gt_scale else -1.0)
        state, res = eng.step(state, seq["images"][j], imu, dt, gt_norm)
        if bool(res.is_keyframe):
            last_kf = j
            if online_ba:
                state = refine_window(state, eng.cfg, calib.fx, calib.fy, calib.cx, calib.cy)
        poses.append(state.p_wc.cpu().numpy())
    poses = np.array(poses)
    gt = seq["gt_pos"][1:n]
    return {
        "poses": poses,
        "gt": gt,
        "ate": float(ate_rmse(poses, gt, align=False)),
        "state": state,
    }
