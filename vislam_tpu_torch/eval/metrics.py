"""Trajectory evaluation: ATE / RPE (port of `vislam_tpu/eval/metrics.py`;
host-side numpy)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity/SE(3) alignment est -> gt.

    Returns (R, t, s) minimizing || gt - (s R est + t) ||^2.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    C = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est_pos: np.ndarray,
    gt_pos: np.ndarray,
    align: bool = True,
    with_scale: bool = False,
) -> float:
    """Absolute trajectory error RMSE after optional alignment."""
    est_pos = np.asarray(est_pos, np.float64)
    gt_pos = np.asarray(gt_pos, np.float64)
    if align:
        R, t, s = umeyama_alignment(est_pos, gt_pos, with_scale)
        est_pos = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(est_pos - gt_pos, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_rmse(
    est_pos: np.ndarray,
    gt_pos: np.ndarray,
    delta: int = 1,
) -> float:
    """Relative pose (translation drift) error RMSE over `delta`-frame steps."""
    est_pos = np.asarray(est_pos, np.float64)
    gt_pos = np.asarray(gt_pos, np.float64)
    de = est_pos[delta:] - est_pos[:-delta]
    dg = gt_pos[delta:] - gt_pos[:-delta]
    err = np.linalg.norm(de - dg, axis=-1)
    return float(np.sqrt((err ** 2).mean()))
