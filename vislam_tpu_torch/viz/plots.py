"""Offline visualization (port of `vislam_tpu/viz/plots.py`): estimate
against ground truth from a trajectory CSV (`eval.read_trajectory_csv`),
with an optional Umeyama alignment (`eval/metrics.py`). Host-side numpy and
matplotlib (Agg); matplotlib is imported only inside `_mpl()`.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(traj: dict, out_path: str, align: bool = False) -> None:
    """XY / XZ / YZ panels of the estimate against GT.

    traj: dict from read_trajectory_csv.
    """
    plt = _mpl()
    est = traj["est_p"]
    gt = traj.get("gt_p")
    if align and gt is not None and np.isfinite(gt).all():
        from vislam_tpu_torch.eval.metrics import umeyama_alignment

        R, t, s = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
    pairs = [(0, 1, "x [m]", "y [m]"), (0, 2, "x [m]", "z [m]"), (1, 2, "y [m]", "z [m]")]
    for ax, (i, j, xl, yl) in zip(axes, pairs):
        ax.plot(est[:, i], est[:, j], "b-", label="estimate", lw=1.2)
        if gt is not None and np.isfinite(gt).all():
            ax.plot(gt[:, i], gt[:, j], "g--", label="ground truth", lw=1.2)
        kf = traj.get("is_kf")
        if kf is not None and kf.any():
            ax.plot(est[kf, i], est[kf, j], "r.", ms=3, label="keyframes")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.axis("equal")
        ax.grid(alpha=0.3)
    axes[0].legend(loc="best", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_state_comparison(traj: dict, out_path: str) -> None:
    """Position, velocity and roll/pitch/yaw over time, estimate against GT."""
    plt = _mpl()
    t = (traj["t_ns"] - traj["t_ns"][0]) * 1e-9
    groups = [
        ("est_p", "gt_p", ["x", "y", "z"], "position [m]"),
        ("est_v", "gt_v", ["vx", "vy", "vz"], "velocity [m/s]"),
        ("est_rpy", "gt_rpy", ["roll", "pitch", "yaw"], "orientation [rad]"),
    ]
    fig, axes = plt.subplots(3, 3, figsize=(15, 9), sharex=True)
    for row, (ek, gk, names, ylabel) in enumerate(groups):
        est = traj[ek]
        gt = traj.get(gk)
        for col in range(3):
            ax = axes[row, col]
            e = est[:, col]
            if "rpy" in ek:
                e = np.unwrap(e)
            ax.plot(t, e, "b-", label="est", lw=1.0)
            if gt is not None and np.isfinite(gt).all():
                g = gt[:, col]
                if "rpy" in gk:
                    g = np.unwrap(g)
                ax.plot(t, g, "g--", label="gt", lw=1.0)
            ax.set_title(names[col], fontsize=9)
            ax.grid(alpha=0.3)
            if col == 0:
                ax.set_ylabel(ylabel)
    axes[0, 0].legend(fontsize=8)
    axes[-1, 1].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def draw_matches(img_a, uv_a, img_b, uv_b, mask, out_path: str,
                 max_draw: int = 200) -> None:
    """The two images side by side with up to max_draw of the masked
    matches drawn between them (uv_*: (K, 2) numpy, mask: (K,))."""
    plt = _mpl()
    H = max(img_a.shape[0], img_b.shape[0])
    Wa, Wb = img_a.shape[1], img_b.shape[1]
    canvas = np.zeros((H, Wa + Wb), dtype=np.float32)
    canvas[: img_a.shape[0], :Wa] = img_a
    canvas[: img_b.shape[0], Wa:] = img_b
    fig, ax = plt.subplots(figsize=(14, 5))
    ax.imshow(canvas, cmap="gray")
    idx = np.nonzero(np.asarray(mask))[0][:max_draw]
    for k in idx:
        ax.plot([uv_a[k, 0], uv_b[k, 0] + Wa], [uv_a[k, 1], uv_b[k, 1]], "-", lw=0.5, alpha=0.6)
    ax.plot(uv_a[idx, 0], uv_a[idx, 1], "r.", ms=2)
    ax.plot(uv_b[idx, 0] + Wa, uv_b[idx, 1], "c.", ms=2)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
