"""Relocalization: snap a lost tracker back onto the keyframe map (port of
`vislam_tpu/backend/reloc.py`).

Place recognition by global descriptors proposes archive keyframes; the
metric measurement of `trajectory_opt.measure_relative_pose` (local
triangulation and PnP from identity: a place-recognition hit means a
similar viewpoint) verifies them, which gives the live camera's pose in
the map's frame.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from vislam_tpu_torch.backend.loop import global_descriptors
from vislam_tpu_torch.backend.trajectory_opt import (
    KeyframeRecord,
    measure_relative_pose,
    to_device,
    to_host,
)


class RelocResult(NamedTuple):
    success: bool
    R_wc: Optional[np.ndarray]   # (3, 3) relocalized camera rotation
    p_wc: Optional[np.ndarray]   # (3,)
    kf_index: int                # archive index matched (-1 on failure)
    n_inliers: int
    rmse: float


def attempt_relocalization(uv, desc, kp_mask, archive: List[KeyframeRecord], fx: float,
                           fy: float, cx: float, cy: float, max_candidates: int = 3,
                           sim_thresh: float = 0.80, min_inliers: int = 25,
                           max_rmse: float = 3.0, device="cuda") -> RelocResult:
    """Localize the live frame (uv, desc, kp_mask: tensors or arrays)
    against the archive: the `max_candidates` most similar keyframes are
    measured, and the verified one with the most inliers (then the lowest
    RMSE) wins. The host waits once for the similarities and up to twice
    per candidate measured.
    """
    fail = RelocResult(False, None, None, -1, 0, float("inf"))
    if len(archive) < 2:
        return fail
    arch_desc, arch_mask, desc, kp_mask, uv = to_device(
        device, np.stack([k.desc for k in archive]), np.stack([k.kp_mask for k in archive]),
        desc, kp_mask, uv)
    g_live = global_descriptors(desc[None], kp_mask[None])[0]
    (sims,) = to_host(global_descriptors(arch_desc, arch_mask) @ g_live)
    order = np.argsort(-sims)[:max_candidates]

    eye = np.eye(3, dtype=np.float32)
    zero = np.zeros(3, np.float32)
    best: Optional[RelocResult] = None
    for a in order:
        a = int(a)
        if sims[a] < sim_thresh or a + 1 >= len(archive):
            continue
        ka = archive[a]
        # Triangulation partner: the widest-baseline archive entry within 3
        # (a one-step baseline can be centimetres: percent-level depth
        # errors that PnP amplifies into decimetres).
        near = [i for i in range(max(a - 3, 0), min(a + 4, len(archive))) if i != a]
        kn = archive[max(near, key=lambda i: np.linalg.norm(archive[i].p_wc - ka.p_wc))]
        ok, R, t, n_inl, rmse = measure_relative_pose(
            ka, kn, desc, kp_mask, uv, eye, zero, fx, fy, cx, cy, min_inliers=min_inliers,
            max_rmse=max_rmse, device=device)
        if not ok:
            continue
        # cam_live <- cam_a (X_live = R X_a + t), so R_wc = R_wc_a R^T and
        # p = p_a - R_wc t.
        R_wc = (ka.R_wc @ R.T).astype(np.float32)
        res = RelocResult(True, R_wc, (ka.p_wc - R_wc @ t).astype(np.float32), a, n_inl, rmse)
        if best is None or (n_inl, -rmse) > (best.n_inliers, -best.rmse):
            best = res
    return best if best is not None else fail
