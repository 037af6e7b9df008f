"""Exact-GT matchability scoring: the inlier rate of a frontend on hard
imagery (port of `vislam_tpu/eval/matchability.py`).

Every match a frontend emits on an adversarial sequence
(`data/adversarial.py`) is scored against the scene's exact ground-truth
correspondence (raycast depth, true-pose reprojection, occlusion check):

    inlier  <=>  GT-visible static surface AND ||uv_match - uv_GT|| < eps.

Matches on moving occluders or mismatched repetitive texture are outliers
by construction. `repo_match_pairs` runs the port's frontend
(`extract_features` + `match_descriptors`, on the card unless the caller
asks for the CPU). The OpenCV baseline (`opencv_match_pairs` of the JAX
package) is not part of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class MatchabilityResult:
    name: str
    n_pairs: int
    matches_per_pair: float
    inliers_per_pair: float
    inlier_rate: float          # pooled inliers / pooled matches
    mean_px_err: float          # over GT-valid matches

    def row(self) -> str:
        return (f"| {self.name} | {self.matches_per_pair:.1f} | "
                f"{self.inliers_per_pair:.1f} | {100 * self.inlier_rate:.1f}% | "
                f"{self.mean_px_err:.2f} |")


def score_pairs(scene, pair_data: List[Dict], eps_px: float = 4.0,
                name: str = "") -> MatchabilityResult:
    """pair_data: list of dicts with keys i, j, uv_a (M,2), uv_b (M,2) — the
    matched coordinate pairs a frontend produced for frames (i, j)."""
    tot_m, tot_in, errs = 0, 0, []
    for d in pair_data:
        if len(d["uv_a"]) == 0:
            continue
        gt_uv, valid = scene.gt_correspondence(d["i"], d["uv_a"], d["j"])
        err = np.linalg.norm(gt_uv - d["uv_b"], axis=-1)
        inl = valid & (err < eps_px)
        tot_m += len(d["uv_a"])
        tot_in += int(inl.sum())
        errs.extend(err[valid].tolist())
    n = max(len(pair_data), 1)
    return MatchabilityResult(
        name=name, n_pairs=len(pair_data),
        matches_per_pair=tot_m / n, inliers_per_pair=tot_in / n,
        inlier_rate=tot_in / max(tot_m, 1),
        mean_px_err=float(np.mean(errs)) if errs else float("nan"),
    )


def rotation_predicted_uv(seq: Dict, i: int, j: int, uv_a: np.ndarray):
    """Rotation-only warp of frame-i pixels into frame j: the prediction the
    engine's guided matching uses (there the IMU-integrated rotation, here
    the GT rotation). Zero-parallax; the gate radius absorbs parallax."""
    from scipy.spatial.transform import Rotation as _Rot

    calib = seq["calib"]
    q = seq["gt_quat"]
    R_i = _Rot.from_quat(np.roll(q[i], -1)).as_matrix()
    R_j = _Rot.from_quat(np.roll(q[j], -1)).as_matrix()
    R_rel = R_j.T @ R_i  # cam_i ray -> cam_j ray
    rays = np.stack([
        (uv_a[:, 0] - calib.cx) / calib.fx,
        (uv_a[:, 1] - calib.cy) / calib.fy,
        np.ones(len(uv_a)),
    ], -1)
    r2 = rays @ R_rel.T
    z = np.maximum(r2[:, 2], 1e-6)
    return np.stack([calib.fx * r2[:, 0] / z + calib.cx,
                     calib.fy * r2[:, 1] / z + calib.cy], -1)


def repo_match_pairs(seq: Dict, fcfg=None, stride: int = 1,
                     grid_dedup: bool = False, gate_px: float = 0.0,
                     device="cuda") -> List[Dict]:
    """Run the port's frontend (extract_features + match_descriptors) over
    consecutive frame pairs on `device`; return the matched uv pairs for
    score_pairs.

    gate_px > 0 gates the match at the rotation-predicted position (the
    engine's IMU-rotation warp). grid_dedup keeps the best match per cell
    of the frontend's match grid."""
    import torch

    from vislam_tpu_torch.engine.engine import require_device
    from vislam_tpu_torch.frontend.descriptor import DescriptorGeometry
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.match import match_descriptors
    from vislam_tpu_torch.utils.config import FrontendConfig

    device = require_device(device)
    fcfg = fcfg or FrontendConfig()
    geom = DescriptorGeometry(device)
    images = seq["images"]
    feats = [extract_features(torch.as_tensor(np.asarray(im, np.float32), device=device),
                              fcfg, geom) for im in images]
    H, W = images[0].shape
    out = []
    for i in range(0, len(images) - stride, stride):
        j = i + stride
        fa, fb = feats[i], feats[j]
        kw = {}
        if grid_dedup:
            kw = dict(uv_a=fa.uv, cell_rows=fcfg.match_cell_rows,
                      cell_cols=fcfg.match_cell_cols, image_size=(H, W))
        if gate_px > 0:
            uv_pred = rotation_predicted_uv(seq, i, j, fa.uv.cpu().numpy())
            kw.update(uv_pred=torch.as_tensor(uv_pred, dtype=torch.float32, device=device),
                      uv_b=fb.uv, gate_radius=gate_px)
        m = match_descriptors(fa.desc, fa.mask, fb.desc, fb.mask, ratio=fcfg.ratio_thresh,
                              mutual=fcfg.mutual_check, **kw)
        sel = m.mask.cpu().numpy()
        uv_a = fa.uv.cpu().numpy()[sel]
        uv_b = fb.uv.cpu().numpy()[m.idx_b.cpu().numpy()[sel]]
        out.append({"i": i, "j": j, "uv_a": uv_a, "uv_b": uv_b})
    return out
