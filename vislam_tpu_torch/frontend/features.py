"""Per-frame feature extraction: pyramid -> detect -> describe (port of
`vislam_tpu/frontend/features.py`, Gaussian scale space, Shi-Tomasi
detector, upright SIFT descriptor)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vislam_tpu_torch.frontend.descriptor import DescriptorGeometry, describe_keypoints
from vislam_tpu_torch.frontend.detect import detect_keypoints
from vislam_tpu_torch.frontend.pyramid import build_pyramid
from vislam_tpu_torch.utils.config import FrontendConfig


class Features(NamedTuple):
    """Fixed-capacity per-frame features (field for field the reference's)."""

    uv: torch.Tensor      # (K, 2) float32, level-0 pixel coords
    desc: torch.Tensor    # (K, D) float32
    score: torch.Tensor   # (K,) float32
    level: torch.Tensor   # (K,) int32
    angle: torch.Tensor   # (K,) float32
    mask: torch.Tensor    # (K,) bool


def extract_features(image, cfg: FrontendConfig = FrontendConfig(),
                     geom: Optional[DescriptorGeometry] = None) -> Features:
    """image: (H, W) float32 in [0, 255] -> Features with K = cfg.max_keypoints.

    Detection and description run per level (descriptors on the keypoint's
    own level); uv is reported in level-0 pixels. `geom` holds the
    descriptor's static geometry on the image's device (built here if not
    given).
    """
    if geom is None:
        geom = DescriptorGeometry(image.device)
    image = image.to(getattr(torch, cfg.image_dtype))
    # Levels past levels_used are never read, so they are not built.
    pyr = build_pyramid(image, min(cfg.num_levels, cfg.levels_used))
    kps = detect_keypoints(
        pyr,
        grid_rows=cfg.grid_rows,
        grid_cols=cfg.grid_cols,
        kp_per_cell=cfg.kp_per_cell_by_level,
        nms_radius=cfg.nms_radius,
        min_score_rel=cfg.min_score,
        border=cfg.patch_size // 2 + 4,
        levels_used=cfg.levels_used,
    )
    cells = cfg.grid_rows * cfg.grid_cols
    descs = []
    off = 0
    for lvl in range(cfg.levels_used):
        n = cells * cfg.kp_per_cell_by_level[lvl]
        scale = float(2 ** lvl)
        descs.append(describe_keypoints(pyr[lvl].float(), kps.uv[off:off + n] / scale, geom))
        off += n
    return Features(uv=kps.uv, desc=torch.cat(descs, dim=0), score=kps.score,
                    level=kps.level, angle=kps.angle, mask=kps.mask)
