"""Per-frame feature extraction: scale space -> detect -> describe (port of
`vislam_tpu/frontend/features.py`: the Gaussian or nonlinear scale space,
every detector family, SIFT or BRIEF descriptors, upright or oriented)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vislam_tpu_torch.frontend.binary_desc import describe_binary
from vislam_tpu_torch.frontend.descriptor import DescriptorGeometry, describe_keypoints
from vislam_tpu_torch.frontend.detect import detect_keypoints
from vislam_tpu_torch.frontend.nonlinear import nonlinear_scale_space
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
    descriptors' static geometry on the image's device (built here if not
    given). With `cfg.oriented` each descriptor is taken in its keypoint's
    orientation frame (`kps.angle`), else upright.
    """
    if geom is None:
        geom = DescriptorGeometry(image.device)
    image = image.to(getattr(torch, cfg.image_dtype))
    # Levels past levels_used are never read, so they are not built.
    n_levels = min(cfg.num_levels, cfg.levels_used)
    if cfg.scale_space == "nonlinear":
        pyr = nonlinear_scale_space(image, n_levels)
    elif cfg.scale_space == "gaussian":
        pyr = build_pyramid(image, n_levels)
    else:
        raise ValueError(f"unknown scale_space {cfg.scale_space!r}")
    kps = detect_keypoints(
        pyr,
        grid_rows=cfg.grid_rows,
        grid_cols=cfg.grid_cols,
        kp_per_cell=cfg.kp_per_cell_by_level,
        nms_radius=cfg.nms_radius,
        min_score_rel=cfg.min_score,
        border=cfg.patch_size // 2 + 4,
        levels_used=cfg.levels_used,
        detector=cfg.detector,
    )
    angle = kps.angle if cfg.oriented else None
    cells = cfg.grid_rows * cfg.grid_cols
    descs = []
    off = 0
    for lvl in range(cfg.levels_used):
        n = cells * cfg.kp_per_cell_by_level[lvl]
        level = pyr[lvl].float()
        uv = kps.uv[off:off + n] / float(2 ** lvl)
        ang = None if angle is None else angle[off:off + n]
        if cfg.descriptor == "brief":
            descs.append(describe_binary(
                level, uv, torch.zeros_like(uv[:, 0]) if ang is None else ang, geom.brief))
        else:
            descs.append(describe_keypoints(level, uv, geom, ang))
        off += n
    return Features(uv=kps.uv, desc=torch.cat(descs, dim=0), score=kps.score,
                    level=kps.level, angle=kps.angle, mask=kps.mask)
