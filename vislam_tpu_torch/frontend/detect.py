"""Corner detection with fixed-capacity grid top-k (port of
`vislam_tpu/frontend/detect.py`, every detector family).

Per pyramid level: the fused response+NMS of the chosen family
(`ops/harris_kernel.py`, which also holds the plain responses re-exported
here; the CUDA kernel for a CUDA tensor), top-k per grid cell inside the
border, quadratic subpixel refinement on the raw response, and a gradient
orientation per keypoint. Every index into a field is clamped explicitly:
CUDA indexing asserts where JAX clamps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vislam_tpu_torch.frontend.pyramid import gaussian_taps
from vislam_tpu_torch.ops.harris_kernel import (  # noqa: F401  (the reference's names)
    _FAST_RING,
    DETECTOR_RESPONSES,
    dog_response,
    fast_response,
    harris_cornerness,
    harris_response,
    hessian_response,
    response_nms,
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (padded; `mask` marks valid rows)."""

    uv: torch.Tensor       # (K, 2) float32 pixel coords (level-0 frame)
    score: torch.Tensor    # (K,) float32 corner response
    level: torch.Tensor    # (K,) int32 pyramid level
    angle: torch.Tensor    # (K,) float32 orientation (radians)
    mask: torch.Tensor     # (K,) bool


def _grid_topk(resp, grid_rows: int, grid_cols: int, k_per_cell: int, border: int):
    """Top-k responses per grid cell -> (K, 2) uv + (K,) score, K = cells*k.

    Equal scores go by row-major index, the lowest first, as lax.top_k
    takes them (a stable sort: torch.topk leaves the choice among equal
    scores open, and FAST's scores tie often)."""
    H, W = resp.shape
    dev = resp.device
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    interior = ((rows >= border) & (rows < H - border)
                & (cols >= border) & (cols < W - border))
    resp = torch.where(interior, resp, torch.full_like(resp, -torch.inf))

    ch = H // grid_rows
    cw = W // grid_cols
    cells = resp[: ch * grid_rows, : cw * grid_cols]
    cells = cells.reshape(grid_rows, ch, grid_cols, cw).permute(0, 2, 1, 3)
    cells = cells.reshape(grid_rows * grid_cols, ch * cw)

    score, flat_idx = torch.sort(cells, dim=1, descending=True, stable=True)
    score, flat_idx = score[:, :k_per_cell], flat_idx[:, :k_per_cell]  # (cells, k)
    cell_ids = torch.arange(grid_rows * grid_cols, device=dev)[:, None]
    v = (cell_ids // grid_cols) * ch + flat_idx // cw
    u = (cell_ids % grid_cols) * cw + flat_idx % cw
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1).float()
    return uv, score.reshape(-1)


def _subpixel_refine(resp, uv):
    """Quadratic 1D refinement per axis on the response surface (+-0.5 px)."""
    H, W = resp.shape
    u = torch.clamp(uv[:, 0].to(torch.int64), 1, W - 2)
    v = torch.clamp(uv[:, 1].to(torch.int64), 1, H - 2)

    def grab(dv, du):
        return resp[v + dv, u + du]

    c = grab(0, 0)
    dx = 0.5 * (grab(0, 1) - grab(0, -1))
    dy = 0.5 * (grab(1, 0) - grab(-1, 0))
    dxx = grab(0, 1) + grab(0, -1) - 2 * c
    dyy = grab(1, 0) + grab(-1, 0) - 2 * c
    zero = torch.zeros_like(c)
    off_u = torch.where(dxx.abs() > 1e-9, -dx / dxx, zero)
    off_v = torch.where(dyy.abs() > 1e-9, -dy / dyy, zero)
    off_u = torch.clamp(off_u, -0.5, 0.5)
    off_v = torch.clamp(off_v, -0.5, 0.5)
    return uv + torch.stack([off_u, off_v], dim=-1)


def _orientations(img, uv, sigma: float = 2.5):
    """Dominant gradient orientation at each keypoint: blur (radius 3) and
    Scharr in 16x16 patch space, read at the keypoint pixel."""
    from vislam_tpu_torch.frontend.descriptor import (
        _shift_conv_patches, extract_patches)

    P = 16
    patches, iu0, iv0 = extract_patches(img.float(), uv, P)
    g = gaussian_taps(sigma, 3)
    sm = _shift_conv_patches(_shift_conv_patches(patches, g, 1), g, 2)
    sx = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    dx = (-1.0, 0.0, 1.0)
    gx = _shift_conv_patches(_shift_conv_patches(sm, sx, 1), dx, 2)
    gy = _shift_conv_patches(_shift_conv_patches(sm, sx, 2), dx, 1)
    # Centre pixel of each patch = the keypoint pixel (clipped at borders).
    cu = torch.clamp(uv[:, 0].to(torch.int64), 0, img.shape[1] - 1) - iu0
    cv = torch.clamp(uv[:, 1].to(torch.int64), 0, img.shape[0] - 1) - iv0
    cu = torch.clamp(cu, 0, P - 1)
    cv = torch.clamp(cv, 0, P - 1)
    k = torch.arange(uv.shape[0], device=uv.device)
    return torch.atan2(gy[k, cv, cu], gx[k, cv, cu])


def detect_keypoints(
    pyramid,
    grid_rows: int = 8,
    grid_cols: int = 8,
    kp_per_cell=8,
    nms_radius: int = 2,
    min_score_rel: float = 1e-3,
    border: int = 12,
    levels_used: int = 1,
    detector: str = "shi_tomasi",
) -> Keypoints:
    """Detect fixed-capacity keypoints of the `detector` family over
    `levels_used` levels.

    kp_per_cell is an int or per-level budgets. K = grid_rows * grid_cols *
    sum(budgets); rows below the relative score floor are masked out.
    Coordinates are level-0 pixels.
    """
    if isinstance(kp_per_cell, int):
        kp_by_level = (kp_per_cell,) * levels_used
    else:
        kp_by_level = tuple(kp_per_cell)
    all_uv, all_score, all_level, all_angle = [], [], [], []
    for lvl in range(levels_used):
        img = pyramid[lvl]
        # Response in float32 on the (bf16-rounded) level, as the
        # reference's TPU kernel computes it; selection in float32.
        resp, full_resp = response_nms(img.float().contiguous(), detector, nms_radius)
        uv, score = _grid_topk(resp, grid_rows, grid_cols, kp_by_level[lvl], border)
        uv = _subpixel_refine(full_resp, uv)
        angle = _orientations(img, uv)
        scale = float(2 ** lvl)
        all_uv.append(uv * scale)
        all_score.append(score)
        all_level.append(torch.full(score.shape, lvl, dtype=torch.int32,
                                    device=score.device))
        all_angle.append(angle)

    uv = torch.cat(all_uv, dim=0)
    score = torch.cat(all_score, dim=0)
    level = torch.cat(all_level, dim=0)
    angle = torch.cat(all_angle, dim=0)
    # Mask: finite responses above a floor relative to the strongest corner.
    finite = torch.isfinite(score)
    floor = min_score_rel * torch.max(torch.where(finite, score, torch.zeros_like(score)))
    mask = finite & (score > torch.clamp(floor, min=1e-12))
    return Keypoints(uv=uv, score=score, level=level, angle=angle, mask=mask)
