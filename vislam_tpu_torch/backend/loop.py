"""Loop-closure detection: global descriptors and geometric verification
(port of `vislam_tpu/backend/loop.py`). A keyframe's global descriptor is
the normalized mean of its local descriptors; candidate pairs are the top
entries of the cosine-similarity matrix outside a temporal band; a
candidate is verified with the matcher (kernel 2) and the translation
RANSAC."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vislam_tpu_torch.frontend.match import match_descriptors
from vislam_tpu_torch.frontend.pose import ransac_translation


def global_descriptors(desc, kp_mask):
    """(W, K, D) local descriptors -> (W, D) normalized global descriptors."""
    w = kp_mask.to(desc.dtype)[..., None]
    mean = torch.sum(desc * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)
    return mean / torch.clamp(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), min=1e-9)


class LoopCandidates(NamedTuple):
    idx_a: torch.Tensor  # (C,) int32 earlier keyframe
    idx_b: torch.Tensor  # (C,) int32 later keyframe
    sim: torch.Tensor    # (C,) cosine similarity
    mask: torch.Tensor   # (C,) bool


def detect_loop_candidates(gdesc, valid, min_separation: int = 5, sim_thresh: float = 0.9,
                           max_candidates: int = 8) -> LoopCandidates:
    """The top-C most similar pairs (a, b), b - a >= min_separation (fixed
    capacity; masked pairs score -1). Among pairs of equal similarity the
    order is `torch.topk`'s, which need not be `lax.top_k`'s."""
    W = gdesc.shape[0]
    S = gdesc @ gdesc.T
    ar = torch.arange(W, device=gdesc.device)
    ok = (ar[None, :] - ar[:, None] >= min_separation) & valid[:, None] & valid[None, :]
    S = torch.where(ok, S, torch.full_like(S, -1.0))
    top_sim, top_idx = torch.topk(S.reshape(-1), max_candidates)
    return LoopCandidates(idx_a=(top_idx // W).to(torch.int32),
                          idx_b=(top_idx % W).to(torch.int32),
                          sim=top_sim, mask=top_sim > sim_thresh)


def take_rows(x, idx):
    """x[idx] with idx clamped into range, as JAX's gathers clamp."""
    return x[torch.clamp(idx, 0, x.shape[0] - 1).long()]


def rays(uv, fx, fy, cx, cy):
    """Unit camera rays (M, 3) of pixels (M, 2)."""
    x = (uv[:, 0] - cx) / fx
    y = (uv[:, 1] - cy) / fy
    r = torch.stack([x, y, torch.ones_like(x)], -1)
    return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)


def verify_loop(desc_a, mask_a, uv_a, desc_b, mask_b, uv_b, fx, fy, cx, cy,
                key: Optional[torch.Tensor] = None, min_inliers: int = 24,
                ratio: float = 0.8, ransac_thresh: float = 0.02, noise=None):
    """Geometric verification of one candidate pair: the matches' epipolar
    RANSAC with identity rotation (a loop revisits a place with a similar
    heading; another heading passes only if the inliers still clear the
    bar). The 256 hypotheses come from `noise` ((2, 256, K) Gumbel) or are
    drawn under `key` ((2,) int32 on the descriptors' device), as the
    reference's verify_loop draws them.

    Returns (accepted (), R_ji (identity), t_dir (3,), num_inliers ()).
    """
    m = match_descriptors(desc_a, mask_a, desc_b, mask_b, ratio=ratio)
    ra = rays(uv_a, fx, fy, cx, cy)
    rb = rays(take_rows(uv_b, m.idx_b), fx, fy, cx, cy)
    eye = torch.eye(3, dtype=ra.dtype, device=ra.device)
    est = ransac_translation(ra, rb, eye, m.mask, key, num_hyps=256, thresh=ransac_thresh,
                             noise=noise)
    return est.num_inliers >= min_inliers, eye, est.t_dir, est.num_inliers
