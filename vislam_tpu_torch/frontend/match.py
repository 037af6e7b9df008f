"""Descriptor matching: top-2 core + Lowe ratio + mutual check (port of
`vislam_tpu/frontend/match.py`; the grid dedup, which the engine does not
use, serves `eval/matchability.py`).

The distance / top-2 / column-argmin core is `ops/match_kernel.py` (the
CUDA kernel for CUDA tensors); the filter chain is tensor code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vislam_tpu_torch.ops.match_kernel import BIG, match_top2


class Matches(NamedTuple):
    """Fixed-capacity match set from frame A to frame B; idx_b[k] is the
    matched B row of A row k (meaningless where mask[k] is False)."""

    idx_b: torch.Tensor  # (K,) int32
    dist: torch.Tensor   # (K,) float32
    mask: torch.Tensor   # (K,) bool


def match_descriptors(desc_a, mask_a, desc_b, mask_b, ratio: float = 0.8,
                      mutual: bool = True, uv_pred=None, uv_b=None,
                      gate_radius: float = 0.0, uv_a=None, cell_rows: int = 0,
                      cell_cols: int = 0, image_size=None) -> Matches:
    """Match A->B with the ratio test and the mutual check.

    Guided matching: with uv_pred (K,2 predicted position of each A keypoint
    in B), uv_b (N,2) and gate_radius > 0, candidate pairs outside the
    prediction disc are excluded before the ratio test.

    Grid dedup: with cell_rows, cell_cols > 0, uv_a (K, 2) and image_size
    (H, W), only the best (smallest-distance) match of each cell of image
    A's grid stays, the first row on an exact tie (the reference's
    per-cell min, here a scatter_reduce per cell).

    Batched: desc_b (Bt, N, D), mask_b (Bt, N) (gated: uv_b (Bt, N, 2))
    match Bt sets against a shared A in one kernel call
    (`ops/match_kernel.py`); every field of the result gains the leading
    Bt. Under torch.func.vmap, gated or not, the kernel's vmap rule makes
    the mapped match one call with an A per sequence.
    """
    min1, min2, arg1, colarg = match_top2(desc_a, mask_a, desc_b, mask_b,
                                          uv_pred, uv_b, gate_radius)
    K = desc_a.shape[-2]
    ok = mask_a & (min1 < BIG * 0.5)
    ok = ok & (min1 < (ratio * ratio) * torch.clamp(min2, min=1e-12))
    if mutual:
        safe = torch.clamp(arg1, 0, desc_b.shape[-2] - 1).long()
        ok = ok & (torch.gather(colarg, -1, safe)
                   == torch.arange(K, dtype=torch.int32, device=ok.device))
    dist = torch.sqrt(torch.clamp(min1, min=0.0))
    if cell_rows > 0 and cell_cols > 0 and uv_a is not None and image_size is not None:
        ok = _grid_dedup(ok, dist, uv_a, cell_rows, cell_cols, image_size)
    return Matches(idx_b=arg1, dist=dist, mask=ok)


def gather_matched(uv_a, uv_b, matches: Matches):
    """Matched coordinate pairs: uv_a (K,2), the matched rows of uv_b (K,2)
    and the mask."""
    return uv_a, uv_b[matches.idx_b.long()], matches.mask


def _grid_dedup(ok, dist, uv_a, cell_rows: int, cell_cols: int, image_size):
    """ok restricted to the best match (smallest dist, then first row) of
    each cell of A's cell_rows x cell_cols grid."""
    H, W = image_size
    cu = torch.clamp((uv_a[..., 0] / W * cell_cols).to(torch.int64), 0, cell_cols - 1)
    cv = torch.clamp((uv_a[..., 1] / H * cell_rows).to(torch.int64), 0, cell_rows - 1)
    cell = (cv * cell_cols + cu).expand(ok.shape)
    cells = ok.shape[:-1] + (cell_rows * cell_cols,)
    keyed = torch.where(ok, dist, torch.full_like(dist, BIG))
    best = torch.full(cells, BIG, dtype=dist.dtype, device=dist.device).scatter_reduce(
        -1, cell, keyed, "amin")
    is_best = ok & (keyed <= torch.gather(best, -1, cell) + 1e-12)
    none = 2 ** 30
    row = torch.arange(ok.shape[-1], device=ok.device).expand(ok.shape)
    first = torch.full(cells, none, dtype=torch.int64, device=ok.device).scatter_reduce(
        -1, cell, torch.where(is_best, row, torch.full_like(row, none)), "amin")
    return is_best & (row == torch.gather(first, -1, cell))
