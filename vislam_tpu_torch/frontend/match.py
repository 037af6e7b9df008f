"""Descriptor matching: top-2 core + Lowe ratio + mutual check (port of
`vislam_tpu/frontend/match.py::match_descriptors`, without the grid dedup,
which the engine does not use).

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
                      gate_radius: float = 0.0) -> Matches:
    """Match A->B with the ratio test and the mutual check.

    Guided matching: with uv_pred (K,2 predicted position of each A keypoint
    in B), uv_b (N,2) and gate_radius > 0, candidate pairs outside the
    prediction disc are excluded before the ratio test.

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
    return Matches(idx_b=arg1, dist=dist, mask=ok)
