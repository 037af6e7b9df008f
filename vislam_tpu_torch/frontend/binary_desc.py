"""Steered BRIEF-256 binary descriptors (port of
`vislam_tpu/frontend/binary_desc.py`).

Each of the 256 tests compares two bilinear samples of the smoothed level
at static offsets (a pattern drawn from a seeded generator, rotated per
keypoint by its angle). A descriptor is emitted as a +-1/16 float32 unit
vector, so for two descriptors with bit vectors x, y

    ||a - b||^2 = 2 - 2 a.b = 4 * Hamming(x, y) / 256

and the squared-L2 matcher (`ops/match_kernel.py`) orders by Hamming
distance. Every entry and every partial dot product is a multiple of 1/256,
so those distances are exact in float32 and equal ones tie exactly.
Plain PyTorch: the reference computes this outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vislam_tpu_torch.frontend.pyramid import gaussian_blur

BINARY_DIM = 256
_PATCH = 31  # ORB patch diameter; offsets stay inside +-15 px


def _static_pattern(dim: int = BINARY_DIM, patch: int = _PATCH):
    """(dim, 2, 2) float32 test-pair offsets [(duA, dvA), (duB, dvB)]:
    Gaussian (sigma = patch / 5) clipped to the patch, from the reference's
    fixed seed, so the pattern is bit-identical to the reference's."""
    rng = np.random.RandomState(1234)
    sigma = patch / 5.0
    half = (patch - 1) / 2.0
    pts = np.clip(rng.randn(dim, 2, 2) * sigma, -half, half)
    return pts.astype(np.float32)


PATTERN = _static_pattern()


def _bilinear(img, u, v):
    """Bilinear samples of (H, W) img at float (u, v) of any shape; the
    base pixel is clamped into the image, the weights are not (as the
    reference)."""
    H, W = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = torch.clamp(u0.to(torch.int64), 0, W - 2)
    v0i = torch.clamp(v0.to(torch.int64), 0, H - 2)
    flat = img.reshape(-1)

    def take(vi, ui):
        return flat[vi * W + ui]

    return (take(v0i, u0i) * (1 - du) * (1 - dv)
            + take(v0i, u0i + 1) * du * (1 - dv)
            + take(v0i + 1, u0i) * (1 - du) * dv
            + take(v0i + 1, u0i + 1) * du * dv)


def describe_binary(img, uv, angle, pattern, smooth_sigma: float = 2.0):
    """Steered BRIEF-256 of K keypoints on one level.

    img: (H, W) float32 level; uv: (K, 2) level-local pixel coords; angle:
    (K,); pattern: `PATTERN` as a tensor on img's device (built once, see
    `DescriptorGeometry`). Returns (K, 256) float32 in {-1, +1} / 16.
    """
    img_s = gaussian_blur(img, smooth_sigma, radius=3)
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]

    def sample(which):
        du = pattern[None, :, which, 0]
        dv = pattern[None, :, which, 1]
        ru = ca * du - sa * dv
        rv = sa * du + ca * dv
        return _bilinear(img_s, uv[:, 0:1] + ru, uv[:, 1:2] + rv)

    bits = sample(0) > sample(1)
    scale = 1.0 / float(np.sqrt(BINARY_DIM))
    return torch.where(bits, scale, -scale).to(torch.float32)


def hamming_from_l2sq(l2sq, dim: int = BINARY_DIM):
    """Exact Hamming distance from the matcher's squared-L2 output."""
    return torch.round(l2sq * dim / 4.0).to(torch.int32)
