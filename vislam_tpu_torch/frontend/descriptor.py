"""SIFT-style descriptors, 4x4 spatial x 8 orientation bins = 128-D (port
of `vislam_tpu/frontend/descriptor.py`, upright and oriented).

One (K, 32, 32) patch per keypoint, blur + Scharr in patch space, bilinear
sampling of a 16x16 grid by one-hot contractions (upright: separable over
the grid's rows and columns; oriented: the grid rotated by the keypoint's
angle, 256 samples, then the gradients rotated into the keypoint frame), a
gather-free orientation soft-assignment and one histogram contraction
against the static spatial-weight matrix; L2-normalise -> clip 0.2 ->
renormalise. All contractions run in float32 (TF32 is off, see the package
docstring).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vislam_tpu_torch.frontend.binary_desc import PATTERN
from vislam_tpu_torch.frontend.pyramid import gaussian_taps

_GRID = 16           # 16x16 gradient samples
_CELLS = 4           # 4x4 spatial cells
_NBINS = 8           # orientation bins
_S = _GRID * _GRID
DESC_DIM = _CELLS * _CELLS * _NBINS  # 128
_PATCH = 32          # patch side for the sampling path
_PATCH_MARGIN = 3    # blur radius (2) + Scharr radius (1)


def _static_geometry(patch_scale: float):
    """Static sample grid: offsets (S,2), spatial-weight matrix (S,16) with
    trilinear cell weights x Gaussian window folded in (numpy, float32)."""
    step = patch_scale * 2.0 * _CELLS / _GRID
    c = (_GRID - 1) / 2.0
    ii, jj = np.meshgrid(np.arange(_GRID), np.arange(_GRID), indexing="ij")
    dy = (ii - c) * step
    dx = (jj - c) * step
    offs = np.stack([dx.reshape(-1), dy.reshape(-1)], -1).astype(np.float32)

    cell_x = ((jj + 0.5) / _GRID * _CELLS - 0.5).reshape(-1)
    cell_y = ((ii + 0.5) / _GRID * _CELLS - 0.5).reshape(-1)
    r2 = (dx ** 2 + dy ** 2).reshape(-1)
    sigma = _GRID * step / 2.0
    gauss = np.exp(-r2 / (2.0 * sigma * sigma)).astype(np.float32)

    W_sp = np.zeros((_S, _CELLS * _CELLS), np.float32)
    x0 = np.floor(cell_x).astype(int)
    y0 = np.floor(cell_y).astype(int)
    fx = cell_x - x0
    fy = cell_y - y0
    for sx, wx in ((x0, 1.0 - fx), (x0 + 1, fx)):
        for sy, wy in ((y0, 1.0 - fy), (y0 + 1, fy)):
            ok = (sx >= 0) & (sx < _CELLS) & (sy >= 0) & (sy < _CELLS)
            idx = np.clip(sy, 0, _CELLS - 1) * _CELLS + np.clip(sx, 0, _CELLS - 1)
            w = np.where(ok, wx * wy, 0.0) * gauss
            np.add.at(W_sp, (np.arange(_S), idx), w)
    return offs, W_sp


_OFFS, _WSP = _static_geometry(patch_scale=1.5)


class DescriptorGeometry:
    """The static sampling geometry as tensors on one device: per-axis grid
    offsets (16,), the (S, 2) offsets of the whole grid (rotated for
    oriented descriptors), the (S, 16) spatial-weight matrix of this descriptor,
    and the (256, 2, 2) BRIEF test pattern (`binary_desc.PATTERN`). Built
    once per engine so the per-frame step uploads nothing."""

    def __init__(self, device):
        self.dx = torch.as_tensor(_OFFS[:_GRID, 0].copy(), device=device)
        self.dy = torch.as_tensor(_OFFS[::_GRID, 1].copy(), device=device)
        self.offs = torch.as_tensor(_OFFS, device=device)
        self.wsp = torch.as_tensor(_WSP, device=device)
        self.brief = torch.as_tensor(PATTERN, device=device)


def extract_patches(img, uv, P: int):
    """(K, P, P) patches whose origin is floor(uv) - P/2 + 1, clipped so
    every patch stays inside the image. Returns (patches, iu0, iv0)."""
    H, W = img.shape
    iu0 = torch.clamp(torch.floor(uv[:, 0]).to(torch.int64) - P // 2 + 1, 0, W - P)
    iv0 = torch.clamp(torch.floor(uv[:, 1]).to(torch.int64) - P // 2 + 1, 0, H - P)
    r = torch.arange(P, device=img.device)
    rows = iv0[:, None, None] + r[None, :, None]
    cols = iu0[:, None, None] + r[None, None, :]
    return img[rows, cols], iu0, iv0


def _shift_conv_patches(pat, k, axis: int):
    """1D correlation along a patch axis by static rolls; rows/cols inside
    the margin are exact (wrap contamination stays in the margin)."""
    r = len(k) // 2
    out = torch.zeros_like(pat)
    for i, kv in enumerate(k):
        s = i - r
        out = out + float(kv) * (pat if s == 0 else torch.roll(pat, -s, dims=axis))
    return out


def _patch_gradients(patches, smooth_sigma: float):
    """Blur(sigma, radius 2) + Scharr gradients in patch space."""
    g = gaussian_taps(smooth_sigma, 2)
    sm = _shift_conv_patches(_shift_conv_patches(patches, g, 1), g, 2)
    sx = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)
    dx = (-1.0, 0.0, 1.0)
    gx = _shift_conv_patches(_shift_conv_patches(sm, sx, 1), dx, 2)
    gy = _shift_conv_patches(_shift_conv_patches(sm, sx, 2), dx, 1)
    return gx, gy


def sample_bilinear_patches(fields, lu, lv, lo: float, hi: float):
    """Bilinear samples of (K, P, P, C) patch fields at local coords lu, lv
    (K, S), clipped to [lo, hi]: per axis a 2-nonzero weight row (K, S, P),
    then two batched contractions (no gather per sample). Returns (K, S, C)."""
    iota = torch.arange(fields.shape[1], dtype=torch.float32, device=fields.device)
    av = torch.clamp(1.0 - torch.abs(torch.clamp(lv, lo, hi)[..., None] - iota), min=0.0)
    au = torch.clamp(1.0 - torch.abs(torch.clamp(lu, lo, hi)[..., None] - iota), min=0.0)
    t1 = torch.einsum("ksp,kpqc->ksqc", av, fields)    # (K, S, P, C)
    return torch.einsum("ksq,ksqc->ksc", au, t1)


def describe_keypoints(img, uv, geom: DescriptorGeometry, angle=None,
                       smooth_sigma: float = 0.6):
    """Descriptors of K keypoints on one level.

    img: (H, W) float32 level; uv: (K, 2) level-local pixel coords; angle:
    (K,) radians, or None for upright descriptors (the axis-aligned grid,
    the default frontend's). Returns (K, 128) float32 L2-normalised
    descriptors.
    """
    P = _PATCH
    K = uv.shape[0]
    patches, iu0, iv0 = extract_patches(img, uv, P)
    gxp, gyp = _patch_gradients(patches, smooth_sigma)
    m = float(_PATCH_MARGIN)
    lo, hi = m, P - 1 - m - 1e-3
    fields = torch.stack([gxp, gyp], dim=-1)  # (K, P, P, 2)

    if angle is None:
        # Axis-aligned grid: the bilinear weights factorize over grid rows
        # and columns, (K, 16, P) each.
        lv = torch.clamp(uv[:, 1:2] + geom.dy[None, :] - iv0[:, None].float(), lo, hi)
        lu = torch.clamp(uv[:, 0:1] + geom.dx[None, :] - iu0[:, None].float(), lo, hi)
        iota = torch.arange(P, dtype=torch.float32, device=uv.device)
        A = torch.clamp(1.0 - torch.abs(lv[..., None] - iota), min=0.0)  # (K,16,P)
        B = torch.clamp(1.0 - torch.abs(lu[..., None] - iota), min=0.0)
        t1 = torch.einsum("kip,kpqc->kiqc", A, fields)     # (K,16,P,2)
        samp = torch.einsum("kjq,kiqc->kijc", B, t1)       # (K,16,16,2)
        gxr = samp[..., 0].reshape(K, _S)
        gyr = samp[..., 1].reshape(K, _S)
    else:
        # The grid rotated by each keypoint's angle (256 samples each), then
        # the sampled gradients rotated into the keypoint frame.
        ca = torch.cos(angle)[:, None]
        sa = torch.sin(angle)[:, None]
        ox, oy = geom.offs[:, 0][None], geom.offs[:, 1][None]
        lu = uv[:, 0:1] + (ca * ox - sa * oy) - iu0[:, None].float()
        lv = uv[:, 1:2] + (sa * ox + ca * oy) - iv0[:, None].float()
        samp = sample_bilinear_patches(fields, lu, lv, lo, hi)   # (K, S, 2)
        gxs, gys = samp[..., 0], samp[..., 1]
        gxr = ca * gxs + sa * gys
        gyr = -sa * gxs + ca * gys
    mag = torch.sqrt(gxr * gxr + gyr * gyr + 1e-12)
    ori = torch.atan2(gyr, gxr)

    # Orientation soft-assignment: circular tent weights over the 8 bins.
    obin = (ori / (2.0 * math.pi) + 0.5) * _NBINS - 0.5
    bins = torch.arange(_NBINS, dtype=torch.float32, device=uv.device)
    d = obin[..., None] - bins  # (K, S, 8)
    d = d - _NBINS * torch.round(d / _NBINS)  # circular wrap to [-4, 4)
    O = torch.clamp(1.0 - torch.abs(d), min=0.0)

    M = mag[..., None] * O  # (K, S, 8)
    desc = torch.einsum("ksb,sc->kcb", M, geom.wsp).reshape(K, DESC_DIM)

    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    return desc
