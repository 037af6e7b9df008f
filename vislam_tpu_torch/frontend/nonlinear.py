"""Nonlinear-diffusion scale space, the KAZE/AKAZE family's core (port of
`vislam_tpu/frontend/nonlinear.py`).

The image is evolved by Perona-Malik diffusion in FED cycles (a static
sequence of explicit steps, `ops/fed_kernel.py`, which also holds the
plain step's `pm_g2` and `diffusion_step`) and 2x2-mean downsampled
per octave, so the levels are drop-ins for the Gaussian pyramid.

The reference has two branches for the contrast factor k and two border
treatments for the evolution; the port implements the TPU ones on every
device: k from the `_gradmag2` response kernel, 4x4-mean pooled, at the
70th percentile (the CPU branch takes the full-field percentile of |grad|,
2.7% apart on a 480x752 frame), and the FED cycle of the TPU kernel (edge
extension once, then an unbounded domain). As on the TPU, the presmooth
blur runs in the image's dtype and everything from the evolution on is
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vislam_tpu_torch.frontend.pyramid import downsample2, gaussian_blur
from vislam_tpu_torch.ops.fed_kernel import fed_evolve, pm_g2  # noqa: F401  (the reference's name)
from vislam_tpu_torch.ops.harris_kernel import response_nms


def _quantile(x, q: float):
    """jnp.quantile's default (linear interpolation between the two
    nearest ranks) of a flat tensor; the ranks are static, so nothing
    waits on the device."""
    n = x.numel()
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    w = pos - lo
    s = torch.sort(x.reshape(-1)).values
    return s[lo] * (1.0 - w) + s[hi] * w


def contrast_factor(image, percentile: float = 70.0):
    """KAZE's contrast parameter k (a () float32 tensor): the percentile of
    |Scharr G(1) image| over the 4x4-mean-pooled squared field (the
    reference's TPU branch), at least 1e-3."""
    _, mag2 = response_nms(image.float().contiguous(), "_gradmag2")
    h, w = mag2.shape
    pooled = mag2[: h - h % 4, : w - w % 4].reshape(h // 4, 4, w // 4, 4).mean(dim=(1, 3))
    k = torch.sqrt(torch.clamp(_quantile(pooled, percentile / 100.0), min=0.0))
    return torch.clamp(k, min=1e-3)


def fed_tau_steps(T: float, tau_max: float = 0.25):
    """FED cycle step sizes reaching total diffusion time T (python floats;
    the same values as the reference's)."""
    n = int(np.ceil(np.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)) + 1
    c = 1.0 / (4.0 * n + 2.0)
    taus = [tau_max / (2.0 * np.cos(np.pi * (2 * j + 1) * c) ** 2) for j in range(n)]
    scale = T / sum(taus)
    return [float(t * scale) for t in taus]


def evolve(L, k, T: float, tau_max: float = 0.25):
    """FED-evolve L by diffusion time T with contrast k: float32 out."""
    return fed_evolve(L.float().contiguous(), k, fed_tau_steps(T, tau_max))


def nonlinear_scale_space(image, num_levels: int, sigma0: float = 1.6,
                          contrast_pct: float = 70.0):
    """AKAZE-style octave scale space, `num_levels` levels of the shapes
    `build_pyramid` gives. Level i approximates scale sigma0 * 2^i: the
    first evolves the presmoothed image (sigma 1) to sigma0, each next one
    evolves the last by 0.5 * 3 * sigma0^2 at its resolution, downsamples,
    and shrinks k by 0.75."""
    presmooth = 1.0   # the _gradmag2 kernel's sigma: k's statistic assumes it
    k = contrast_factor(image, contrast_pct)
    L = evolve(gaussian_blur(image, presmooth), k, 0.5 * max(sigma0 ** 2 - presmooth ** 2, 0.1))
    levels = [L]
    dT = 0.5 * 3.0 * sigma0 ** 2
    for _ in range(num_levels - 1):
        L = downsample2(evolve(L, k, dT))
        k = k * 0.75
        levels.append(L)
    return levels
