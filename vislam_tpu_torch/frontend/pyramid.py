"""Image pyramid and gradient ops (port of `vislam_tpu/frontend/pyramid.py`).

`gaussian_blur` and `scharr_gradients` take (..., H, W) images and apply
XLA's SAME zero padding stage by stage, as the reference's convolutions
do. Their constant taps live on the image's device, built once per
(device, dtype) and reused, so a step on the card uploads nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SCHARR_X = np.array([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                     np.float32) / 32.0

_consts: dict = {}


def gaussian_taps(sigma: float, radius: int) -> np.ndarray:
    """Normalised 1-D Gaussian taps in float32, computed exactly as the
    reference computes them (so every tap is bit-identical)."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k


def _const(key, make, device, dtype):
    """A constant tensor cached per (key, device, dtype)."""
    full = (key, str(device), dtype)
    t = _consts.get(full)
    if t is None:
        t = torch.as_tensor(make()).to(device=device, dtype=dtype)
        _consts[full] = t
    return t


def _planes(img):
    """(..., H, W) -> (N, 1, H, W) and the function that restores the shape."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    return x, lambda y: y.reshape(lead + y.shape[-2:])


def gaussian_blur(img, sigma: float = 1.5, radius: int = 3):
    """Separable Gaussian blur: along x, then along y, each SAME-padded.

    In the image's dtype: for bfloat16 the taps are rounded to bfloat16 and
    each pass is accumulated in float32 and rounded back once, as XLA
    treats a bfloat16 convolution.
    """
    x, back = _planes(img)
    k = _const(("gauss", sigma, radius), lambda: gaussian_taps(sigma, radius),
               img.device, img.dtype).float()
    n = 2 * radius + 1
    out = F.conv2d(x.float(), k.reshape(1, 1, 1, n), padding=(0, radius)).to(img.dtype)
    out = F.conv2d(out.float(), k.reshape(1, 1, n, 1), padding=(radius, 0)).to(img.dtype)
    return back(out)


def scharr_gradients(img):
    """(gx, gy) Scharr derivatives, unit gain, SAME-padded 3x3 correlations."""
    x, back = _planes(img)
    kx = _const("scharr_x", lambda: _SCHARR_X, img.device, img.dtype).float()
    ky = _const("scharr_y", lambda: _SCHARR_X.T.copy(), img.device, img.dtype).float()
    xf = x.float()
    gx = F.conv2d(xf, kx[None, None], padding=1).to(img.dtype)
    gy = F.conv2d(xf, ky[None, None], padding=1).to(img.dtype)
    return back(gx), back(gy)


def downsample2(img):
    """Crop to even size, then 2x2 mean (taken in float32, rounded back to
    the input dtype once: for bfloat16 this is bit-identical to the
    reference's jnp.mean)."""
    h, w = img.shape
    cur = img[: h - h % 2, : w - w % 2]
    return cur.reshape(h // 2, 2, w // 2, 2).float().mean(dim=(1, 3)).to(img.dtype)


def build_pyramid(image, num_levels: int):
    """List of `num_levels` images, each a 2x2-mean downsample of the last,
    in the input dtype (bf16 by default, `FrontendConfig.image_dtype`)."""
    levels = [image]
    for _ in range(num_levels - 1):
        levels.append(downsample2(levels[-1]))
    return levels
