"""Detector response + 5x5 NMS, all six families: the CUDA kernel's wrapper
and its plain PyTorch twins (port of `vislam_tpu/ops/harris_kernel.py`).

`response_nms(img, detector)` takes (H, W) or (B, H, W) float32 and returns
(nms, resp) of the same shape: resp is the family's response in float32 (as
the reference's TPU kernel computes it, on the level widened to float32),
nms is resp at its 5x5 local maxima and -inf elsewhere. `_gradmag2` (the
contrast-factor statistic of the nonlinear scale space) needs only resp;
its nms is None. A CPU tensor runs the plain twin; a CUDA tensor launches
`csrc/response_nms.cu` or raises, through the custom op
`vislam_torch::response_nms`, whose vmap rule makes a mapped call one
launch. Another NMS radius than 2 is applied to resp (`nms`), on both.

Borders. Where the reference has an XLA response (`DETECTOR_RESPONSES`),
the port pads stage by stage with zeros as XLA's SAME does (shi_tomasi,
harris, dog, hessian), and so agrees with it on the whole field. `fast`
reads zeros outside the image (the TPU kernel's padding; the XLA version
wraps around with `jnp.roll`), and `_gradmag2`, which exists only in the
TPU kernel, zero-pads the image once and computes every stage on the
extended domain, as that kernel does: its outer ring enters the pooled
contrast quantile. The variants differ only within 7 px of the border,
where the detector selects nothing (border 12, NMS radius 2).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from vislam_tpu_torch.frontend.pyramid import gaussian_blur, scharr_gradients
from vislam_tpu_torch.ops import build, fold_mapped

# Family ids, in the order of the CUDA source's `Family` enum.
FAMILIES = ("shi_tomasi", "harris", "dog", "hessian", "fast", "_gradmag2")

# Bresenham circle of radius 3 — the FAST-16 sampling ring, as (dv, du).
_FAST_RING = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32,
)


def _structure_tensor(img, sigma: float):
    gx, gy = scharr_gradients(img)
    return (gaussian_blur(gx * gx, sigma), gaussian_blur(gx * gy, sigma),
            gaussian_blur(gy * gy, sigma))


def harris_response(img, k: float = 0.04, sigma: float = 1.5):
    """Shi-Tomasi min-eigenvalue response (k kept for API parity)."""
    a, b, c = _structure_tensor(img, sigma)
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    return half_tr - torch.sqrt(half_diff * half_diff + b * b + 1e-12)


def harris_cornerness(img, k: float = 0.04, sigma: float = 1.5):
    """Classic Harris det - k tr^2 cornerness."""
    a, b, c = _structure_tensor(img, sigma)
    det = a * c - b * b
    tr = a + c
    return det - k * tr * tr


def dog_response(img, sigma1: float = 1.0, sigma2: float = 1.6):
    """|G(sigma1, r3) - G(sigma2, r4)| difference-of-Gaussians blobs."""
    return torch.abs(gaussian_blur(img, sigma1, radius=3) - gaussian_blur(img, sigma2, radius=4))


def hessian_response(img, sigma: float = 1.5):
    """Determinant of the Hessian of G(sigma, r3) by iterated Scharr."""
    sm = gaussian_blur(img, sigma, radius=3)
    gx, gy = scharr_gradients(sm)
    gxx, gxy = scharr_gradients(gx)
    _, gyy = scharr_gradients(gy)
    return gxx * gyy - gxy * gxy


def _zero_pad(img, p: int):
    return F.pad(img, (p, p, p, p))


def fast_response(img, arc: int = 9):
    """FAST-16 segment-test score over a contiguous `arc`: max over arc
    starts of the min over the arc of (ring - centre) (bright) or
    (centre - ring) (dark); zeros outside the image."""
    H, W = img.shape[-2:]
    p = _zero_pad(img, 3)
    ring = torch.stack([p[..., 3 + dv:3 + dv + H, 3 + du:3 + du + W]
                        for dv, du in _FAST_RING.tolist()])  # (16, ..., H, W)
    bright = ring - img[None]
    dark = -bright

    def arc_score(d):
        m = d
        for s in range(1, arc):
            m = torch.minimum(m, torch.roll(d, -s, dims=0))
        return torch.max(m, dim=0).values

    return torch.maximum(arc_score(bright), arc_score(dark))


def gradmag2_response(img):
    """|Scharr G(1, r3)|^2 with the image zero-padded once by the 4-px
    support and every stage on the extended domain (the TPU kernel's
    `_gradmag2`)."""
    H, W = img.shape[-2:]
    gx, gy = scharr_gradients(gaussian_blur(_zero_pad(img, 4), 1.0, radius=3))
    return (gx * gx + gy * gy)[..., 4:4 + H, 4:4 + W]


DETECTOR_RESPONSES = {
    "shi_tomasi": harris_response,
    "harris": harris_cornerness,
    "dog": dog_response,
    "hessian": hessian_response,
    "fast": fast_response,
}
_PLAIN = {**DETECTOR_RESPONSES, "_gradmag2": gradmag2_response}


def nms(resp, radius: int = 2):
    """resp at its (2r+1)^2 local maxima, -inf elsewhere; pixels outside
    the image do not take part in a window (XLA's -inf padding)."""
    size = 2 * radius + 1
    x = resp.reshape((-1, 1) + resp.shape[-2:])
    pooled = F.max_pool2d(x, size, stride=1, padding=radius).reshape(resp.shape)
    return torch.where(resp >= pooled, resp, torch.full_like(resp, -torch.inf))


def response_nms_plain(img, detector: str = "shi_tomasi", nms_radius: int = 2):
    """The plain version: (..., H, W) float32 -> (nms, resp); nms is None
    for `_gradmag2`."""
    resp = _PLAIN[detector](img)
    return (None if detector == "_gradmag2" else nms(resp, nms_radius)), resp


def _lib():
    fn = build.load("response_nms").response_nms
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# Rows of the kernel's output tile it can be asked for; 0 lets it choose.
TILE_ROWS = (0, 8, 16, 32)


@torch.library.custom_op("vislam_torch::response_nms", mutates_args=(), device_types="cuda")
def _response_op(x: Tensor, detector: str, tile_rows: int) -> tuple[Tensor, Tensor]:
    """(nms, resp) of the (B, H, W) images x from one launch of the kernel,
    counted in `response_nms.launches`; nms is (B, 0, 0) for `_gradmag2`."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("response_nms kernel takes contiguous float32, "
                         f"got {x.dtype} contiguous={x.is_contiguous()}")
    B, H, W = x.shape
    if B * H * W >= 2 ** 31 or B > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's indexing")
    resp = torch.empty_like(x)
    nms_ = x.new_empty((B, 0, 0)) if detector == "_gradmag2" else torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib()(FAMILIES.index(detector), x.data_ptr(),
                     None if detector == "_gradmag2" else nms_.data_ptr(), resp.data_ptr(),
                     B, H, W, tile_rows, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"response_nms ({detector}) launch failed: cudaError {err}")
    response_nms.launches[detector] += 1
    return nms_, resp


@_response_op.register_kernel("cpu")
def _response_op_cpu(x, detector, tile_rows):
    nms_, resp = response_nms_plain(x, detector)
    return (x.new_empty((x.shape[0], 0, 0)) if nms_ is None else nms_), resp


@_response_op.register_fake
def _response_op_fake(x, detector, tile_rows):
    return (x.new_empty((x.shape[0], 0, 0)) if detector == "_gradmag2"
            else torch.empty_like(x)), torch.empty_like(x)


def _response_vmap(info, in_dims, x, detector, tile_rows):
    n = info.batch_size
    out = _response_op(fold_mapped(x, in_dims[0], n), detector, tile_rows)
    return tuple(o.unflatten(0, (n, -1)) for o in out), (0, 0)


torch.library.register_vmap(_response_op, _response_vmap)


def response_nms(img, detector: str = "shi_tomasi", nms_radius: int = 2, *,
                 tile_rows: int = 0):
    """(..., H, W) float32 image(s) -> (nms, resp), same shape (nms None for
    `_gradmag2`).

    The custom op `vislam_torch::response_nms` computes resp and its 5x5
    NMS: for a CPU tensor the plain version, for a CUDA tensor the
    hand-written kernel, one launch per call, counted per family in
    `response_nms.launches`; anything else raises. Its vmap rule folds a
    mapped dimension into the kernel's batch: one launch for the whole map.
    Another `nms_radius` takes the (2r+1)^2 NMS of resp (`nms`), as the
    reference routes it (`vislam_tpu/frontend/detect.py:257-272`).
    `tile_rows` fixes the kernel's tile height to 8, 16 or 32 rows, so that
    a check on the card can reach each (the plain version has no tiles);
    0, the default, lets the kernel choose from the shape.
    """
    if detector not in FAMILIES:
        raise ValueError(f"unknown detector {detector!r}; one of {FAMILIES}")
    if img.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {tuple(img.shape)}")
    if tile_rows not in TILE_ROWS:
        raise ValueError(f"tile_rows must be one of {TILE_ROWS}, got {tile_rows}")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")
    x = img if img.dim() == 3 else img[None]
    nms_, resp = _response_op(x, detector, tile_rows)
    if detector == "_gradmag2":
        nms_ = None
    elif nms_radius != 2:
        nms_ = nms(resp, nms_radius)
    if img.dim() == 2:
        return (None if nms_ is None else nms_[0]), resp[0]
    return nms_, resp


response_nms.launches = dict.fromkeys(FAMILIES, 0)
