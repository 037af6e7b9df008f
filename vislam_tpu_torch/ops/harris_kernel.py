"""Shi-Tomasi response + 5x5 NMS: the CUDA kernel's wrapper and its plain
PyTorch twin (port of `vislam_tpu/ops/harris_kernel.py`, shi_tomasi only).

`shi_tomasi_nms(img)` takes (H, W) or (B, H, W) float32 and returns
(nms, resp) of the same shape: resp is the min-eigenvalue response computed
in float32 (as the reference's TPU kernel does, on the bf16-rounded level),
nms is resp at its 5x5 local maxima and -inf elsewhere. A CPU tensor runs
the plain twin; a CUDA tensor launches `csrc/shi_tomasi_nms.cu` or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from vislam_tpu_torch.ops import build

_SCHARR_X = np.array([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                     np.float32) / 32.0


def _gauss_taps(radius: int = 3, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def shi_tomasi_nms_plain(img, nms_radius: int = 2):
    """The plain version: (B, H, W) float32 -> (nms, resp). Zero padding
    per stencil and -inf padding for the NMS window (XLA's SAME)."""
    x = img[:, None]
    kx = torch.as_tensor(_SCHARR_X, device=img.device)
    gx = F.conv2d(x, kx[None, None], padding=1)
    gy = F.conv2d(x, kx.T.contiguous()[None, None], padding=1)
    g = torch.as_tensor(_gauss_taps(), device=img.device)

    def blur(f):
        f = F.conv2d(f, g.reshape(1, 1, 7, 1), padding=(3, 0))
        return F.conv2d(f, g.reshape(1, 1, 1, 7), padding=(0, 3))

    a, b, c = blur(gx * gx), blur(gx * gy), blur(gy * gy)
    half_tr = 0.5 * (a + c)
    half_df = 0.5 * (a - c)
    resp = half_tr - torch.sqrt(half_df * half_df + b * b + 1e-12)
    size = 2 * nms_radius + 1
    pooled = F.max_pool2d(resp, size, stride=1, padding=nms_radius)
    nms = torch.where(resp >= pooled, resp, torch.full_like(resp, -torch.inf))
    return nms[:, 0], resp[:, 0]


def _lib():
    lib = build.load("shi_tomasi_nms")
    fn = lib.shi_tomasi_nms
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def shi_tomasi_nms(img, nms_radius: int = 2):
    """(..., H, W) float32 image(s) -> (nms, resp), same shape.

    CPU tensor: the plain version. CUDA tensor: the hand-written kernel
    (5x5 NMS only), one launch per call; anything else raises.
    """
    if img.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {tuple(img.shape)}")
    x = img if img.dim() == 3 else img[None]
    if img.device.type == "cpu":
        nms, resp = shi_tomasi_nms_plain(x, nms_radius)
    elif img.device.type == "cuda":
        if nms_radius != 2:
            raise NotImplementedError("the CUDA kernel implements 5x5 NMS "
                                      "(nms_radius=2) only")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("shi_tomasi_nms kernel takes contiguous float32, "
                             f"got {x.dtype} contiguous={x.is_contiguous()}")
        B, H, W = x.shape
        if B * H * W >= 2 ** 31 or B > 65535:
            raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's indexing")
        nms = torch.empty_like(x)
        resp = torch.empty_like(x)
        fn = _lib()
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), nms.data_ptr(), resp.data_ptr(), B, H, W,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"shi_tomasi_nms launch failed: cudaError {err}")
        shi_tomasi_nms.launches += 1
    else:
        raise ValueError(f"unsupported device {img.device}")
    if img.dim() == 2:
        return nms[0], resp[0]
    return nms, resp


shi_tomasi_nms.launches = 0
