"""One FED cycle of Perona-Malik diffusion: the CUDA kernel's wrapper and its
plain PyTorch twin (port of `vislam_tpu/ops/fed_kernel.py`).

`fed_evolve(L, k, taus)` takes (H, W) or (B, H, W) float32 fields, k (B,)
float32 contrast parameters (or one 0-d tensor for an (H, W) field) and the
static FED step sizes, and returns the evolved float32 fields. Borders
follow the TPU kernel: the image is extended by its edge values once and
then evolved on an unbounded domain (see `csrc/fed_evolve.cu`). The
reference's XLA `evolve` instead pads every step (zeros for the blur and
the gradients, edge values for the flux) and agrees with this only about
4n px in from the border.

A CPU tensor runs the plain twin; a CUDA tensor launches
`csrc/fed_evolve.cu` once per step or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vislam_tpu_torch.frontend.pyramid import gaussian_blur, scharr_gradients
from vislam_tpu_torch.ops import build


def pm_g2(gx, gy, k):
    """Perona-Malik g2 conductivity: 1 / (1 + |grad L|^2 / k^2)."""
    return 1.0 / (1.0 + (gx * gx + gy * gy) / (k * k))


def diffusion_step(L, g, tau: float):
    """One explicit step of dL/dt = div(g grad L) on (..., H, W), zero-flux
    boundaries: neighbours by edge padding, half-point conductivities by
    neighbour averaging."""
    H, W = L.shape[-2:]
    Lp = F.pad(L.reshape((-1, 1, H, W)), (1, 1, 1, 1), mode="replicate").reshape(
        L.shape[:-2] + (H + 2, W + 2))
    gp = F.pad(g.reshape((-1, 1, H, W)), (1, 1, 1, 1), mode="replicate").reshape(
        g.shape[:-2] + (H + 2, W + 2))
    flux = torch.zeros_like(L)
    for dv, du in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        Ln = Lp[..., 1 + dv:1 + dv + H, 1 + du:1 + du + W]
        gn = gp[..., 1 + dv:1 + dv + H, 1 + du:1 + du + W]
        flux = flux + 0.5 * (g + gn) * (Ln - L)
    return L + tau * flux


def fed_evolve_plain(L, k, taus):
    """The plain version on (B, H, W) float32 and k (B,): extend by the edge
    values by 4n, run the n steps (each stage SAME-padded; what the padding
    touches never reaches the crop), crop."""
    h = 4 * len(taus)
    B, H, W = L.shape
    x = F.pad(L[:, None], (h, h, h, h), mode="replicate")[:, 0]
    kb = k.reshape(B, 1, 1)
    for tau in taus:
        gx, gy = scharr_gradients(gaussian_blur(x, 1.0, radius=2))
        x = diffusion_step(x, pm_g2(gx, gy, kb), tau)
    return x[:, h:h + H, h:h + W]


def _lib():
    fn = build.load("fed_evolve").fed_step
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, i, i, i, i, p, i, i, i, i, p, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def fed_evolve(L, k, taus):
    """Evolve L (H, W) or (B, H, W) float32 through the FED steps `taus`
    (static floats) with contrast k ((), or (B,) float32 on L's device).

    CPU tensor: the plain version. CUDA tensor: one kernel launch per step
    (counted in `fed_evolve.launches` per call), ping-ponging two scratch
    buffers; anything else raises.
    """
    taus = tuple(float(t) for t in taus)
    if L.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {tuple(L.shape)}")
    x = L if L.dim() == 3 else L[None]
    B, H, W = x.shape
    kb = k.reshape(-1)
    if kb.shape != (B,) or kb.device != L.device:
        raise ValueError(f"k must hold one value per field on {L.device}, got "
                         f"{tuple(k.shape)} on {k.device}")
    if L.device.type == "cpu":
        out = fed_evolve_plain(x, kb, taus)
    elif L.device.type == "cuda":
        if x.dtype != torch.float32 or kb.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("fed_evolve kernel takes contiguous float32 fields and "
                             f"float32 k, got {x.dtype}, {kb.dtype}, "
                             f"contiguous={x.is_contiguous()}")
        n = len(taus)
        if n < 1 or B > 65535 or B * (H + 8 * n) * (W + 8 * n) >= 2 ** 31:
            raise ValueError(f"fed_evolve kernel: {n} steps on {tuple(x.shape)} "
                             "out of range")
        kb = kb.contiguous()
        e0 = 4 * (n - 1)
        cap = B * (H + 2 * e0) * (W + 2 * e0)
        bufs = [torch.empty(cap, dtype=torch.float32, device=x.device) for _ in range(min(n - 1, 2))]
        out = torch.empty_like(x)
        fn = _lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        src, s_ext = x, 0
        with torch.cuda.device(x.device):
            for s, tau in enumerate(taus, start=1):
                d_ext = 4 * (n - s)
                dst = out if s == n else bufs[(s - 1) % 2]
                err = fn(src.data_ptr(), -s_ext, -s_ext, H + 2 * s_ext, W + 2 * s_ext,
                         dst.data_ptr(), -d_ext, -d_ext, H + 2 * d_ext, W + 2 * d_ext,
                         kb.data_ptr(), tau, B, stream)
                if err != 0:
                    raise RuntimeError(f"fed_evolve step {s} launch failed: cudaError {err}")
                src, s_ext = dst, d_ext
        fed_evolve.launches += 1
    else:
        raise ValueError(f"unsupported device {L.device}")
    return out if L.dim() == 3 else out[0]


fed_evolve.launches = 0
