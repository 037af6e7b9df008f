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
`csrc/fed_evolve.cu` along `fed_schedule` (several steps fused per launch)
or raises, through the custom op `vislam_torch::fed_evolve`, whose vmap
rule makes a mapped call one call of the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from vislam_tpu_torch.frontend.pyramid import gaussian_blur, scharr_gradients
from vislam_tpu_torch.ops import build, fold_mapped


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


HALO_PER_STEP = 4      # px one step reads around what it writes: blur 2 + Scharr 1 + flux 1
STEPS_PER_LAUNCH = 3   # steps fused per launch at most, the kernel's limit (chosen on the card: PERF.md)
TILE = (32, 32)        # the kernel's output tile, rows x columns


class FedLaunch(NamedTuple):
    """One launch of a FED cycle: steps [first, first + steps), read from the
    image extended by `src_ext` px on each side (0: the image itself, reads
    clamped into it) and written to the image extended by `dst_ext`; each
    output tile is staged with `halo` px around it."""
    first: int
    steps: int
    halo: int
    src_ext: int
    dst_ext: int


def fed_schedule(n: int, s: int = STEPS_PER_LAUNCH) -> list:
    """The launches of an n-step cycle with at most s steps each: ceil(n / s)
    launches, their step counts as equal as possible (larger first). A
    launch that leaves m steps to run writes the image extended by
    HALO_PER_STEP * m, which is all the later launches read."""
    if n < 1 or s < 1:
        raise ValueError(f"fed_schedule needs n >= 1 and s >= 1, got {n}, {s}")
    count = -(-n // s)
    out, first, src_ext = [], 0, 0
    for j in range(count):
        steps = n // count + (j < n % count)
        dst_ext = HALO_PER_STEP * (n - first - steps)
        out.append(FedLaunch(first, steps, HALO_PER_STEP * steps, src_ext, dst_ext))
        first, src_ext = first + steps, dst_ext
    return out


def _lib():
    fn = build.load("fed_evolve").fed_steps
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, i, i, i, i, p, i, i, i, i, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("vislam_torch::fed_evolve", mutates_args=(), device_types="cuda")
def _fed_op(x: Tensor, k: Tensor, taus: list[float]) -> Tensor:
    """The kernel along fed_schedule(len(taus)) on (B, H, W) float32 fields
    x with k (B,); returns the evolved fields. The call counts once in
    `fed_evolve.launches`."""
    B, H, W = x.shape
    n = len(taus)
    if x.dtype != torch.float32 or k.dtype != torch.float32 or not x.is_contiguous() \
            or not k.is_contiguous():
        raise ValueError("fed_evolve kernel takes contiguous float32 fields and "
                         f"float32 k, got {x.dtype}, {k.dtype}, "
                         f"contiguous={x.is_contiguous()}")
    if n < 1 or B > 65535 or B * (H + 8 * n) * (W + 8 * n) >= 2 ** 31:
        raise ValueError(f"fed_evolve kernel: {n} steps on {tuple(x.shape)} out of range")
    sched = fed_schedule(n)
    e0 = sched[0].dst_ext
    bufs = [torch.empty(B * (H + 2 * e0) * (W + 2 * e0), dtype=torch.float32, device=x.device)
            for _ in range(min(len(sched) - 1, 2))]
    out = torch.empty_like(x)
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    with torch.cuda.device(x.device):
        for j, ln in enumerate(sched):
            dst = out if j == len(sched) - 1 else bufs[j % 2]
            t = (ctypes.c_float * ln.steps)(*taus[ln.first:ln.first + ln.steps])
            se, de = ln.src_ext, ln.dst_ext
            err = fn(src.data_ptr(), -se, -se, H + 2 * se, W + 2 * se,
                     dst.data_ptr(), -de, -de, H + 2 * de, W + 2 * de,
                     k.data_ptr(), t, ln.steps, B, stream)
            if err != 0:
                raise RuntimeError(f"fed_evolve launch {j} ({ln}) failed: cudaError {err}")
            src = dst
    fed_evolve.launches += 1
    return out


@_fed_op.register_kernel("cpu")
def _fed_op_cpu(x, k, taus):
    return fed_evolve_plain(x, k, taus)


@_fed_op.register_fake
def _fed_op_fake(x, k, taus):
    return torch.empty_like(x)


def _fed_vmap(info, in_dims, x, k, taus):
    n = info.batch_size
    out = _fed_op(fold_mapped(x, in_dims[0], n), fold_mapped(k, in_dims[1], n), taus)
    return out.unflatten(0, (n, -1)), 0


torch.library.register_vmap(_fed_op, _fed_vmap)


def fed_evolve(L, k, taus):
    """Evolve L (H, W) or (B, H, W) float32 through the FED steps `taus`
    (static floats) with contrast k ((), or (B,) float32 on L's device).

    The custom op `vislam_torch::fed_evolve`: for a CPU tensor the plain
    version; for a CUDA tensor the kernel, launched
    len(fed_schedule(len(taus))) times (the call counted once in
    `fed_evolve.launches`), ping-ponging two scratch buffers; anything else
    raises. Its vmap rule folds a mapped dimension into the kernel's batch
    (k per field): one call for the whole map.
    """
    taus = [float(t) for t in taus]
    if L.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {tuple(L.shape)}")
    if L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {L.device}")
    x = L if L.dim() == 3 else L[None]
    kb = k.reshape(-1)
    if kb.shape != (x.shape[0],) or kb.device != L.device:
        raise ValueError(f"k must hold one value per field on {L.device}, got "
                         f"{tuple(k.shape)} on {k.device}")
    out = _fed_op(x, kb.contiguous(), taus)
    return out if L.dim() == 3 else out[0]


fed_evolve.launches = 0
