"""Descriptor top-2 matching core: the CUDA kernel's wrapper and its plain
PyTorch twin (port of `vislam_tpu/ops/match_kernel.py`).

`match_top2(desc_a, mask_a, desc_b, mask_b[, uv_pred, uv_b, gate_radius])`
returns (min1 (K,), min2 (K,), arg1 (K,) int32, colarg (N,) int32) over the
squared-L2 distance matrix max(|a|^2 + |b|^2 - 2 a.b, 0) of D = 128 (SIFT)
or 256 (BRIEF) wide descriptors, with invalid pairs (and, gated, pairs
outside the guided disc) at 1e9; the first index wins ties, which are
exact and common between BRIEF descriptors.

Batched (the window-track match, `engine/refine.py`): desc_b (Bt, N, D)
and mask_b (Bt, N) hold Bt sets, each matched against the shared desc_a
(K, D) / mask_a (K,); every output gains the leading Bt. Batched calls
are ungated.

A CPU tensor runs the plain twin; a CUDA tensor launches
`csrc/match_top2.cu` (two launches per call, batched or not: a reset of
its scratch, then the tiled tensor-core kernel) or raises.
`match_top2.launches` counts calls: a batched call counts one, and also
one in `match_top2.batched_launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vislam_tpu_torch.ops import build

BIG = 1e9


def match_top2_plain(desc_a, mask_a, desc_b, mask_b, uv_pred=None, uv_b=None,
                     gate_radius: float = 0.0):
    """The plain version (materialises the K x N matrix of each pair)."""
    a = desc_a.float()
    b = desc_b.float()
    sq_a = torch.sum(a * a, dim=-1, keepdim=True)
    sq_b = torch.sum(b * b, dim=-1)[..., None, :]
    d = torch.clamp(sq_a + sq_b - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)
    big = torch.full_like(d, BIG)
    d = torch.where(mask_a[..., :, None] & mask_b[..., None, :], d, big)
    if uv_pred is not None and uv_b is not None and gate_radius > 0.0:
        du = uv_pred[:, None, 0] - uv_b[None, :, 0]
        dv = uv_pred[:, None, 1] - uv_b[None, :, 1]
        d = torch.where(du * du + dv * dv <= gate_radius * gate_radius, d, big)
    arg1 = torch.argmin(d, dim=-1)
    min1 = torch.gather(d, -1, arg1[..., None])[..., 0]
    cols = torch.arange(d.shape[-1], device=d.device)
    min2 = torch.min(torch.where(cols == arg1[..., None], big, d), dim=-1).values
    colarg = torch.argmin(d, dim=-2)
    return min1, min2, arg1.to(torch.int32), colarg.to(torch.int32)


def _lib():
    lib = build.load("match_top2")
    fn = lib.match_top2
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_float, i, p, p, p, p, p,
                       ctypes.c_size_t, i, i, i, i, p]
        fn.restype = i
        lib.match_top2_scratch_bytes.argtypes = [i, i, i]
        lib.match_top2_scratch_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_bytes(K: int, N: int, batch: int) -> int:
    return _lib().match_top2_scratch_bytes(K, N, batch)


def _check(name, t, shape, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"match_top2 kernel: {name} must be contiguous {dtype} "
                         f"{shape} on CUDA, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} contiguous={t.is_contiguous()}")


def match_top2(desc_a, mask_a, desc_b, mask_b, uv_pred=None, uv_b=None,
               gate_radius: float = 0.0):
    """(min1, min2, arg1, colarg); gated when uv_pred, uv_b and
    gate_radius > 0 are all given (as the reference), batched when desc_b
    is (Bt, N, D)."""
    gated = uv_pred is not None and uv_b is not None and gate_radius > 0.0
    if desc_a.device.type == "cpu":
        return match_top2_plain(desc_a, mask_a, desc_b, mask_b, uv_pred, uv_b,
                                gate_radius)
    if desc_a.device.type != "cuda":
        raise ValueError(f"unsupported device {desc_a.device}")
    batched = desc_b.dim() == 3
    Bt = desc_b.shape[0] if batched else 1
    K, D = desc_a.shape
    N = desc_b.shape[-2]
    if D not in (128, 256) or K < 1 or N < 1 or Bt < 1 or desc_b.shape[-1] != D:
        raise ValueError(f"match_top2 kernel takes (K, D) x (N, D) or (Bt, N, D) with "
                         f"D in (128, 256) and K, N, Bt >= 1, got "
                         f"{tuple(desc_a.shape)} x {tuple(desc_b.shape)}")
    if gated and batched:
        raise ValueError("match_top2 kernel: the gated match is not batched")
    lead_b = (Bt,) if batched else ()
    _check("desc_a", desc_a, (K, D), torch.float32)
    _check("desc_b", desc_b, lead_b + (N, D), torch.float32)
    _check("mask_a", mask_a, (K,), torch.bool)
    _check("mask_b", mask_b, lead_b + (N,), torch.bool)
    if gated:
        _check("uv_pred", uv_pred, (K, 2), torch.float32)
        _check("uv_b", uv_b, (N, 2), torch.float32)
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("match_top2 kernel: desc_a and desc_b must start on 16 bytes "
                         "(the kernel stages them with 16-byte async copies)")
    dev = desc_a.device
    min1 = torch.empty(lead_b + (K,), dtype=torch.float32, device=dev)
    min2 = torch.empty(lead_b + (K,), dtype=torch.float32, device=dev)
    arg1 = torch.empty(lead_b + (K,), dtype=torch.int32, device=dev)
    colarg = torch.empty(lead_b + (N,), dtype=torch.int32, device=dev)
    nbytes = _scratch_bytes(K, N, Bt)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = _lib().match_top2(
            desc_a.data_ptr(), desc_b.data_ptr(), mask_a.data_ptr(), mask_b.data_ptr(),
            uv_pred.data_ptr() if gated else None, uv_b.data_ptr() if gated else None,
            float(gate_radius) ** 2 if gated else 0.0, int(gated), min1.data_ptr(),
            min2.data_ptr(), arg1.data_ptr(), colarg.data_ptr(), scratch.data_ptr(), nbytes,
            K, N, D, Bt, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"match_top2 launch failed: cudaError {err}")
    match_top2.launches += 1
    match_top2.batched_launches += batched
    return min1, min2, arg1, colarg


match_top2.launches = 0
match_top2.batched_launches = 0
