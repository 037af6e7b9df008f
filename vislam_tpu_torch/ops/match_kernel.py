"""Descriptor top-2 matching core: the CUDA kernel's wrapper and its plain
PyTorch twin (port of `vislam_tpu/ops/match_kernel.py`).

`match_top2(desc_a, mask_a, desc_b, mask_b[, uv_pred, uv_b, gate_radius])`
returns (min1 (K,), min2 (K,), arg1 (K,) int32, colarg (N,) int32) over the
squared-L2 distance matrix max(|a|^2 + |b|^2 - 2 a.b, 0) of D = 128 (SIFT)
or 256 (BRIEF) wide descriptors, with invalid pairs (and, gated, pairs
outside the guided disc) at 1e9; the first index wins ties, which are
exact and common between BRIEF descriptors.

Batched: desc_b (Bt, N, D), mask_b (Bt, N) and (gated) uv_b (Bt, N, 2)
hold Bt sets B, and every output gains the leading Bt. desc_a (K, D) with
mask_a (K,) and uv_pred (K, 2) is one A shared by all of them (the
window-track match of `engine/refine.py`); desc_a (G, K, D) with mask_a
(G, K) and uv_pred (G, K, 2) gives G groups, entry z matched against A
group z // a_group where a_group = Bt / G: a_group = 1 pairs every B with
its own A. Gated calls batch as ungated ones do.

The kernel's entry point is the custom op `vislam_torch::match_top2`, in
that canonical form (A (G, K, D), B (Bt, N, D), a_group) with a vmap rule:
under `torch.func.vmap` the mapped dimension folds into the kernel's own
batch (A per sequence: a_group kept; A unmapped with one group: a_group =
the whole folded batch), one call for the whole map. A CPU tensor runs the
plain twin; a CUDA tensor launches `csrc/match_top2.cu` (two launches per
call, in every mode: a reset of its scratch, then the tiled tensor-core
kernel) or raises. `match_top2.launches` counts the kernel's calls (a
folded call once); `match_top2.batched_launches` those in which one A
serves several B sets (a_group > 1, the window-track match);
`match_top2.gated_launches` the gated ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import Tensor

from vislam_tpu_torch.ops import build, fold_mapped

BIG = 1e9


def match_top2_plain(desc_a, mask_a, desc_b, mask_b, uv_pred=None, uv_b=None,
                     gate_radius: float = 0.0):
    """The plain version (materialises the K x N matrix of each pair), on
    the shapes `match_top2` takes: a grouped A is repeated to one A per
    pair, then every pair is computed as a single pair is."""
    a = desc_a.float()
    if a.dim() == 3:
        a_group = desc_b.shape[0] // a.shape[0]
        a = a.repeat_interleave(a_group, 0)
        mask_a = mask_a.repeat_interleave(a_group, 0)
        if uv_pred is not None:
            uv_pred = uv_pred.repeat_interleave(a_group, 0)
    b = desc_b.float()
    sq_a = torch.sum(a * a, dim=-1, keepdim=True)
    sq_b = torch.sum(b * b, dim=-1)[..., None, :]
    d = torch.clamp(sq_a + sq_b - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)
    big = torch.full_like(d, BIG)
    d = torch.where(mask_a[..., :, None] & mask_b[..., None, :], d, big)
    if uv_pred is not None and uv_b is not None and gate_radius > 0.0:
        du = uv_pred[..., :, None, 0] - uv_b[..., None, :, 0]
        dv = uv_pred[..., :, None, 1] - uv_b[..., None, :, 1]
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
                       ctypes.c_size_t, i, i, i, i, i, p]
        fn.restype = i
        lib.match_top2_scratch_bytes.argtypes = [i, i, i]
        lib.match_top2_scratch_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_bytes(K: int, N: int, batch: int) -> int:
    return _lib().match_top2_scratch_bytes(K, N, batch)


def _check(name, t, shape, dtype):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"match_top2 kernel: {name} must be contiguous {dtype} "
                         f"{shape} on CUDA, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


@torch.library.custom_op("vislam_torch::match_top2", mutates_args=(), device_types="cuda")
def _match_op(desc_a: Tensor, mask_a: Tensor, desc_b: Tensor, mask_b: Tensor,
              uv_pred: Optional[Tensor], uv_b: Optional[Tensor], gate_radius: float,
              a_group: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The kernel on A (G, K, D), B (Bt, N, D) with Bt = G * a_group; gated
    when uv_pred is given."""
    gated = uv_pred is not None
    G, K, D = desc_a.shape
    Bt, N = desc_b.shape[:2]
    if D not in (128, 256) or min(G, K, N, a_group) < 1 or Bt != G * a_group:
        raise ValueError(f"match_top2 kernel takes A (G, K, D) and B (G * a_group, N, D) "
                         f"with D in (128, 256), got {tuple(desc_a.shape)}, "
                         f"{tuple(desc_b.shape)}, a_group {a_group}")
    _check("desc_a", desc_a, (G, K, D), torch.float32)
    _check("desc_b", desc_b, (Bt, N, D), torch.float32)
    _check("mask_a", mask_a, (G, K), torch.bool)
    _check("mask_b", mask_b, (Bt, N), torch.bool)
    if gated:
        _check("uv_pred", uv_pred, (G, K, 2), torch.float32)
        _check("uv_b", uv_b, (Bt, N, 2), torch.float32)
    if desc_a.data_ptr() % 16 or desc_b.data_ptr() % 16:
        raise ValueError("match_top2 kernel: desc_a and desc_b must start on 16 bytes "
                         "(the kernel stages them with 16-byte async copies)")
    dev = desc_a.device
    min1 = torch.empty((Bt, K), dtype=torch.float32, device=dev)
    min2 = torch.empty((Bt, K), dtype=torch.float32, device=dev)
    arg1 = torch.empty((Bt, K), dtype=torch.int32, device=dev)
    colarg = torch.empty((Bt, N), dtype=torch.int32, device=dev)
    nbytes = _scratch_bytes(K, N, Bt)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = _lib().match_top2(
            desc_a.data_ptr(), desc_b.data_ptr(), mask_a.data_ptr(), mask_b.data_ptr(),
            uv_pred.data_ptr() if gated else None, uv_b.data_ptr() if gated else None,
            float(gate_radius) ** 2 if gated else 0.0, int(gated), min1.data_ptr(),
            min2.data_ptr(), arg1.data_ptr(), colarg.data_ptr(), scratch.data_ptr(), nbytes,
            K, N, D, Bt, a_group, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"match_top2 launch failed: cudaError {err}")
    match_top2.launches += 1
    match_top2.batched_launches += a_group > 1
    match_top2.gated_launches += gated
    return min1, min2, arg1, colarg


@_match_op.register_kernel("cpu")
def _match_op_cpu(desc_a, mask_a, desc_b, mask_b, uv_pred, uv_b, gate_radius, a_group):
    return match_top2_plain(desc_a, mask_a, desc_b, mask_b, uv_pred, uv_b, gate_radius)


@_match_op.register_fake
def _match_op_fake(desc_a, mask_a, desc_b, mask_b, uv_pred, uv_b, gate_radius, a_group):
    Bt, N = desc_b.shape[:2]
    K = desc_a.shape[1]
    f32 = dict(dtype=torch.float32, device=desc_b.device)
    return (desc_b.new_empty((Bt, K), **f32), desc_b.new_empty((Bt, K), **f32),
            desc_b.new_empty((Bt, K), dtype=torch.int32),
            desc_b.new_empty((Bt, N), dtype=torch.int32))


def _match_vmap(info, in_dims, desc_a, mask_a, desc_b, mask_b, uv_pred, uv_b, gate_radius,
                a_group):
    n = info.batch_size
    dims_a, dims_b = in_dims[0:2] + in_dims[4:5], in_dims[2:4] + in_dims[5:6]
    side_a, side_b = (desc_a, mask_a, uv_pred), (desc_b, mask_b, uv_b)
    groups = desc_a.shape[0] if in_dims[0] is None else desc_a.movedim(in_dims[0], 0).shape[1]
    if all(d is None for d in dims_a) and groups == 1:
        # One A, unmapped: it stays shared by the whole folded batch.
        a_group = n * a_group
    else:
        side_a = [fold_mapped(x, d, n) for x, d in zip(side_a, dims_a)]
    side_b = [fold_mapped(x, d, n) for x, d in zip(side_b, dims_b)]
    out = _match_op(side_a[0], side_a[1], side_b[0], side_b[1], side_a[2], side_b[2],
                    gate_radius, a_group)
    return tuple(o.reshape((n, -1) + tuple(o.shape[1:])) for o in out), (0, 0, 0, 0)


torch.library.register_vmap(_match_op, _match_vmap)


def match_top2(desc_a, mask_a, desc_b, mask_b, uv_pred=None, uv_b=None,
               gate_radius: float = 0.0):
    """(min1, min2, arg1, colarg); gated when uv_pred, uv_b and
    gate_radius > 0 are all given (as the reference), batched when desc_b
    is (Bt, N, D) (see the module docstring for A's shapes)."""
    if desc_a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {desc_a.device}")
    gated = uv_pred is not None and uv_b is not None and gate_radius > 0.0
    batched = desc_b.dim() == 3
    if desc_a.dim() == 3 and not batched:
        raise ValueError("match_top2: a grouped A (G, K, D) needs a batched B (Bt, N, D)")
    if desc_a.dim() == 2:
        desc_a, mask_a = desc_a[None], mask_a[None]
        uv_pred = uv_pred[None] if gated else None
    if not batched:
        desc_b, mask_b = desc_b[None], mask_b[None]
        uv_b = uv_b[None] if gated else None
    G, Bt = desc_a.shape[0], desc_b.shape[0]
    if Bt % G:
        raise ValueError(f"match_top2: {Bt} sets B do not split into {G} groups of A")
    out = _match_op(desc_a, mask_a, desc_b, mask_b, uv_pred if gated else None,
                    uv_b if gated else None, float(gate_radius) if gated else 0.0, Bt // G)
    return out if batched else tuple(o[0] for o in out)


match_top2.launches = 0
match_top2.batched_launches = 0
match_top2.gated_launches = 0
