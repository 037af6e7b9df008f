"""Gumbel noise of the reference's random stream: the CUDA kernel's wrapper
and its plain PyTorch twin (no Pallas counterpart: the reference's draws
are jax.random calls that XLA fuses).

`threefry_gumbel(keys, index, paths, size)` takes P keys (P, 2) int32 (the
uint32 words' bits), an optional frame index (P,) int32 and J paths of
folds (tuples of ints in [0, 2^31)), and returns (P, J, *size) float32: field
(p, j) is jax.random.gumbel(k, size) for the key k = fold_in(...fold_in(
fold_in(keys[p], index[p]), paths[j][0])..., paths[j][-1]). A split
key's entry i is its fold of i (partitionable mode), so the translation
RANSAC's pair split(k) is the paths (0,) and (1,), the rescue's
split(fold_in(k, 7)) the paths (7, 0) and (7, 1).

A CPU tensor runs the plain twin (`utils/prng.py`); a CUDA tensor launches
`csrc/threefry_gumbel.cu` once or raises, through the custom op
`vislam_torch::threefry_gumbel`, whose vmap rule folds a batch's keys into
the kernel's P: one launch for every draw of a batched frame.
`threefry_gumbel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch import Tensor

from vislam_tpu_torch.ops import build, fold_mapped
from vislam_tpu_torch.utils import prng


def threefry_gumbel_plain(keys, index, paths, size):
    """The plain version: keys (P, 2), index (P,) or None, paths J tuples
    of folds; (P, J, *size) float32."""
    k = keys if index is None else prng.derive_keys(keys, [index])
    fields = torch.stack([prng.derive_keys(k, path) for path in paths], 1)
    return prng.gumbel(fields, size)


def _lib():
    fn = build.load("threefry_gumbel").threefry_gumbel
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, p, i, i, i, p, i, p, p]
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("vislam_torch::threefry_gumbel", mutates_args=(),
                         device_types="cuda")
def _gumbel_op(keys: Tensor, index: Optional[Tensor], paths: list[int], n_paths: int,
               size: list[int]) -> Tensor:
    """The kernel on keys (P, 2) int32 and index (P,) int32 or None; paths
    holds n_paths paths, each padded to one length with -1 (no fold),
    flattened. Returns (P, J, *size)."""
    P = keys.shape[0]
    n = math.prod(size)
    L = len(paths) // n_paths
    if keys.dtype != torch.int32 or not keys.is_contiguous() or (
            index is not None and (index.dtype != torch.int32 or not index.is_contiguous()
                                   or index.device != keys.device)):
        raise ValueError("threefry_gumbel kernel takes contiguous int32 keys and index on "
                         "one device")
    out = torch.empty((P, n_paths, *size), dtype=torch.float32, device=keys.device)
    path = (ctypes.c_int * max(len(paths), 1))(*paths)
    with torch.cuda.device(keys.device):
        err = _lib()(keys.data_ptr(), None if index is None else index.data_ptr(), P, n_paths,
                     L, path, n, out.data_ptr(),
                     torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_gumbel launch failed: cudaError {err}")
    threefry_gumbel.launches += 1
    return out


@_gumbel_op.register_kernel("cpu")
def _gumbel_op_cpu(keys, index, paths, n_paths, size):
    L = len(paths) // n_paths
    return threefry_gumbel_plain(
        keys, index, [[d for d in paths[j * L:(j + 1) * L] if d >= 0] for j in range(n_paths)],
        size)


@_gumbel_op.register_fake
def _gumbel_op_fake(keys, index, paths, n_paths, size):
    return keys.new_empty((keys.shape[0], n_paths, *size), dtype=torch.float32)


def _gumbel_vmap(info, in_dims, keys, index, paths, n_paths, size):
    n = info.batch_size
    out = _gumbel_op(fold_mapped(keys, in_dims[0], n), fold_mapped(index, in_dims[1], n),
                     paths, n_paths, size)
    return out.unflatten(0, (n, -1)), 0


torch.library.register_vmap(_gumbel_op, _gumbel_vmap)


def threefry_gumbel(keys, index, paths, size):
    """(P, J, *size) float32 Gumbel fields of keys (P, 2) int32 folded with
    index (P,) int32 (or None) and then with each of the J paths (tuples of
    ints in [0, 2^31)). See the module docstring."""
    paths = [tuple(int(d) for d in path) for path in paths]
    size = [int(s) for s in size]
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if keys.dim() != 2 or keys.shape[1] != 2 or (index is not None
                                                and index.shape != keys.shape[:1]):
        raise ValueError(f"threefry_gumbel takes keys (P, 2) and index (P,), got "
                         f"{tuple(keys.shape)}, "
                         f"{None if index is None else tuple(index.shape)}")
    if not paths or any(not 0 <= d < 2 ** 31 for p in paths for d in p):
        raise ValueError(f"threefry_gumbel takes paths of folds in [0, 2^31): {paths}")
    L = max(len(p) for p in paths)
    return _gumbel_op(keys.contiguous(), None if index is None else index.contiguous(),
                      [d for p in paths for d in p + (-1,) * (L - len(p))], len(paths), size)


threefry_gumbel.launches = 0
