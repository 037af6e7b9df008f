"""The reference's random draws: the categorical draw kernel's wrapper and
its plain PyTorch twin (no Pallas counterpart: the reference's draws are
jax.random calls that XLA fuses).

`threefry_categorical(keys, index, paths, logits, shape)` returns the
draws' indices, (P, J, *shape) int64: entry (p, j) is
jax.random.categorical(k, logits[p], shape=shape) under the key k of field
(p, j) below, argmax over m of gumbel(k, (*shape, M)) + logits[p] (the
first index on ties). The RANSAC solves draw through it
(`draw_categorical`, keyed by a `FrameKey`): one launch per solve, and no
Gumbel field is written. A CPU tensor runs the plain twin (`utils/prng.py`);
a CUDA tensor launches the kernel of `csrc/threefry_gumbel.cu` once or
raises, through the custom op `vislam_torch::threefry_categorical`, whose
vmap rule folds a batch's keys (and its logits, mapped or shared) into
the kernel's P: one launch for a draw of every entry of a batched frame.
`threefry_categorical.launches` counts the kernel's launches.

`threefry_gumbel(keys, index, paths, size)` takes P keys (P, 2) int32 (the
uint32 words' bits), an optional frame index (P,) int32 and J paths of
folds (tuples of ints in [0, 2^31)), and returns (P, J, *size) float32: field
(p, j) is jax.random.gumbel(k, size) for the key k = fold_in(...fold_in(
fold_in(keys[p], index[p]), paths[j][0])..., paths[j][-1]). A split
key's entry i is its fold of i (partitionable mode), so the translation
RANSAC's pair split(k) is the paths (0,) and (1,), the rescue's
split(fold_in(k, 7)) the paths (7, 0) and (7, 1). It is plain PyTorch on
any device, the noise that tests and diagnostics feed a step; no path of
the port writes a field.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from vislam_tpu_torch.ops import build, fold_mapped
from vislam_tpu_torch.utils import prng


class FrameKey(NamedTuple):
    """A draw's key on the device, folded in by the draw kernel so that
    nothing is drawn or computed on the host per frame: base (2,) int32
    (the uint32 key's bits), then the frame index () int32 (None: not
    folded), then the folds of `path` (the rescue's (7,))."""

    base: Tensor
    index: Optional[Tensor] = None
    path: tuple = ()


def draw_categorical(key, paths, logits, shape) -> Tensor:
    """(J, *shape) int64: the categorical draws over logits (M,) under each
    of the J paths of folds after `key` (a FrameKey, or a (2,) int32 key
    tensor), jax.random.categorical(k_j, logits, shape=shape): one launch.
    Under torch.func.vmap a mapped key and mapped or shared logits fold
    into the same one launch."""
    if torch.is_tensor(key):
        key = FrameKey(key)
    index = None if key.index is None else key.index.reshape(1)
    return threefry_categorical(key.base.reshape(1, 2), index,
                                [tuple(key.path) + tuple(p) for p in paths],
                                logits.reshape(1, -1), shape)[0]


def _fields(keys, index, paths, size):
    """The Gumbel fields (P, J, *size) of keys (P, 2), index (P,) or None
    and J paths of folds, by `utils/prng.py`."""
    k = keys if index is None else prng.derive_keys(keys, [index])
    fields = torch.stack([prng.derive_keys(k, path) for path in paths], 1)
    return prng.gumbel(fields, size)


def threefry_gumbel(keys, index, paths, size):
    """(P, J, *size) float32 Gumbel fields of keys (P, 2) int32 folded with
    index (P,) int32 (or None) and then with each of the J paths (tuples of
    ints in [0, 2^31)), in plain PyTorch on the keys' device. See the
    module docstring."""
    paths = [tuple(int(d) for d in path) for path in paths]
    if keys.dim() != 2 or keys.shape[1] != 2 or (index is not None
                                                and index.shape != keys.shape[:1]):
        raise ValueError(f"threefry_gumbel takes keys (P, 2) and index (P,), got "
                         f"{tuple(keys.shape)}, "
                         f"{None if index is None else tuple(index.shape)}")
    if not paths or any(not 0 <= d < 2 ** 31 for p in paths for d in p):
        raise ValueError(f"threefry_gumbel takes paths of folds in [0, 2^31): {paths}")
    return _fields(keys, index, paths, tuple(int(s) for s in size))


def _cycle(x, P: int):
    """Rows p = 0..P-1 of x, row p taking x[p % len(x)]; None stays None."""
    return None if x is None else x.repeat((P // x.shape[0],) + (1,) * (x.dim() - 1))


def threefry_categorical_plain(keys, index, paths, logits, shape):
    """The plain version: the Gumbel fields (P, J, *shape, M) of the twin,
    plus logits[p] (one float32 add, as `prng.categorical`), then
    torch.argmax over M. keys (Pk, 2), index (Pi,) or None and logits (Pl,
    M), row p of the draw taking row p % rows of each."""
    P = max(keys.shape[0], logits.shape[0], 0 if index is None else index.shape[0])
    M = logits.shape[-1]
    fields = _fields(_cycle(keys, P), _cycle(index, P), paths, tuple(shape) + (M,))
    lg = _cycle(logits, P).reshape((P, 1) + (1,) * len(shape) + (M,))
    return torch.argmax(fields + lg, dim=-1)


def _lib():
    fn = build.load("threefry_gumbel").threefry_categorical
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, i, p, i, p, i, i, i, i, p, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("vislam_torch::threefry_categorical", mutates_args=(),
                         device_types="cuda")
def _categorical_op(keys: Tensor, index: Optional[Tensor], logits: Tensor, paths: list[int],
                    n_paths: int, shape: list[int]) -> Tensor:
    """The kernel on keys (Pk, 2) int32, index (Pi,) int32 or None, logits
    (Pl, M) float32, row p of the draw taking row p % rows of each (P the
    largest count, each dividing it); paths holds n_paths paths, each
    padded to one length with -1, flattened. Returns (P, J, *shape)."""
    rows = [keys.shape[0], logits.shape[0]] + ([] if index is None else [index.shape[0]])
    P = max(rows)
    L = len(paths) // n_paths
    if (keys.dtype != torch.int32 or logits.dtype != torch.float32
            or (index is not None and index.dtype != torch.int32)
            or any(not t.is_contiguous() or t.device != keys.device
                   for t in (keys, logits) + (() if index is None else (index,)))
            or any(P % r for r in rows)):
        raise ValueError("threefry_categorical kernel takes contiguous int32 keys and index and "
                         "float32 logits on one device, row counts dividing the largest")
    out = torch.empty((P, n_paths, *shape), dtype=torch.int64, device=keys.device)
    path = (ctypes.c_int * max(len(paths), 1))(*paths)
    with torch.cuda.device(keys.device):
        err = _lib()(
            keys.data_ptr(), keys.shape[0], None if index is None else index.data_ptr(),
            0 if index is None else index.shape[0], logits.data_ptr(), logits.shape[0], P,
            n_paths, L, path, math.prod(shape), logits.shape[1], out.data_ptr(),
            torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_categorical launch failed: cudaError {err}")
    threefry_categorical.launches += 1
    return out


def _unpad(paths, n_paths):
    """The flattened, -1-padded paths as J lists of folds."""
    L = len(paths) // n_paths
    return [[d for d in paths[j * L:(j + 1) * L] if d >= 0] for j in range(n_paths)]


@_categorical_op.register_kernel("cpu")
def _categorical_op_cpu(keys, index, logits, paths, n_paths, shape):
    return threefry_categorical_plain(keys, index, _unpad(paths, n_paths), logits, shape)


@_categorical_op.register_fake
def _categorical_op_fake(keys, index, logits, paths, n_paths, shape):
    P = max(keys.shape[0], logits.shape[0], 0 if index is None else index.shape[0])
    return keys.new_empty((P, n_paths, *shape), dtype=torch.int64)


def _categorical_vmap(info, in_dims, keys, index, logits, paths, n_paths, shape):
    """A mapped input folds into the rows, B x P (expanded to each entry's
    P rows first where it has fewer); an unmapped one stays as it is, so
    every entry takes its rows (shared logits are not copied)."""
    ins = [None if t is None or d is None else t.movedim(d, 0)
           for t, d in zip((keys, index, logits), in_dims[:3])]
    P = max(t.shape[0] if m is None else m.shape[1]
            for t, m in zip((keys, index, logits), ins) if t is not None)

    def fold(t, m):
        if m is None:
            return t
        if m.shape[1] != P:
            m = m.repeat((1, P // m.shape[1]) + (1,) * (m.dim() - 2))
        return fold_mapped(m, 0, info.batch_size)

    out = _categorical_op(*[fold(t, m) for t, m in zip((keys, index, logits), ins)],
                          paths, n_paths, shape)
    return out.unflatten(0, (info.batch_size, -1)), 0


torch.library.register_vmap(_categorical_op, _categorical_vmap)


def threefry_categorical(keys, index, paths, logits, shape):
    """(P, J, *shape) int64 categorical draws: entry (p, j) is
    jax.random.categorical(k, logits[p], shape=shape), k the key of field
    (p, j) as `threefry_gumbel` keys its field (p, j). keys (P, 2) int32, index (P,)
    int32 or None, logits (P, M) float32; an input with one row serves
    every p. See the module docstring."""
    paths = [tuple(int(d) for d in path) for path in paths]
    shape = [int(s) for s in shape]
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    rows = [keys.shape[0], logits.shape[0]] + ([] if index is None else [index.shape[0]])
    P = max(rows)
    if (keys.dim() != 2 or keys.shape[1] != 2 or logits.dim() != 2 or logits.shape[1] < 1
            or (index is not None and index.dim() != 1) or any(r not in (1, P) for r in rows)):
        raise ValueError(f"threefry_categorical takes keys (P, 2), index (P,) and logits "
                         f"(P, M), each with P rows or one, got {tuple(keys.shape)}, "
                         f"{None if index is None else tuple(index.shape)}, "
                         f"{tuple(logits.shape)}")
    if not paths or any(not 0 <= d < 2 ** 31 for p in paths for d in p):
        raise ValueError(f"threefry_categorical takes paths of folds in [0, 2^31): {paths}")
    L = max(len(p) for p in paths)
    return _categorical_op(keys.contiguous(), None if index is None else index.contiguous(),
                           logits.contiguous(),
                           [d for p in paths for d in p + (-1,) * (L - len(p))], len(paths),
                           shape)


threefry_categorical.launches = 0
