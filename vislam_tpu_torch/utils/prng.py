"""The reference's random stream: JAX's threefry2x32 keys and draws, in the
port's own code (nothing is imported from JAX).

JAX keys a draw with a pair of uint32 words and hashes counters with
Threefry-2x32 (20 rounds, Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011). The reference runs JAX's default
`jax_threefry_partitionable=True` (jax 0.9), under which:

- `PRNGKey(seed)` is (0, seed mod 2^32) for a 32-bit seed;
- `fold_in(k, d)` and `split(k, n)[i]` are both the hash of the counter
  pair (0, d) or (0, i) under k (so `split(k, n)[i]` does not depend on n);
- `random_bits(k, shape)` hashes the pair (hi, lo) of each element's flat
  index and XORs the two output words;
- `uniform` puts the top 23 bits in the mantissa of [1, 2), and `gumbel` is
  -log(-log(uniform(k, shape, minval=tiny))).

Two halves:
- keys on the host, numpy uint32: `prng_key`, `fold_in`, `split`; a key
  is a (2,) uint32 array, (B, 2) for a batch;
- plain tensor versions on any device: `threefry2x32`, `random_bits`,
  `uniform`, `gumbel`, `categorical`, and `derive_keys` (a chain of
  fold_ins on a key tensor, which the host keys run on the CPU).
  They hold uint32 words as int32 bits (torch has no `<<` for uint32 on
  the CPU), and are the CPU path and the card kernel's twin
  (`ops/threefry_kernel.py`); a tensor key is int32 (the uint32's bits) or
  int64 in [0, 2^32), shape (..., 2).
"""

from __future__ import annotations

import decimal
import math

import numpy as np
import torch

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
TINY = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------- host keys

def prng_key(seed: int) -> np.ndarray:
    """The key of a 32-bit seed, (0, seed mod 2^32), as JAX's PRNGKey(seed)
    (its threefry_seed with 64-bit integers off)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"prng_key takes a 32-bit seed, got {seed}")
    return np.array([0, seed & _MASK], np.uint32)


def _host_fold(key, data) -> np.ndarray:
    """Host keys (..., 2) folded with `data` by `derive_keys` on the CPU,
    back as uint32."""
    k = torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))
    return derive_keys(k, [data]).numpy().view(np.uint32).copy()


def fold_in(key, data: int) -> np.ndarray:
    """JAX's fold_in(key, data): key (2,) or (B, 2), data in [0, 2^32)."""
    data = int(data)
    if not 0 <= data < 2 ** 32:
        raise ValueError(f"fold_in takes data in [0, 2^32), got {data}")
    return _host_fold(key, data)


def split(key, n: int = 2) -> np.ndarray:
    """JAX's split(key, n) (partitionable): (n, 2), entry i the hash of
    (0, i), which does not depend on n."""
    key = np.asarray(key, np.uint32)
    if key.shape != (2,):
        raise ValueError(f"split takes one key (2,), got {key.shape}")
    return _host_fold(key[None], torch.arange(n, dtype=torch.int64))


def key_tensor(key, device) -> torch.Tensor:
    """A host key (..., 2) uint32 as an int32 tensor of its bits on
    `device`: one copy, to the card from pinned memory without waiting
    (no host sync)."""
    bits = torch.from_numpy(np.ascontiguousarray(np.asarray(key, np.uint32)).view(np.int32)
                            .copy())
    if torch.device(device).type == "cuda":
        bits = bits.pin_memory()
    return bits.to(device, non_blocking=True)


# ---------------------------------------------------------- tensor versions

def _bits32(x) -> torch.Tensor:
    """uint32 words as int32 tensors of their bits: int32 as it is, other
    integers (int64 in [0, 2^32), Python ints) reduced mod 2^32."""
    x = torch.as_tensor(x)
    if x.dtype == torch.int32:
        return x
    x = x.to(torch.int64) & _MASK
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pairs (x1, x2) under the key (k1, k2),
    on int32 tensors of uint32 bits (broadcast): additions
    wrap mod 2^32 as the uint32's do, and the right shift, arithmetic on
    int32, is masked to a logical one. The rounds update two fresh tensors
    in place (on the CPU 3-4x the speed of the same on int64 masked to 32
    bits, with the same bits)."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x1, x2 = (t.contiguous() for t in torch.broadcast_tensors(x1 + ks[0], x2 + ks[1]))
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1.add_(x2)
            high = x2 << r
            x2.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x2.bitwise_or_(high).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3])
        x2.add_(ks[(i + 2) % 3] + (i + 1))
    return x1, x2


def derive_keys(keys: torch.Tensor, data) -> torch.Tensor:
    """Keys (..., 2) folded in with data in turn (each an int or an integer
    tensor broadcasting against keys[..., 0]): fold_in(...fold_in(keys,
    d0)..., dn), as int32 bits (..., 2). Also split(k, n)[i], the fold of
    i."""
    k = _bits32(keys)
    for d in data:
        d = _bits32(torch.as_tensor(d, device=k.device))
        h1, h2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
        k = torch.stack(torch.broadcast_tensors(h1, h2), -1)
    return k


def _random_bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """`random_bits` as int32 bits."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2 ** 31:
        raise ValueError(f"random_bits of {n} elements: counters from 2^31 not supported")
    k = _bits32(key)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(lead + (1,))
    k2 = k[..., 1].reshape(lead + (1,))
    i = torch.arange(n, dtype=torch.int32, device=k.device)
    h1, h2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return (h1 ^ h2).reshape(lead + shape)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """JAX's random.bits(key, shape) (uint32, partitionable) as int64 in
    [0, 2^32): key (..., 2) gives (..., *shape)."""
    return _random_bits32(key, shape).to(torch.int64) & _MASK


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int32 or int64) -> float32 in [0, 1): the top 23 bits as
    the mantissa of [1, 2), minus 1."""
    b = _bits32(bits)
    one = ((b >> 9) & 0x7FFFFF | 0x3F800000).view(torch.float32)
    return one - torch.ones((), dtype=torch.float32, device=b.device)


def uniform(key: torch.Tensor, shape, minval: float = 0.0) -> torch.Tensor:
    """JAX's uniform(key, shape, float32, minval, 1.0): float32 (..., *shape),
    in its order: floats * (1 - minval) + minval, then max(minval, .)."""
    f32 = dict(dtype=torch.float32, device=key.device)
    lo = torch.full((), minval, **f32)
    span = torch.ones((), **f32) - lo
    return torch.maximum(lo, bits_to_unit(_random_bits32(key, shape)) * span + lo)


# log(x) = e ln2 + log(c_j) + log1p(r), r = (m - c_j) / c_j: x = 2^e m, m in
# [1, 2), c_j = 1 + j/256 the nearest of 257 centres (j = 0..256: m's top 8
# fraction bits rounded, a carry giving c_256 = 2). m - c_j is exact, so
# |r| <= 2^-9 costs one multiplication by the table's 1/c_j and no
# division; 6 terms of log1p leave |r|^7/7 <= 2^-65.8. Near 1 the log keeps
# its relative accuracy: x just above 1 has c = 1 and r = m - 1 exactly;
# x just below has e = -1 and c = 2, and e ln2 + log 2 is exactly 0. log(c_j)
# comes from decimal arithmetic (40 digits, rounded once to float64: the
# same bits on any host); 1/c_j is a correctly rounded float64 division.
# The card kernel (`ops/csrc/threefry_gumbel.cu`) holds the same table and
# repeats the operations that round, in the same order, each rounded once.
LN2 = math.log(2.0)
LOG_TABLE_SIZE = 256                            # centres per binade; the table has 257
LOG1P_TERMS = (-1.0 / 6.0, 1.0 / 5.0, -1.0 / 4.0, 1.0 / 3.0, -1.0 / 2.0)


def _log_centres():
    with decimal.localcontext() as ctx:
        ctx.prec = 40
        return tuple(float((1 + decimal.Decimal(j) / LOG_TABLE_SIZE).ln())
                     for j in range(LOG_TABLE_SIZE + 1))


LOG_CENTRES = _log_centres()                   # log(c_j), float64, j = 0..256
INV_CENTRES = tuple(1.0 / (1.0 + j / LOG_TABLE_SIZE) for j in range(LOG_TABLE_SIZE + 1))
_LOG_C = torch.tensor(LOG_CENTRES, dtype=torch.float64)
_INV_C = torch.tensor(INV_CENTRES, dtype=torch.float64)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """The natural log of positive float32 x, rounded to float32 from
    float64 (a table of 257 centres and a log1p series; see above), with
    the same rounded operations in the same order on every device (the
    card kernel repeats them). Not torch.log: on the CPU its first call in
    a thread was seen to return blocks of 2048 values off by 1e-5 relative
    (intermittently, MKL's vector log), and the card's logf and the CPU's
    differ in the last bit besides."""
    bits = x.double().view(torch.int64)
    hi = (bits >> 32).to(torch.int32)           # sign 0, 11 exponent bits, 20 of m's
    e = (hi >> 20) - 1023
    m_hi = (hi & 0xFFFFF) | 0x3FF00000          # m in [1, 2)
    c_hi = (m_hi + 0x800) & ~0xFFF              # 1 + j/256: m's top 8 fraction bits rounded
    j = ((c_hi - 0x3FF00000) >> 12).long()
    m = ((m_hi.to(torch.int64) << 32) | (bits & 0xFFFFFFFF)).view(torch.float64)
    r = m.sub_((c_hi.to(torch.int64) << 32).view(torch.float64)).mul_(
        _INV_C.to(x.device)[j])
    q = torch.full_like(r, LOG1P_TERMS[0])
    for coef in LOG1P_TERMS[1:]:
        q.mul_(r).add_(coef)
    log1p = (r * r).mul_(q).add_(r)
    return e.double().mul_(LN2).add_(_LOG_C.to(x.device)[j]).add_(log1p).float()


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """JAX's gumbel(key, shape) (mode "low"): -log(-log(uniform(key, shape,
    tiny))), float32 (..., *shape), each log by `log_f32`."""
    return -log_f32(-log_f32(uniform(key, shape, TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor, shape) -> torch.Tensor:
    """JAX's categorical(key, logits, shape=shape) over logits (M,):
    argmax(logits + gumbel(key, (*shape, M))), the first index on ties."""
    g = gumbel(key, tuple(shape) + (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
