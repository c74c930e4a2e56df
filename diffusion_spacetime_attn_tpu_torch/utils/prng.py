"""`jax.random`'s default generator (threefry2x32) in numpy, for noise that
matches the JAX package's without JAX.

What jax 0.9 computes with `jax_threefry_partitionable` True, its default
there (older jax defaulted to False, which lays the counters out otherwise
and draws different bits from the same key):

  * `PRNGKey(seed)` is the pair (0, seed) for a seed in int32 range (JAX
    without 64-bit mode); the JAX package's serving engines cast the seeds
    to uint32 first, which gives (0, seed mod 2³²) for any int
    (`engine_key`);
  * `fold_in(key, data)` hashes the counter pair (0, data) under `key`;
  * `split(key, num)` hashes the 64-bit counter i = 0 .. num−1, split into
    (high, low) words, under `key`: key i is the pair of output words, so
    `split(key, num)[i]` is `fold_in(key, i)`;
  * `bits(key, shape)` hashes the 64-bit counter i = 0, 1, ... of each
    element, row-major, split into (high, low) words, and xors the two
    output words;
  * `randint(key, shape, lo, hi)` draws two words per element, from the
    two halves of `split(key)`, and reduces them into [lo, hi) as jax's
    `_randint` does: (hi_word mod span · (2³² mod span) + lo_word mod span)
    mod span in uint32 arithmetic (int32 bounds);
  * `uniform` puts the top 23 bits in the mantissa of a float in [1, 2),
    subtracts 1, scales to [lo, hi) and clamps at lo, all in float32;
  * `categorical(key, logits)` is the argmax of logits + gumbel, the gumbel
    draw −log(−log(uniform(lo = tiny, hi = 1))) in float32 (jax's "low"
    mode, its default; tiny = 2⁻¹²⁶), of the logits' shape;
  * `normal` is √2 · erfinv(uniform(lo = nextafter(−1, 0), hi = 1)), with
    the single-precision erfinv polynomial of XLA (M. Giles, "Approximating
    the erfinv function", GPU Computing Gems, 2011): w = −log1p(−x²), two
    9-term Horner branches split at w < 5.

`split`, `bits`, `randint` and `uniform` equal jax's bit for bit, and so do the indices
`categorical` returns, but for logits within an ulp of a tie.  `normal` agrees within a few
float32 ulp: each Horner step here is one float32 rounding of a float64
multiply-add and log1p is numpy's, which need not round as XLA's fused code
does.  Keys are uint32 arrays of shape (2,).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) of counter words (x0, x1)
    under `key`; returns the two output words."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for j in range(5):
        for r in _ROTATIONS[j % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(j + 1) % 3]
        x[1] = x[1] + ks[(j + 2) % 3] + np.uint32(j + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside int32")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def engine_key(seed: int) -> np.ndarray:
    """The key of a request's seed in the JAX package's serving engines,
    `PRNGKey` of the seed cast to uint32 (`serving/server.py:108-113,178`
    there): (0, seed mod 2³²) for any int."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`num` new keys, shape (num, 2)."""
    idx = np.arange(num, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = threefry2x32(key, hi, lo)
    return np.stack([a, b], axis=-1)


def bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Uniform uint32 words of `shape`."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = threefry2x32(key, hi, lo)
    return (a ^ b).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int], lo: float = 0.0,
            hi: float = 1.0) -> np.ndarray:
    """float32 in [lo, hi)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    mant = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = mant.view(np.float32) - np.float32(1.0)
    return np.maximum(lo32, f * (hi32 - lo32) + lo32)


_I32 = np.iinfo(np.int32)


def randint(key: np.ndarray, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """int32 of `shape` in [minval, maxval) (minval where maxval <= minval),
    `jax.random.randint`'s draw for the int32 dtype."""
    if not all(_I32.min <= int(b) <= _I32.max for b in (minval, maxval)):
        raise ValueError(f"randint bounds ({minval}, {maxval}) outside int32")
    lo, hi = int(minval), int(maxval)
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = np.uint32(1 if hi <= lo else hi - lo)
    mult = np.uint32((1 << 16) % int(span))
    mult = np.uint32(int(mult) * int(mult) % (1 << 32) % int(span))  # the uint32 product wraps
    with np.errstate(over="ignore"):
        offset = (higher % span * mult + lower % span) % span
    return (lo + offset.astype(np.int64)).astype(np.int32)


_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
          -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
          -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, XLA's polynomial."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-(x * x))
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = [np.where(small, np.float32(a), np.float32(b)) for a, b in zip(_W_LT5, _W_GE5)]
    p = coef[0]
    w64 = w.astype(np.float64)
    for c in coef[1:]:
        p = (c.astype(np.float64) + p.astype(np.float64) * w64).astype(np.float32)
    edge = np.copysign(np.float32(np.inf), x)             # erfinv(±1) = ±inf
    return np.where(np.abs(x) == np.float32(1.0), edge, p * x).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Standard normal float32 of `shape`."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erfinv(u)


def normal_like(key: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`normal(key, like.shape)` as a tensor on like's device in its dtype
    (drawn in float32 on the host, then moved and cast)."""
    z = torch.from_numpy(normal(key, tuple(like.shape)))
    return z.to(device=like.device, dtype=like.dtype)


def gumbel(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Standard Gumbel float32 of `shape`."""
    tiny = np.finfo(np.float32).tiny
    u = uniform(key, shape, tiny, 1.0)
    return -np.log(-np.log(u))


def categorical(key: np.ndarray, logits, axis: int = -1) -> np.ndarray:
    """Indices drawn from softmax(logits) along `axis` (the axis removed),
    int32."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(key, logits.shape) + logits, axis=axis).astype(np.int32)
