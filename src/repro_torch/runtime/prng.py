"""Counter-based random numbers: the port's copy of the `jax.random`
functions the reference's sampler and its synthetic data call, bit for
bit (threefry2x32, with `jax_threefry_partitionable` on, as jax 0.9 has
it by default).

    key = prng_key(seed)          # jax.random.PRNGKey(seed)
    key = fold_in(key, data)      # jax.random.fold_in(key, data)
    k1, k2 = split(key)           # jax.random.split(key)
    u = uniform(key, minval)      # jax.random.uniform(key, (), minval=minval)
    t = randint(key, shape, lo, hi)   # jax.random.randint(..., jnp.int32)

A key is an int64 tensor (..., 2) holding two uint32 words; every word is
kept in an int64 and masked to 32 bits after each add and shift, so the
same integer code runs on the CPU and on CUDA (torch has no uint32
arithmetic on either) and gives the same bits on both. All three
functions broadcast over leading dimensions: one call draws a whole
(rows, candidates) grid of keys.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                 # threefry's key-schedule constant
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000           # float32 1.0


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher (20 rounds) of words (k1, k2) over
    counter words (x1, x2): int64 tensors of uint32 values, broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def _words(x) -> torch.Tensor:
    """An int tensor as uint32 words in int64 (two's complement wrap)."""
    return torch.as_tensor(x).to(torch.int64) & MASK


def prng_key(seed) -> torch.Tensor:
    """jax.random.PRNGKey of an int32 seed (scalar or tensor): the words
    (0, seed mod 2^32), so a negative seed keys as its uint32 pattern."""
    s = _words(seed)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: the cipher of the counter (0, data) under
    `key`. `data` (int, wrapped to uint32) broadcasts against key[..., 0]."""
    d = _words(data).to(key.device)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: the ciphers of the counters (0, 0..num-1) under
    `key`, (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits for each element of `shape` under each key, (...,
    *shape): the partitionable layout takes the counter (0, i) for the
    element at flat index i and xors the two output words."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError(f"{n} draws need a 64-bit counter")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = (*key.shape[:-1], *([1] * len(shape)))
    o1, o2 = threefry2x32(key[..., 0].reshape(lead),
                          key[..., 1].reshape(lead), torch.zeros_like(lo), lo)
    return o1 ^ o2


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval, jnp.int32) of one
    key: two 32-bit draws a value (from the key's two halves), reduced
    modulo the span in uint32 arithmetic, as jax does. int32."""
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise ValueError(f"[{minval}, {maxval}) is not an int32 range")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult & MASK) % span
    off = ((higher % span) * mult & MASK) + lower % span
    off = (off & MASK) % span
    return (minval + off).to(torch.int32)


def uniform(key: torch.Tensor, minval: float = 0.0) -> torch.Tensor:
    """jax.random.uniform(key, (), float32, minval, 1.0) per key: the top
    23 bits as the mantissa of a float in [1, 2), less 1, scaled to
    [minval, 1) and floored at minval, each step in float32 as jax does."""
    bits = (random_bits(key) >> 9) | _ONE_F32_BITS
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    # float32 host scalars: a step copies nothing to the device
    lo = np.float32(minval)
    span = np.float32(1.0) - lo
    return torch.clamp(f * float(span) + float(lo), min=float(lo))
