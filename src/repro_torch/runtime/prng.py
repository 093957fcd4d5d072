"""Counter-based random numbers: the port's copy of the `jax.random`
functions the reference's sampler and its synthetic data call, bit for
bit (threefry2x32, with `jax_threefry_partitionable` on, as jax 0.9 has
it by default).

    key = prng_key(seed)          # jax.random.PRNGKey(seed)
    key = fold_in(key, data)      # jax.random.fold_in(key, data)
    k1, k2 = split(key)           # jax.random.split(key)
    u = uniform(key, minval)      # jax.random.uniform(key, (), minval=minval)
    t = randint(key, shape, lo, hi)   # jax.random.randint(..., jnp.int32)
    z = normal(key, shape, dtype)     # jax.random.normal(key, shape, dtype)

A key is an int64 tensor (..., 2) holding two uint32 words; every word is
kept in an int64 and masked to 32 bits after each add and shift, so the
same integer code runs on the CPU and on CUDA (torch has no uint32
arithmetic on either) and gives the same bits on both. `fold_in`,
`split` and `uniform` broadcast over leading dimensions: one call draws a
whole (rows, candidates) grid of keys.

`normal` is jax's inverse-CDF draw, sqrt(2) * erf_inv(u), with the
arithmetic XLA's CPU backend compiles for it: the Giles erf_inv
polynomial (as XLA decomposes `erf_inv`), its log1p (a Cephes rational
below |x| = sqrt(2) - 1, else a Cephes-style log of 1 + x), each a*b + c
of them one fused multiply-add, as LLVM contracts them.
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


# ------------------------------------------------------------- normal --
_SQRT1_2 = 0.707106781186547524      # Cephes' SQRTHF
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c for float32 tensors with one rounding: the product is
    exact in float64, the float64 sum is made round-to-odd (TwoSum's
    error nudges an inexact even result one ulp toward it), so its
    rounding to float32 is the correctly rounded fused result."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log of x in (0, 1] (Cephes' logf as it emits
    it: mantissa in [0.5, 1), the polynomial in fused multiply-adds)."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 0x7F
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    ef = 1.0 + e.to(torch.float32)
    low = m < _SQRT1_2
    tmp = torch.where(low, m, 0.0)
    m = m - 1.0
    ef = ef - low.to(torch.float32)
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, _f32(p[0]), _f32(p[1]))
    y1 = _fma(m, _f32(p[3]), _f32(p[4]))
    y2 = _fma(m, _f32(p[6]), _f32(p[7]))
    y = _fma(y, m, _f32(p[2]))
    y1 = _fma(y1, m, _f32(p[5]))
    y2 = _fma(y2, m, _f32(p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _f32(_LOG_Q1) * ef)
    m = _fma(-x2, _f32(0.5), m)
    m = m + y
    return _fma(_f32(_LOG_Q2), ef, m)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p of x in (-1, 0]: Cephes' rational below
    |x| = sqrt(2) - 1, else log(1 + x)."""
    def poly(cs):
        out = torch.zeros_like(x)
        for c in cs:
            out = _fma(out, x, _f32(c))
        return out

    x2 = x * x
    small = poly(_LOG1P_NUM) / poly(_LOG1P_DEN)
    small = x + _fma(_f32(-0.5), x2, (x * x2) * small)
    large = _log_f32(torch.clamp(x + 1.0, min=2.0 ** -126))
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (Giles' polynomials) of x in (-1, 1)."""
    w = -_log1p_f32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(lo), _f32(hi)))
    return p * x


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """jax.random.normal(key, shape, dtype) of one key, float32 or
    bfloat16: a uniform u on (nextafter(-1, 0), 1) in `dtype` from the
    top mantissa bits of 32 random bits (float32) or of their low 8
    (bfloat16, whose 7 mantissa bits jax draws from 8), then sqrt(2) *
    erf_inv(u), erf_inv in float32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normal draws float32 or bfloat16, not {dtype}")
    bits = random_bits(key, tuple(shape))
    if dtype == torch.float32:
        f = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(
            torch.float32) - 1.0
    else:
        b16 = ((bits & 0xFF) >> 1) | 0x3F80     # jax draws 8 bits here
        f = (b16 << 16).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype))
    span = (torch.tensor(1.0, dtype=dtype) - lo).item()
    u = torch.clamp((f * span + lo.item()).to(dtype), min=lo.item())
    z = _erf_inv_f32(u.to(torch.float32)).to(dtype)
    return z * torch.tensor(2.0 ** 0.5, dtype=dtype)
