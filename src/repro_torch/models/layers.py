"""Shared building blocks (port of `repro.models.layers`): linear
dispatch, norms, MLP flavors, positions.

`apply_linear` is the single matmul entry point: it dispatches on the
weight node type (dense tensor, QuantizedTensor, LowRankQ). Which path a
compressed node takes is decided by the kernel wrappers from the device
of the tensors alone: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors. There is no mode switch.

Reductions and transcendentals of the float path (the norms, GELU, SiLU,
sinusoids, RoPE's cos and sin) are taken in float64 and rounded once to
float32, so the CPU and CUDA runs very likely give the same bits there,
where float32 `rsqrt`, `exp` and `tanh` often differ between the two by
an ulp. It is not certain:
float64 sums in another order or another libm may still round to a
different float32 now and then. The reference takes them in float32,
within 1e-5 of these.

In a bfloat16 model the reference rounds to bfloat16 after every
operation whose result is bfloat16 (XLA computes each in float32 and
converts, and keeps those converts in its compiled step), so the port
rounds at the same points: the norms' product with gamma, RoPE's float32
result, the residual sums and products (PyTorch's own bfloat16
arithmetic, float32 then rounded), and each step of SiLU's and GELU's
decomposition (`silu`, `gelu`). Between those points it computes in
float32 where an operation is exact or correctly rounded on both devices
(+, *, /) and in float64 for the transcendentals, rounded to float32 and
then to bfloat16.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import ops
from repro_torch.runtime import shardctx


def apply_linear(x: torch.Tensor, w, out_dtype=None, *,
                 reduce_tp: bool = False) -> torch.Tensor:
    """y = x @ w for w: Tensor | QuantizedTensor | LowRankQ.

    reduce_tp marks the tensor-parallel reduction sites (wo, mlp down):
    on a tensor-parallel engine their input features are sliced across
    the ranks, so the rank's product is a partial sum. With a group bound
    (`runtime.shardctx.tp_group`) the partial is taken in float32 (a
    dense weight through a float32 product, a compressed one through its
    kernel's float32 output; a compressed K-site quantizes its
    activations over the rank's own features, as the reference's),
    all-reduced, and cast once after the reduction, the one rounding the
    single-device product makes from its float32 accumulator. With no
    group bound the flag changes nothing."""
    out_dtype = out_dtype or x.dtype
    if reduce_tp and shardctx.get_tp_group() is not None:
        if isinstance(w, (LowRankQ, QuantizedTensor)):
            y = apply_linear(x, w, out_dtype=torch.float32)
        else:
            y = _float32_product(x, w)
        return shardctx.psum_tp(y).to(out_dtype)
    if isinstance(w, LowRankQ):
        return ops.lrmm(x, w, out_dtype=out_dtype)
    if isinstance(w, QuantizedTensor):
        return ops.qmm(x, w, out_dtype=out_dtype)
    return (x @ w.to(x.dtype)).to(out_dtype)


def _float32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w summed and returned in float32 (the reference's
    `preferred_element_type=float32`). On the card a bf16 pair goes
    through `torch.mm(..., out_dtype=float32)`, which accumulates and
    writes float32 without a float32 copy of the weight; elsewhere both
    are cast (the CPU has no such kernel; a product of two bf16 values is
    exact in float32, so the cast pair sums the same products)."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(torch.float32) @ w.to(torch.float32)


# ----------------------------------------------------------------- norms --
def rmsnorm(x, gamma, eps=1e-5, dtype=None):
    """RMSNorm of x (any float dtype), in `dtype` (default x's)."""
    dtype = dtype or x.dtype
    x64 = x.to(torch.float64)
    var = (x64 ** 2).mean(dim=-1, keepdim=True)
    y = (x64 / torch.sqrt(var + eps)).to(torch.float32)
    return y.to(dtype) * (1.0 + gamma.to(dtype))


def layernorm(x, gamma, beta, eps=1e-5, dtype=None):
    """LayerNorm with the population variance, as the reference, in
    `dtype` (default x's)."""
    dtype = dtype or x.dtype
    x64 = x.to(torch.float64)
    mu = x64.mean(dim=-1, keepdim=True)
    var = ((x64 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((x64 - mu) / torch.sqrt(var + eps)).to(torch.float32)
    return y.to(dtype) * gamma.to(dtype) + beta.to(dtype)


def apply_norm(x, p, kind: str, eps: float, dtype=None):
    if kind == "layernorm":
        return layernorm(x, p["gamma"], p["beta"], eps, dtype)
    return rmsnorm(x, p["gamma"], eps, dtype)


def add_norm(h, a, p, kind: str, eps: float):
    """(h + a, its norm): the residual sum in h's dtype, and the norm that
    follows it. For bfloat16 h the norm reads the sum before its rounding
    to bfloat16, h + a in float32: in the reference's compiled step the
    norm's `x.astype(float32)` right after the bfloat16 add lets XLA
    (allowed excess precision) drop that add's rounding there, while the
    residual stream itself keeps it."""
    s = h + a
    if h.dtype != torch.bfloat16:
        return s, apply_norm(s, p, kind, eps)
    wide = h.to(torch.float32) + a.to(torch.float32)
    return s, apply_norm(wide, p, kind, eps, h.dtype)


# ------------------------------------------------------------------ MLPs --
def _bf(x: torch.Tensor) -> torch.Tensor:
    """A float32 (or float64) result rounded as a bfloat16 operation's:
    to float32, then to the nearest even bfloat16; returned widened to
    float32 for the next operation."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (jax.nn.gelu's default), in float64; for a
    bfloat16 x as the reference's bfloat16 graph:
    x * (0.5 * (1 + tanh(c * (x + k * x**3)))), c and k constants in
    bfloat16, every step rounded to bfloat16."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x.to(torch.float64), approximate="tanh").to(x.dtype)
    xf = x.to(torch.float32)
    c = _bf(torch.tensor((2 / torch.pi) ** 0.5))
    k = _bf(torch.tensor(0.044715))
    x3 = _bf(_bf(xf * xf) * xf)
    u = _bf(c * _bf(xf + _bf(k * x3)))
    th = _bf(torch.tanh(u.to(torch.float64)))
    cdf = _bf(0.5 * _bf(1.0 + th))
    return (xf * cdf).to(torch.bfloat16)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (jax.nn.silu), in float64; for a bfloat16 x as XLA
    runs the reference's bfloat16 graph: x * (1 / (1 + exp(-x))), each
    step rounded to bfloat16."""
    if x.dtype != torch.bfloat16:
        return F.silu(x.to(torch.float64)).to(x.dtype)
    xf = x.to(torch.float32)
    sig = _bf(1.0 / _bf(1.0 + _bf(_exp_f32(-xf))))
    return (xf * sig).to(torch.bfloat16)


def mlp_apply(x, p, act: str):
    """The MLP over x (..., K); with stacked weights (E, K, N) (the experts
    of an MoE block) x is (E, C, K) and each linear one launch over all
    E."""
    if act in ("swiglu", "geglu"):
        g = apply_linear(x, p["gate"])
        u = apply_linear(x, p["up"])
        h = (silu(g) if act == "swiglu" else gelu(g)) * u
    elif act == "relu2":
        h = torch.square(F.relu(apply_linear(x, p["up"])))
    else:
        h = gelu(apply_linear(x, p["up"]))
    return apply_linear(h, p["down"], reduce_tp=True)


# ------------------------------------------------------------- positions --
def rope_freqs(head_dim: int, theta: float, rotary_pct: float = 1.0,
               device=None):
    rot = int(head_dim * rotary_pct) // 2 * 2
    return _rope_inv(rot, theta, str(device or "cpu")), rot


@functools.lru_cache(maxsize=None)
def _rope_inv(rot: int, theta: float, device: str) -> torch.Tensor:
    # float32 on the CPU, then moved: the same bits on every device
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32)
                           / rot))
    return inv.to(device)


def apply_rope(x, positions, theta: float, rotary_pct: float = 1.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, theta, rotary_pct, device=x.device)
    ang = (positions[..., :, None].to(torch.float32) * inv).to(
        torch.float64)
    cos = torch.cos(ang).to(torch.float32)[..., None, :]
    sin = torch.sin(ang).to(torch.float32)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


@functools.lru_cache(maxsize=None)
def _sinusoid_freqs(half: int, device: str) -> torch.Tensor:
    # float32 on the CPU, then moved: the same bits on every device
    inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32) / half))
    return inv.to(device)


def sinusoidal_emb(positions, d_model: int, dtype):
    """[sin, cos] of position x 10000^(-i/half), concatenated."""
    inv = _sinusoid_freqs(d_model // 2, str(positions.device))
    ang = positions[..., None].to(torch.float32) * inv
    a64 = ang.to(torch.float64)
    return torch.cat([torch.sin(a64), torch.cos(a64)], dim=-1).to(dtype)


def softcap(x, cap: float):
    """cap * tanh(x / cap) (gemma2's logit soft cap), in float64 and
    rounded once to x's dtype, as the other transcendentals."""
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.to(torch.float64) / cap)).to(x.dtype)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]

