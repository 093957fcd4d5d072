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
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import ops


def apply_linear(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """y = x @ w for w: Tensor | QuantizedTensor | LowRankQ."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, LowRankQ):
        return ops.lrmm(x, w, out_dtype=out_dtype)
    if isinstance(w, QuantizedTensor):
        return ops.qmm(x, w, out_dtype=out_dtype)
    return (x @ w.to(x.dtype)).to(out_dtype)


# ----------------------------------------------------------------- norms --
def rmsnorm(x, gamma, eps=1e-5):
    x64 = x.to(torch.float64)
    var = (x64 ** 2).mean(dim=-1, keepdim=True)
    y = (x64 / torch.sqrt(var + eps)).to(torch.float32)
    return y.to(x.dtype) * (1.0 + gamma.to(x.dtype))


def layernorm(x, gamma, beta, eps=1e-5):
    """LayerNorm with the population variance, as the reference."""
    x64 = x.to(torch.float64)
    mu = x64.mean(dim=-1, keepdim=True)
    var = ((x64 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = ((x64 - mu) / torch.sqrt(var + eps)).to(torch.float32)
    return y.to(x.dtype) * gamma.to(x.dtype) + beta.to(x.dtype)


def apply_norm(x, p, kind: str, eps: float):
    if kind == "layernorm":
        return layernorm(x, p["gamma"], p["beta"], eps)
    return rmsnorm(x, p["gamma"], eps)


# ------------------------------------------------------------------ MLPs --
def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (jax.nn.gelu's default), in float64."""
    return F.gelu(x.to(torch.float64), approximate="tanh").to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (jax.nn.silu), in float64."""
    return F.silu(x.to(torch.float64)).to(x.dtype)


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
    return apply_linear(h, p["down"])


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
    return (cap * torch.tanh(x / cap)) if cap > 0 else x


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]

