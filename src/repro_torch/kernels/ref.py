"""Plain PyTorch versions of the integer kernels (port of
`repro.kernels.ref`): the arithmetic the CUDA kernels must reproduce bit
for bit. They run on CPU and CUDA tensors alike.

The int8 products are exact, and convert to float32 exactly as the int32
accumulator of the reference does: on CUDA tensors in float64
(`torch.matmul` has no int32 CUDA path, and every partial sum is an
integer below K·127² < 2⁵³), taken in the weight's `column_blocks` (each
column is its own exact sum, so the blocks change no bit); on CPU
tensors with `torch._int_mm`'s int32 sums, which read the int8 codes as
they lie (a float64 copy of an expert stack is what made a CPU step
slow). Every function also takes a stack
of matrices, (E, M, K) against (E, K, N): a mixture-of-experts layer's
experts, each its own product.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import column_blocks, symmetric_scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 matrices (or stacks of them),
    returned as float32 (the value `acc.astype(f32)` of an int32
    accumulator)."""
    if a.device.type != "cpu":
        a64 = a.to(torch.float64)
        parts = [torch.matmul(a64, b[..., cols].to(torch.float64))
                 for cols in column_blocks(b)]
        return (parts[0] if len(parts) == 1 else torch.cat(parts, -1)).to(
            torch.float32)
    if a.ndim == 3:
        return torch.stack([int_matmul(x, w) for x, w in zip(a, b)])
    return torch._int_mm(a.contiguous(), b.contiguous()).to(torch.float32)


def quant_matmul_ref(xq, sx, wq, sw):
    """Y = (Xq @ Wq as f32) * sx * sw.

    xq: (M, K) int8; sx: (M, 1) f32; wq: (K, N) int8; sw: (1, N) f32;
    or stacks of them, (E, M, K) ... (E, 1, N)."""
    return int_matmul(xq, wq) * sx * sw


def requant_rows(t: torch.Tensor, qm: int = 127):
    """Symmetric per-row requantization into an int8 carrier, clamped to
    ±qm = ±qmax(act_wl)."""
    st = symmetric_scale(t.abs().amax(dim=-1, keepdim=True), qm)
    tq = torch.clamp(torch.round(t / st), -qm, qm).to(torch.int8)
    return tq, st


def lowrank_qmm_ref(xq, sx, w1q, s1, w2q, s2, qm: int = 127):
    """The cascade of the fused kernel:

    phase 1: t = (Xq @ W1q) · sx · s1 · s2ᵀ   (s2 folded into t)
    requant: Tq, st = rowquant(t), clamped to ±qm
    phase 2: Y = (Tq @ W2q) · st

    xq (M, K) int8, sx (M, 1); w1q (K, R) int8, s1 (1, R); w2q (R, N)
    int8, s2 (R, 1); or stacks of them, (E, M, K) ... (E, R, 1). Factors
    arrive in carrier layout."""
    t = int_matmul(xq, w1q)
    t = t * sx * s1 * s2.transpose(-1, -2)
    tq, st = requant_rows(t, qm)
    return int_matmul(tq, w2q) * st
