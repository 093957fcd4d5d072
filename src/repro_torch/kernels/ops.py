"""Linear entry points over the kernels (port of `repro.kernels.ops`).

`qmm` and `lrmm` quantize the activations per row (clamp from the plan's
act_wl carried on the weight node), pad to what the CUDA kernels take,
and call the kernel wrappers, which launch the CUDA kernel on CUDA tensors
and run the plain version on CPU tensors. The output is the kernels' own,
float32 or bfloat16 (rounded once from float32 in their epilogue, the
reference's `.astype`); the activations' scale of a bfloat16 x is rounded
to bfloat16 first, as the reference computes `absmax / qm` in x's dtype
(see `quantize_acts`).

Padding: the CUDA kernels read activations 16 bytes at a time, so K pads
to a multiple of 16. Both copy weight rows in whole 16-byte chunks with
cp.async (16 int8 or 32 packed W4 columns), so `quant_matmul`'s N and
`lowrank_qmm`'s R and N pad to 32. Padding is in the packed domain where
a factor is packed (zero bytes are zero codes) with scale 1, so it is
exact: a zero-code rank column adds 0 to T and to the row absmax. The
TPU's 128/256 padding and its packed-axis demotion are not needed.

Expert stacks: a weight node whose arrays carry a leading expert axis
((E, K, N), a mixture-of-experts projection) takes activations (E, ..., K)
and runs as ONE kernel launch over all E experts, each expert's rows
quantized and padded as one matrix's are: the reference vmaps its
pallas_call, which adds the expert axis to the kernel's grid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor, qmax, symmetric_scale
from repro_torch.kernels.lowrank_qmm import lowrank_qmm
from repro_torch.kernels.quant_matmul import quant_matmul


def quantize_acts(x: torch.Tensor, qm: int = 127):
    """Per-row symmetric activation quantization into an int8 carrier,
    clamped to ±qm = ±qmax(act_wl).

    The scale is `symmetric_scale` of the row absmax in x's dtype: for a
    bfloat16 x, absmax * float32(1/qm) rounded to bfloat16 (PyTorch's
    bfloat16 product with a scalar is the float32 one, rounded), which is
    what the reference's jitted step computes for its bfloat16
    `absmax / qm` (a multiply by the float32 reciprocal, then a convert to
    bfloat16 that XLA keeps), then widened to float32; the codes divide
    the bfloat16 x by it in float32, as the reference's promotion does."""
    sx = symmetric_scale(x.abs().amax(dim=-1, keepdim=True), qm)
    xq = torch.clamp(torch.round(x / sx), -qm, qm).to(torch.int8)
    return xq, sx


def _pad(x: torch.Tensor, rows: int, cols: int, value=0) -> torch.Tensor:
    """Zero- (or `value`-) pad the last two dims of a tensor up to (rows,
    cols)."""
    pr, pc = rows - x.shape[-2], cols - x.shape[-1]
    if pr == 0 and pc == 0:
        return x
    return F.pad(x, (0, pc, 0, pr), value=value)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _rows(x: torch.Tensor, w: QuantizedTensor, k: int) -> torch.Tensor:
    """x as the kernels' rows: (M, K), or (E, M, K) against an expert
    stack `w` (arrays (E, K, N))."""
    if w.values.ndim == 3:
        return x.reshape(w.values.shape[0], -1, k)
    return x.reshape(-1, k)


def qmm(x: torch.Tensor, w: QuantizedTensor, *, out_dtype=None
        ) -> torch.Tensor:
    """y = dequant(quant(x)) @ dequant(w): the WxAy dense linear.
    x (..., K) float; w QuantizedTensor (K, N) with per-column scales, or
    an expert stack (E, K, N) against x (E, ..., K)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, n = w.shape[-2:]
    xq, sx = quantize_acts(_rows(x, w, k), qmax(w.act_wl))
    sw = w.scale.reshape(*w.values.shape[:-2], 1, n)
    y = quant_matmul(*_qmm_args(xq, sx, w.values, sw, w.packed),
                     w_packed=w.packed, out_dtype=out_dtype)
    return y[..., :n].reshape(*lead, n)


def lrmm(x: torch.Tensor, lr: LowRankQ, *, out_dtype=None,
         fused: bool = True) -> torch.Tensor:
    """y = ((quant(x) @ W1') @ W2'): the ITERA low-rank linear.

    fused=True: the cascade kernel (T stays on chip). fused=False: the
    single-engine schedule, two quant_matmul launches with T in device
    memory between them (the engine comparison of the paper). Both give
    the same bits."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k, r = lr.w1.shape[-2:]
    n = lr.w2.shape[-1]
    e = lr.w1.values.shape[:-2]         # (E,) for an expert stack, else ()
    qm = qmax(lr.act_wl)
    xq, sx = quantize_acts(_rows(x, lr.w1, k), qm)
    s1 = lr.w1.scale.reshape(*e, 1, r)
    s2 = lr.w2.scale.reshape(*e, r, 1)
    w1v, w2v = lr.w1.values, lr.w2.values
    w1p, w2p = lr.w1.packed, lr.w2.packed
    if not fused:
        t = quant_matmul(*_qmm_args(xq, sx, w1v, s1, w1p),
                         w_packed=w1p)[..., :r]
        tq, st = quantize_acts(t * s2.transpose(-1, -2), qm)
        ones = torch.ones((*e, 1, n), dtype=torch.float32, device=x.device)
        y = quant_matmul(*_qmm_args(tq, st, w2v, ones, w2p), w_packed=w2p,
                         out_dtype=out_dtype)[..., :n]
        return y.reshape(*lead, n)
    y = lowrank_qmm(*_lrmm_args(xq, sx, w1v, s1, w2v, s2, w1p, w2p),
                    w1_packed=w1p, w2_packed=w2p, act_qmax=qm,
                    out_dtype=out_dtype)[..., :n]
    return y.reshape(*lead, n)


def _lrmm_args(xq, sx, w1v, s1, w2v, s2, w1p, w2p):
    """lowrank_qmm's arguments, padded for the CUDA kernel on CUDA (K to
    16, R and N to 32)."""
    if _on_cuda(xq):
        k = xq.shape[-1]
        r = s1.shape[-1]
        n = w2v.shape[-1] * 2 if w2p else w2v.shape[-1]
        kp, rp, np_ = _up(k, 16), _up(r, 32), _up(n, 32)
        xq = _pad(xq, xq.shape[-2], kp).contiguous()
        w1v = _pad(w1v, kp, rp // 2 if w1p else rp).contiguous()
        s1 = _pad(s1, 1, rp, 1.0).contiguous()
        w2v = _pad(w2v, rp, np_ // 2 if w2p else np_).contiguous()
        s2 = _pad(s2, rp, 1, 1.0).contiguous()
    return xq, sx, w1v, s1, w2v, s2


def _qmm_args(xq, sx, wv, sw, packed):
    """quant_matmul's arguments, padded for the CUDA kernel on CUDA."""
    if _on_cuda(xq):
        n = wv.shape[-1] * 2 if packed else wv.shape[-1]
        kp, np_ = _up(xq.shape[-1], 16), _up(n, 32)
        xq = _pad(xq, xq.shape[-2], kp).contiguous()
        wv = _pad(wv, kp, np_ // 2 if packed else np_).contiguous()
        sw = _pad(sw, 1, np_, 1.0).contiguous()
    return xq, sx, wv, sw


def _experts(w: QuantizedTensor) -> int:
    """Matrices in the node's stack: E for an expert stack, else 1."""
    return w.values.shape[0] if w.values.ndim == 3 else 1


def qmm_hbm_bytes(m: int, w: QuantizedTensor, out_bytes: int = 4) -> int:
    """Least device bytes one qmm launch moves for an (m, K) input (m rows
    for each expert of a stack): the int8 activations and their scales,
    the resident weight bytes (halved when packed) and scales, and the
    output (`out_bytes` an element: 4 fp32, 2 bfloat16), each once."""
    k, n = w.shape[-2:]
    return (_experts(w) * (m * k + m * 4 + m * n * out_bytes)
            + w.values.numel() + w.scale.numel() * 4)


def lrmm_hbm_bytes(m: int, lr: LowRankQ, out_bytes: int = 4) -> int:
    """Least device bytes one fused lrmm launch moves (m rows for each
    expert of a stack): activations, both resident factors and their
    scales, and the output (`out_bytes` an element), each once; the
    (m, R) intermediate never leaves the chip."""
    k = lr.w1.shape[-2]
    n = lr.w2.shape[-1]
    return (_experts(lr.w1) * (m * k + m * 4 + m * n * out_bytes)
            + lr.w1.values.numel() + lr.w2.values.numel()
            + (lr.w1.scale.numel() + lr.w2.scale.numel()) * 4)
