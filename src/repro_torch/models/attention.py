"""Serving attention over the blocked KV pool (port of the paged half of
`repro.models.attention`).

`span_attention_paged` scatters each row's span K/V into the pool FIRST,
then attends over the row's block-table view under the causal mask
`slot <= ctx + i`, so queries see the pool prefix and the earlier tokens
of their own span. The attention itself is `kernels.paged_attention`:
the CUDA kernel on CUDA tensors, the gather oracle on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import symmetric_scale
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention import (  # noqa: F401 (re-export)
    span_attend_gather as _span_attend_gather,
)
from repro_torch.models.layers import apply_linear, apply_rope
from repro_torch.runtime.kvblocks import span_slots


def _quant_kv(x):
    """Per-(token, head) symmetric int8 quantization of K/V rows."""
    xf = x.to(torch.float32)
    scale = symmetric_scale(xf.abs().amax(dim=-1, keepdim=True), 127)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _fake_quant_kv(x):
    """quantize -> dequantize round trip: the values an int8 KV cache hands
    back, in x's dtype."""
    q, scale = _quant_kv(x)
    return (q.to(torch.float32) * scale).to(x.dtype)


def span_attention_paged(params, x, pool, block_table, ctx_lens, q_lens,
                         cfg):
    """Variable-width query spans against ONE layer's blocked KV pool.

    x (B, W, D), row r valid in [:q_lens[r]]; pool {"k","v"[,"ks","vs"]}
    with leaves (NB, bs, Hk, *), updated IN PLACE; block_table (B, MB)
    int32 physical block ids padded with the trash block 0; ctx_lens
    (B,) int32 tokens already in the pool == the position of x[:, 0].
    Span token (r, i) is written to (block_table[r, p // bs], p % bs) for
    p = ctx_lens[r] + i; pad slots and idle rows write the trash block.
    Returns (y (B, W, D), pool)."""
    b, w, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bs = pool["k"].shape[1]

    q = apply_linear(x, params["wq"]).reshape(b, w, h, hd)
    k = apply_linear(x, params["wk"]).reshape(b, w, hk, hd)
    v = apply_linear(x, params["wv"]).reshape(b, w, hk, hd)
    if cfg.pos_emb == "rope":
        pos = ctx_lens.long()[:, None] + torch.arange(w, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rotary_pct)

    blk, off = span_slots(block_table, ctx_lens, q_lens, w, bs)
    if "ks" in pool:
        kq, ks1 = _quant_kv(k)
        vq, vs1 = _quant_kv(v)
        pool["k"][blk, off] = kq
        pool["v"][blk, off] = vq
        pool["ks"][blk, off] = ks1
        pool["vs"][blk, off] = vs1
    else:
        pool["k"][blk, off] = k.to(pool["k"].dtype)
        pool["v"][blk, off] = v.to(pool["v"].dtype)

    o = paged_attention(q.contiguous(), pool, block_table, ctx_lens, q_lens,
                        logit_softcap=cfg.logit_softcap)
    y = apply_linear(o.reshape(b, w, h * hd), params["wo"])
    return y, pool
