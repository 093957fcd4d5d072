"""Attention (port of `repro.models.attention`): causal self-attention over
whole sequences (the calibration forward, and prefill with its K/V), the
rectangular decode cache and one-token decode against it, and serving
attention over the blocked KV pool.

`attention` is the reference's monolithic causal attention (GQA grouped,
RoPE, sliding window, logit soft-capping): "full" takes one masked
softmax over the sequence, "chunked" a q-block loop that materializes
only the kv blocks each q block can see; "auto" picks chunked above 2048
tokens, as the reference. The reference computes it in jnp outside any
kernel, so it is plain PyTorch here, in float64 (scores, softmax and the
weighted sum), as the paged oracle and the norms are: the card and the
CPU then very likely round to the same float32, where float32 sums in
different orders would flip int8 activation codes of the next linear.
The reference takes it in float32, within about 1e-5 of this. A
bfloat16 model's attention keeps the reference's rounding points instead
(`kernels.paged_attention.attend_bf16`: scores rounded to float32, p to
bfloat16 before the PV product, the output to bfloat16), float64 between
them.

The rectangular path keeps one contiguous cache per layer, (B, size, Hk,
Dh), laid out by `build_cache_from_kv` from prefill's K/V: slot i holds
position i, or, under a sliding window w, slot p mod w the last w
positions (a rolling cache). `decode_attention` writes one token into it
and attends over it, in plain PyTorch as the reference computes it in jnp
outside any kernel, at a position held on the device; int8 caches hold
codes and per-(token, head) fp32 scales, dequantized in float32 as the
reference's and then widened.

`span_attention_paged` scatters each row's span K/V into the pool FIRST,
then attends over the row's block-table view under the causal mask
`slot <= ctx + i`, so queries see the pool prefix and the earlier tokens
of their own span. The attention itself is `kernels.paged_attention`:
the CUDA kernel on CUDA tensors, the gather oracle on CPU tensors.

Every `wo` is a tensor-parallel reduction site (`apply_linear(...,
reduce_tp=True)`): on one rank's heads it is a partial sum, all-reduced
when a TP group is bound and untouched otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import symmetric_scale
from repro_torch.kernels.paged_attention import (NEG, attend_bf16,
                                                 paged_attention)
from repro_torch.kernels.paged_attention import (  # noqa: F401 (re-export)
    span_attend_gather as _span_attend_gather,
)
from repro_torch.models.layers import (apply_linear, apply_rope, dtype_of,
                                       softcap)
from repro_torch.runtime.kvblocks import span_slots


def _group_q(q, hk):
    """(B, S, H, Dh) -> (B, S, Hk, G, Dh): group q heads by kv head (K/V
    are never repeated to H heads)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, hk, h // hk, d)


def _scores(q, k, cap):
    """q: (B, Sq, Hk, G, Dh); k: (B, Sk, Hk, Dh) -> (B, Hk, G, Sq, Sk)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k) * (q.shape[-1] ** -0.5)
    return softcap(s, cap)


def _attend_block(q, k, v, mask, cap):
    """q grouped (B, Sq, Hk, G, Dh); k/v (B, Sk, Hk, Dh); mask (..., Sq,
    Sk) -> (B, Sq, H, Dh), in the inputs' dtype: float64, or bfloat16 at
    the reference's rounding points (`attend_bf16`)."""
    if q.dtype == torch.bfloat16:
        o = attend_bf16(q, k, v, mask, cap)
    else:
        s = torch.where(mask, _scores(q, k, cap), NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    b, sq, hk, g, d = o.shape
    return o.reshape(b, sq, hk * g, d)


def _wide(t):
    """What `_attend_block` takes: float64, or a bfloat16 model's own
    bfloat16 values."""
    return t if t.dtype == torch.bfloat16 else t.to(torch.float64)


def _causal_mask(q_pos, k_pos, window):
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def attention(params, x, cfg, *, window=None, positions=None,
              return_kv=False):
    """Causal self-attention over whole sequences. x: (B, S, D) -> (B, S,
    D). `window` bounds how far back a query sees (sliding window);
    `positions` (S,) defaults to 0..S-1.

    return_kv=True also returns the post-RoPE (k, v), each (B, S, Hk, Dh)
    in x's dtype: prefill lays the decode cache out from them. With
    cfg.kv_cache_bits == 8 attention then runs over their int8 round trip
    (`_fake_quant_kv`), the values decode reads back from the int8 cache,
    while the returned (k, v) stay full precision."""
    b, s, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)

    q = apply_linear(x, params["wq"]).reshape(b, s, h, hd)
    k = apply_linear(x, params["wk"]).reshape(b, s, hk, hd)
    v = apply_linear(x, params["wv"]).reshape(b, s, hk, hd)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    kv = (k, v)
    if return_kv and cfg.kv_cache_bits == 8:
        k, v = _fake_quant_kv(k), _fake_quant_kv(v)
    qg = _group_q(_wide(q), hk)
    k, v = _wide(k), _wide(v)

    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if s > 2048 else "full"
    if impl == "full":
        mask = _causal_mask(positions, positions, window)[None, None, None]
        o = _attend_block(qg, k, v, mask, cfg.logit_softcap)
    elif impl == "chunked":
        o = _chunked_causal(qg, k, v, positions, window, cfg)
    else:
        raise ValueError(f"attn_impl must be auto|full|chunked, got {impl!r}")
    y = apply_linear(o.to(x.dtype).reshape(b, s, h * hd), params["wo"],
                     reduce_tp=True)
    return (y, kv) if return_kv else y


def _chunked_causal(q, k, v, positions, window, cfg):
    """Flash-style q-block loop with static block skipping: q block i
    attends only to kv blocks [lo_i, i], lo_i 0 (causal) or the first
    block inside the window, so the work is triangular (or banded), not
    rectangular. q is grouped (B, S, Hk, G, Dh); k/v are (B, S, Hk,
    Dh)."""
    s = q.shape[1]
    c = min(cfg.attn_chunk, s)
    nb = (s + c - 1) // c
    outs = []
    for i in range(nb):
        q_sl = slice(i * c, min((i + 1) * c, s))
        lo = 0
        if window is not None:
            lo = max(0, (i * c - window) // c)
        k_sl = slice(lo * c, min((i + 1) * c, s))
        mask = _causal_mask(positions[q_sl], positions[k_sl],
                            window)[None, None, None]
        outs.append(_attend_block(q[:, q_sl], k[:, k_sl], v[:, k_sl], mask,
                                  cfg.logit_softcap))
    return torch.cat(outs, dim=1)


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


# ------------------------------------------------------------------ cache --
def build_cache_from_kv(k, v, *, window=None, max_len=None, dtype=None,
                        quantized=False):
    """Lay prefill's (k, v), each (B, S, Hk, Dh), out as a decode cache.

    Without a window slot i holds position i, in a cache of max_len >= S
    slots (default S). With a window w the cache has min(w, max_len or S)
    slots and the last of them positions land at slot p mod size, as
    `decode_attention` writes them. quantized=True stores int8 codes and
    per-(token, head) fp32 scales ("ks", "vs"); slots no position fills
    hold zero codes, and scale 1."""
    b, s, hk, _ = k.shape
    dtype = dtype or k.dtype
    if quantized:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        parts = {"k": (kq, torch.int8), "v": (vq, torch.int8),
                 "ks": (ks, torch.float32), "vs": (vs, torch.float32)}
    else:
        parts = {"k": (k, dtype), "v": (v, dtype)}

    def layout(x, fill_dtype):
        fill = 1 if x.shape[-1] == 1 else 0
        size = min(window, max_len or s) if window else max_len or s
        out = torch.full((b, size, hk, x.shape[-1]), fill, dtype=fill_dtype,
                         device=x.device)
        if window:
            take = min(size, s)
            slots = ((s - take) + torch.arange(take, device=x.device)) % size
            out[:, slots] = x[:, s - take:].to(fill_dtype)
        else:
            out[:, :s] = x.to(fill_dtype)
        return out

    return {name: layout(x, dt) for name, (x, dt) in parts.items()}


def init_kv_cache(cfg, batch, max_len, *, window=None, dtype=None,
                  device="cpu"):
    """An empty decode cache for one attention site: max_len slots, or
    min(window, max_len) rolling ones under a window. cfg.kv_cache_bits
    == 8 gives int8 codes and fp32 scales (initialised to 1)."""
    dtype = dtype or dtype_of(cfg.dtype)
    size = min(window, max_len) if window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_bits == 8:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.ones(sshape, dtype=torch.float32, device=device),
                "vs": torch.ones(sshape, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x1, cache, pos, cfg, *, window=None):
    """One-token decode at position `pos`, the same for every row: a 0-dim
    int device tensor (the reference's traced position; nothing of it is
    read on the host, so the step can be captured once and replayed at
    every position) or a host int, which becomes one. x1 (B, 1, D); cache
    from `build_cache_from_kv` or `init_kv_cache`, updated IN PLACE: the
    token's K/V go to slot pos mod size under a window (rolling), else
    min(pos, size - 1). Attention covers the slots that hold positions
    <= pos (within the window). Returns (y (B, 1, D), cache)."""
    b = x1.shape[0]
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    size = cache["k"].shape[1]
    dev = x1.device
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.long, device=dev)
    pos = pos.long()

    q = apply_linear(x1, params["wq"]).reshape(b, 1, h, hd)
    k = apply_linear(x1, params["wk"]).reshape(b, 1, hk, hd)
    v = apply_linear(x1, params["wv"]).reshape(b, 1, hk, hd)
    if cfg.pos_emb == "rope":
        p1 = pos.reshape(1)
        q = apply_rope(q, p1, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, p1, cfg.rope_theta, cfg.rotary_pct)

    slot = pos % size if window else torch.clamp(pos, max=size - 1)
    at = slot.reshape(1)
    if "ks" in cache:
        kq, ks1 = _quant_kv(k)
        vq, vs1 = _quant_kv(v)
        for name, x in (("k", kq), ("v", vq), ("ks", ks1), ("vs", vs1)):
            cache[name].index_copy_(1, at, x)
        # the reference's dequantization, code.astype(q.dtype) *
        # scale.astype(q.dtype)
        ck = cache["k"].to(q.dtype) * cache["ks"].to(q.dtype)
        cv = cache["v"].to(q.dtype) * cache["vs"].to(q.dtype)
    else:
        cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        ck, cv = cache["k"], cache["v"]

    # the position each physical slot holds (rolling-aware)
    idx = torch.arange(size, device=dev)
    if window:
        n_wraps = (pos + size) // size
        slot_pos = torch.where(idx <= slot, idx + (n_wraps - 1) * size,
                               idx + (n_wraps - 2) * size)
        valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - size)
    else:
        valid = idx <= slot

    qg = _group_q(_wide(q), hk)
    o = _attend_block(qg, _wide(ck.to(q.dtype)), _wide(cv.to(q.dtype)),
                      valid[None, None, None, None, :], cfg.logit_softcap)
    y = apply_linear(o.to(x1.dtype).reshape(b, 1, h * hd), params["wo"],
                     reduce_tp=True)
    return y, cache


def _scatter_span(pool, blk, off, new):
    """pool[key][blk, off] = new[key] for the (B, W) span slots of
    `span_slots`. Real slots are distinct; every pad slot targets the
    trash slot (0, 0), and there the last pad slot in (B, W) order wins,
    as in the reference's scatter on its CPU. A scatter with repeated
    targets keeps any one of them on the card (and on the CPU past a
    size), and attention reads the trash block at positions past q_lens,
    so the winner is written again, by a device-side index."""
    pad = (blk == 0).reshape(-1)
    order = torch.arange(pad.numel(), device=pad.device)
    last = torch.where(pad, order, torch.full_like(order, -1)).max()
    pick = last.clamp(min=0).reshape(1)
    for key, val in new.items():
        leaf = pool[key]
        leaf[blk, off] = val
        winner = torch.index_select(
            val.reshape(pad.numel(), *val.shape[2:]), 0, pick)[0]
        leaf[0, 0] = torch.where(last >= 0, winner, leaf[0, 0])


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
        new = {"k": kq, "v": vq, "ks": ks1, "vs": vs1}
    else:
        new = {"k": k.to(pool["k"].dtype), "v": v.to(pool["v"].dtype)}
    _scatter_span(pool, blk, off, new)

    o = paged_attention(q.contiguous(), pool, block_table, ctx_lens,
                        logit_softcap=cfg.logit_softcap)
    y = apply_linear(o.reshape(b, w, h * hd), params["wo"], reduce_tp=True)
    return y, pool
