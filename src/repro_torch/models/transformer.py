"""Decoder-only LM (port of `repro.models.transformer`) in the dense,
mixture-of-experts (an MoE block, `models.moe`, in place of every
layer's MLP), attention-free Mamba ("ssm": Mamba1 blocks, falcon-mamba)
and hybrid ("hybrid": Mamba2 blocks, and one shared-weight attention +
MLP block after every `hybrid_period` of them, each invocation with its
own KV cache; zamba2) layouts: the whole-sequence `forward` (the
calibration pass SRA runs, and the training forward, each layer under
activation checkpointing when `cfg.remat`), the sequence-chunked
training loss (`loss_fn`), the rectangular path (`init_cache`, `prefill`
with its decode cache, `decode_step`) and, for dense and moe models, the
serving step over the blocked KV pool. Dense models may alternate local
(windowed, rolling cache) and global layers in pairs
(`local_global_period`, gemma2), as the reference's scan over pairs; the
blocked KV pool refuses them and the Mamba layouts, so they decode
rectangular.

Parameters are a plain dict of tensors with the reference's tree layout
and path names ("layers/attn/wq", "layers/mixer/in_proj",
"shared_block/mlp/up", "lm_head", ...): per-layer weights are stacked
along a leading L axis, as the reference's scan-stacked leaves, so
compression plans and checkpoints address the same paths in both
packages. The forward pass loops over layers in Python.

On a tensor-parallel engine (`api.engine`, `launch.sharding`) the serving
and rectangular steps run unchanged on one rank's slice: `cfg` is the
per-rank config (num_heads / tp query and num_kv_heads / tp KV heads),
the weights are sliced (the attention and MLP widths come from them),
the pool or decode cache holds the rank's heads, and each wo and down
all-reduces its partial (`layers.apply_linear(..., reduce_tp=True)`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import attention as attn
from repro_torch.models import mamba
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (add_norm, apply_linear, apply_norm,
                                       dtype_of,
                                       mlp_apply, sinusoidal_emb, softcap)
from repro_torch.runtime import sampling as smp
from repro_torch.runtime.kvblocks import check_paged_support


LAYOUTS = ("dense", "moe", "ssm", "hybrid")


def _check_layout(cfg) -> None:
    if cfg.layout not in LAYOUTS:
        raise NotImplementedError(f"layout {cfg.layout!r} is not ported yet")
    if cfg.layout in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(f"layout {cfg.layout!r} needs cfg.ssm")
    if cfg.layout == "hybrid" and cfg.num_layers % cfg.hybrid_period:
        raise ValueError(f"hybrid layers ({cfg.num_layers}) must be a "
                         f"multiple of hybrid_period ({cfg.hybrid_period})")


# ------------------------------------------------------------------ init --
def init_params(cfg, *, seed: int = 0, device="cpu"):
    """Random parameters of any layout from a torch generator on `device`
    (the same shapes and scales as the reference; not jax's numbers)."""
    _check_layout(cfg)
    dtype = dtype_of(cfg.dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    d, L = cfg.d_model, cfg.num_layers
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(*shape, std, dtype=dtype):
        return torch.randn(shape, generator=g, dtype=dtype,
                           device=device) * std

    def norm(*lead):
        if cfg.norm == "layernorm":
            return {"gamma": torch.ones((*lead, d), dtype=dtype, device=device),
                    "beta": torch.zeros((*lead, d), dtype=dtype,
                                        device=device)}
        return {"gamma": torch.zeros((*lead, d), dtype=dtype, device=device)}

    def dense_block(*lead):
        blk = {"ln1": norm(*lead),
               "attn": {"wq": normal(*lead, d, h * hd, std=d ** -0.5),
                        "wk": normal(*lead, d, hk * hd, std=d ** -0.5),
                        "wv": normal(*lead, d, hk * hd, std=d ** -0.5),
                        "wo": normal(*lead, h * hd, d,
                                     std=(h * hd) ** -0.5)},
               "ln2": norm(*lead)}
        if cfg.layout == "moe":
            blk["moe"] = moe_mod.moe_init(
                cfg, lambda *shape, **kw: normal(*lead, *shape, **kw))
            return blk
        mlp = {"up": normal(*lead, d, cfg.d_ff, std=d ** -0.5),
               "down": normal(*lead, cfg.d_ff, d, std=cfg.d_ff ** -0.5)}
        if cfg.mlp_act in ("swiglu", "geglu"):
            mlp["gate"] = normal(*lead, d, cfg.d_ff, std=d ** -0.5)
        blk["mlp"] = mlp
        return blk

    p = {"embed": normal(cfg.vocab_size, d, std=0.02), "final_norm": norm()}
    if cfg.layout in ("dense", "moe"):
        p["layers"] = dense_block(L)
    else:
        init = mamba.mamba1_init if cfg.ssm.version == 1 else \
            mamba.mamba2_init
        p["layers"] = {"ln": norm(L), "mixer": init(
            cfg, lambda *shape, **kw: normal(L, *shape, **kw),
            lambda t: t.to(device).expand(L, *t.shape).clone())}
        if cfg.layout == "hybrid":
            p["shared_block"] = dense_block()
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(d, cfg.vocab_size, std=d ** -0.5)
    return p


def _index(node, i: int):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    if isinstance(node, LowRankQ):
        return LowRankQ(_index(node.w1, i), _index(node.w2, i))
    if isinstance(node, QuantizedTensor):
        return dataclasses.replace(node, values=node.values[i],
                                   scale=node.scale[i])
    return node[i]


def _unstack(node, n: int) -> list:
    """A stacked tree as n per-layer trees. Dense tensors are unbound, so
    a gradient flows back to the stacked leaf as one stack of the
    layers' gradients."""
    if isinstance(node, dict):
        parts = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(node, torch.Tensor):
        return list(torch.unbind(node))
    return [_index(node, i) for i in range(n)]


def split_layers(params, num_layers: int):
    """`params` with its stacked "layers" tree split into a list of
    per-layer trees (views, no copies): what the engine hands the step
    so the per-layer slicing is done once."""
    return {**params, "layers": _unstack(params["layers"], num_layers)}


# --------------------------------------------------------------- forward --
def embed(params, tokens, cfg, pos0=0):
    """tokens (B, S) int, or precomputed embeddings (B, S, D) (the
    frontend stub, `data.pipeline.lift_to_embeddings`); pos0: the
    absolute position of tokens[:, 0], for the whole batch (a host int,
    or a 0-dim device tensor: rectangular decode) or one for each row (a
    (B,) int tensor: serving). Token embeddings are scaled by
    sqrt(d_model), except in the ssm layout."""
    dtype = dtype_of(cfg.dtype)
    if tokens.ndim == 3:
        h = tokens.to(dtype)
    else:
        h = params["embed"][tokens.long()]
        if cfg.layout != "ssm":
            h = h * _embed_scale(cfg.d_model, dtype)
    if cfg.pos_emb == "sinusoidal":
        ar = torch.arange(tokens.shape[1], device=h.device)
        if isinstance(pos0, torch.Tensor):
            pos = pos0.long()[..., None] + ar   # (B, S), or (S,) for all
        else:
            pos = int(pos0) + ar
        h = h + sinusoidal_emb(pos, cfg.d_model, dtype)
    return h


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype) -> float:
    """d_model ** 0.5 rounded to `dtype`, as a host scalar: a product with
    it is the product with the one-element tensor of that value, with no
    copy to the device inside a step."""
    return float(torch.tensor(d_model ** 0.5, dtype=dtype))


def _window_for_layer(cfg, which):
    """The attention window of a `which` ("local" or "global") layer:
    with the local/global pairing, `local_window` or None (global), else
    the config's `attn_window` in every layer."""
    if cfg.local_global_period:
        return cfg.local_window if which == "local" else None
    return cfg.attn_window


def _cache_slots(cfg) -> list:
    """(cache group, index in the group, window) of each layer: with the
    local/global pairing (the reference scans over pairs) even layers are
    "local" and odd ones "global", each group stacked over L / 2 layers;
    otherwise every layer is slot i of "kv"."""
    if cfg.local_global_period:
        if cfg.num_layers % 2:
            raise ValueError(f"local/global pairs need an even number of "
                             f"layers, got {cfg.num_layers}")
        return [("global", i // 2, _window_for_layer(cfg, "global"))
                if i % 2 else
                ("local", i // 2, _window_for_layer(cfg, "local"))
                for i in range(cfg.num_layers)]
    return [("kv", i, cfg.attn_window) for i in range(cfg.num_layers)]


def _layer_list(params, cfg) -> list:
    """Per-layer trees, from the stacked tree or an engine's split one."""
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = split_layers(params, cfg.num_layers)["layers"]
    return layers


def _ffn(cfg, lp, hn):
    """The layer's MLP, or its MoE block: (y, aux loss; 0.0 for an
    MLP)."""
    if "moe" in lp:
        return moe_mod.moe_apply(lp["moe"], hn, cfg)
    return mlp_apply(hn, lp["mlp"], cfg.mlp_act), 0.0


def _next_ln(cfg, layers, i):
    """The first norm's parameters of layer i + 1 where it is the global
    half of layer i's local/global pair, else None. The reference scans
    over pairs, so within one iteration XLA feeds that norm the unrounded
    sum of layer i's last residual add, as it does the norm after each
    attention (`add_norm`, C8); between iterations the carry is
    rounded."""
    if cfg.local_global_period and i % 2 == 0:
        return layers[i + 1]["ln1"]
    return None


def _dense_body(cfg, h, lp, hn=None, next_ln=None, *, window,
                return_kv=False):
    """One attention + MLP (or MoE) block: (h, aux, the next block's
    first norm or None[, (k, v)]). `hn`: this block's first norm when the
    previous block computed it (from `next_ln`, its parameters)."""
    if hn is None:
        hn = apply_norm(h, lp["ln1"], cfg.norm, cfg.norm_eps)
    a = attn.attention(lp["attn"], hn, cfg, window=window,
                       return_kv=return_kv)
    if return_kv:
        a, kv = a
    h, hn = add_norm(h, a, lp["ln2"], cfg.norm, cfg.norm_eps)
    y, aux = _ffn(cfg, lp, hn)
    h, hn = _residual(cfg, h, y, next_ln)
    return (h, aux, hn, kv) if return_kv else (h, aux, hn)


def _residual(cfg, h, y, next_ln):
    """(h + y, the next block's first norm of it when `next_ln` is given,
    else None)."""
    if next_ln is None:
        return h + y, None
    return add_norm(h, y, next_ln, cfg.norm, cfg.norm_eps)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the linears' matmuls (no
    batch dimensions, as jax's `dots_with_no_batch_dims_saveable`), and
    recompute the rest in the backward pass."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg, fn):
    """fn under activation checkpointing when `cfg.remat` and gradients
    are being recorded: "full" keeps only the layer's inputs and
    recomputes the layer in the backward pass, "dots" also keeps its
    matmul outputs."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be full|dots, got "
                         f"{cfg.remat_policy!r}")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw,
                               **kwargs)

    return run


def _mamba_order(cfg) -> list:
    """The ssm and hybrid layouts' blocks in order: ("mamba", layer) for
    each layer, and in the hybrid layout ("shared", invocation) after
    every `hybrid_period` layers -- the shared block, whose invocation g
    has KV cache g."""
    out = []
    for i in range(cfg.num_layers):
        out.append(("mamba", i))
        if cfg.layout == "hybrid" and (i + 1) % cfg.hybrid_period == 0:
            out.append(("shared", i // cfg.hybrid_period))
    return out


def _mamba_body(cfg, h, lp, *, engine, return_state=False):
    """One Mamba block over whole sequences: h + mixer(norm(h)) (and the
    block's decode cache)."""
    hn = apply_norm(h, lp["ln"], cfg.norm, cfg.norm_eps)
    pre = mamba.mamba1_prefill if cfg.ssm.version == 1 else \
        mamba.mamba2_prefill
    y, state = pre(lp["mixer"], hn, cfg, engine=engine)
    return (h + y, state) if return_state else h + y


def forward(params, tokens, cfg, *, ssm_engine="sequential"):
    """Whole sequences through the model: tokens (B, S) int (or
    embeddings (B, S, D)) -> (final-normed hidden (B, S, D), aux loss:
    the MoE blocks' load-balance losses summed over layers from 0.0, or
    0.0 in the other layouts). Layers attend causally within
    `cfg.attn_window`, or, paired, within `local_window` (even layers) and
    over the whole sequence (odd ones). The Mamba blocks scan with
    `ssm_engine` ("sequential" or "chunked")."""
    _check_layout(cfg)
    h = embed(params, tokens, cfg)
    layers = _layer_list(params, cfg)
    if cfg.layout in ("ssm", "hybrid"):
        body = _maybe_remat(cfg, functools.partial(_mamba_body,
                                                   engine=ssm_engine))
        shared = _maybe_remat(cfg, _dense_body)
        for kind, i in _mamba_order(cfg):
            if kind == "mamba":
                h = body(cfg, h, layers[i])
            else:
                h = shared(cfg, h, params["shared_block"],
                           window=cfg.attn_window)[0]
        return apply_norm(h, params["final_norm"], cfg.norm,
                          cfg.norm_eps), 0.0
    body = _maybe_remat(cfg, _dense_body)
    aux, hn = 0.0, None
    for i, (lp, (_, _, window)) in enumerate(zip(layers, _cache_slots(cfg))):
        h, a, hn = body(cfg, h, lp, hn, _next_ln(cfg, layers, i),
                        window=window)
        aux = aux + a
    return apply_norm(h, params["final_norm"], cfg.norm, cfg.norm_eps), aux


def lm_head_weight(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_for(params, h, cfg):
    out = apply_linear(h, lm_head_weight(params, cfg), out_dtype=torch.float32)
    return softcap(out, cfg.final_softcap)


# ------------------------------------------------------------------ loss --
def _chunk_loss(hc, yc, w, cap):
    """sum(lse - gold) over one chunk (B, c, D) of positions, float32."""
    logits = softcap(apply_linear(hc, w, out_dtype=torch.float32), cap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_loss(params, h, labels, cfg):
    """Mean token cross-entropy over sequence chunks of `cfg.loss_chunk`
    positions (the largest divisor of S at most that), each chunk's
    logits recomputed in the backward pass, so the (B, S, V) logits never
    exist whole. The chunks' sums accumulate in order from 0.0, in
    float32, as the reference's scan."""
    b, s, _ = h.shape
    c = min(cfg.loss_chunk, s)
    while s % c:
        c -= 1
    w = lm_head_weight(params, cfg)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        args = (h[:, i:i + c], labels[:, i:i + c], w, cfg.final_softcap)
        if torch.is_grad_enabled():
            part = ckpt.checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            part = _chunk_loss(*args)
        total = total + part
    return total / (b * s)


def loss_fn(params, batch, cfg, *, aux_weight=0.01,
            ssm_engine="sequential"):
    """(ce + aux_weight * aux, {"ce", "aux"}) of a batch {"tokens" or
    "inputs_embeds", "labels"}; aux is the MoE load-balance loss, 0.0 in
    the other layouts."""
    inputs = batch.get("inputs_embeds", batch.get("tokens"))
    h, aux = forward(params, inputs, cfg, ssm_engine=ssm_engine)
    ce = chunked_loss(params, h, batch["labels"], cfg)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------- rectangular decode --
def init_cache(cfg, batch, max_len, dtype=None, device="cpu"):
    """An empty decode cache {"kv": {"k", "v"[, "ks", "vs"]}}, each leaf
    stacked over layers: (L, B, size, Hk, *), size max_len, or
    min(attn_window, max_len) for a rolling cache. With the local/global
    pairing, {"local": ..., "global": ...}, each stacked over L / 2
    layers, the local one rolling over min(local_window, max_len)
    slots. The ssm layout's is {"ssm": {"h", "conv"}}, the Mamba blocks'
    states (L, B, ...) in float32 and their conv tails (L, B, d_conv - 1,
    Di) in `dtype`; the hybrid layout's also holds "shared_kv", one KV
    cache for each invocation of the shared block (L / hybrid_period of
    them)."""
    _check_layout(cfg)
    if cfg.layout in ("ssm", "hybrid"):
        return _mamba_init_cache(cfg, batch, max_len, dtype, device)
    groups = {}
    for group, _, window in _cache_slots(cfg):
        groups.setdefault(group, [0, window])[0] += 1
    return {group: _repeated(n, attn.init_kv_cache(
                cfg, batch, max_len, window=window, dtype=dtype,
                device=device))
            for group, (n, window) in groups.items()}


def _repeated(n: int, tree: dict) -> dict:
    """Each leaf of `tree` repeated along a new leading axis of n."""
    return {k: v[None].repeat(n, *([1] * v.ndim)) for k, v in tree.items()}


def _mamba_init_cache(cfg, batch, max_len, dtype, device):
    dtype = dtype or dtype_of(cfg.dtype)
    init = (mamba.mamba1_init_cache if cfg.ssm.version == 1
            else mamba.mamba2_init_cache)
    out = {"ssm": _repeated(cfg.num_layers, init(cfg, batch, dtype, device))}
    if cfg.layout == "hybrid":
        kv = attn.init_kv_cache(cfg, batch, max_len, window=cfg.attn_window,
                                dtype=dtype, device=device)
        out["shared_kv"] = _repeated(cfg.num_layers // cfg.hybrid_period, kv)
    return out


def _stacked(per_layer: list) -> dict:
    """Per-layer caches (dicts of tensors) as one dict of stacked
    leaves."""
    return {name: torch.stack([c[name] for c in per_layer])
            for name in per_layer[0]}


def prefill(params, tokens, cfg, *, max_len=None, cache_dtype=None,
            last_pos=None, ssm_engine="sequential"):
    """A (B, S) prompt batch through every layer at once: returns (logits
    (B, 1, V) f32 of one position, the decode cache for positions 0..S-1
    in `max_len` (default S) slots, as `init_cache` lays it out).

    last_pos: the position whose logits come back (default S - 1). Prompts
    right-padded to a length bucket pass their true last position; the
    pad positions' K/V sit in slots no decode query reaches before
    `decode_step` overwrites them. A Mamba block's state would take the
    pads in, so the ssm and hybrid layouts take exact-length prompts; their
    blocks scan with `ssm_engine`."""
    _check_layout(cfg)
    cdt = cache_dtype or dtype_of(cfg.dtype)
    h = embed(params, tokens, cfg)
    caches: dict = {}
    hn = None
    layers = _layer_list(params, cfg)

    def kv_cache(k, v, window):
        return attn.build_cache_from_kv(k, v, window=window, max_len=max_len,
                                        dtype=cdt,
                                        quantized=cfg.kv_cache_bits == 8)

    if cfg.layout in ("ssm", "hybrid"):
        for kind, i in _mamba_order(cfg):
            if kind == "mamba":
                h, state = _mamba_body(cfg, h, layers[i], engine=ssm_engine,
                                       return_state=True)
                caches.setdefault("ssm", []).append(state)
            else:
                h, _, _, (k, v) = _dense_body(cfg, h, params["shared_block"],
                                              window=cfg.attn_window,
                                              return_kv=True)
                caches.setdefault("shared_kv", []).append(
                    kv_cache(k, v, cfg.attn_window))
    else:
        for i, (lp, (group, _, window)) in enumerate(zip(layers,
                                                         _cache_slots(cfg))):
            h, _, hn, (k, v) = _dense_body(cfg, h, lp, hn,
                                           _next_ln(cfg, layers, i),
                                           window=window, return_kv=True)
            caches.setdefault(group, []).append(kv_cache(k, v, window))
    cache = {group: _stacked(per_layer)
             for group, per_layer in caches.items()}
    h = apply_norm(h, params["final_norm"], cfg.norm, cfg.norm_eps)
    last = h.shape[1] - 1 if last_pos is None else int(last_pos)
    return logits_for(params, h[:, last:last + 1], cfg), cache


def decode_step(params, cache, tokens, pos, cfg):
    """One decode step for the whole batch at position `pos`: a 0-dim int
    device tensor (the reference's traced position, so one captured step
    serves every position) or a host int, which becomes one. tokens (B, 1)
    int; the cache is updated in place (a Mamba block's state and conv
    tail too). Returns (logits (B, 1, V) f32, cache)."""
    _check_layout(cfg)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.long, device=tokens.device)
    h = embed(params, tokens, cfg, pos)
    hn = None
    layers = _layer_list(params, cfg)

    def dense_step(h, hn, lp, kv, window, next_ln):
        if hn is None:
            hn = apply_norm(h, lp["ln1"], cfg.norm, cfg.norm_eps)
        a, _ = attn.decode_attention(lp["attn"], hn, kv, pos, cfg,
                                     window=window)
        h, hn = add_norm(h, a, lp["ln2"], cfg.norm, cfg.norm_eps)
        return _residual(cfg, h, _ffn(cfg, lp, hn)[0], next_ln)

    if cfg.layout in ("ssm", "hybrid"):
        step = mamba.mamba1_step if cfg.ssm.version == 1 else \
            mamba.mamba2_step
        for kind, i in _mamba_order(cfg):
            if kind == "shared":
                h, _ = dense_step(h, None, params["shared_block"],
                                  {k: v[i] for k, v in
                                   cache["shared_kv"].items()},
                                  cfg.attn_window, None)
                continue
            lp = layers[i]
            hn = apply_norm(h, lp["ln"], cfg.norm, cfg.norm_eps)
            y, state = step(lp["mixer"], hn,
                            {k: v[i] for k, v in cache["ssm"].items()}, cfg)
            for k, v in state.items():
                cache["ssm"][k][i].copy_(v)
            h = h + y
    else:
        for j, (lp, (group, i, window)) in enumerate(zip(layers,
                                                         _cache_slots(cfg))):
            h, hn = dense_step(h, hn, lp,
                               {k: v[i] for k, v in cache[group].items()},
                               window, _next_ln(cfg, layers, j))
    h = apply_norm(h, params["final_norm"], cfg.norm, cfg.norm_eps)
    return logits_for(params, h, cfg), cache


def unified_step(params, pool, block_tables, ctx_lens, q_lens, inputs, cfg,
                 verify_width: int = 0):
    """ONE token-budget serving step over the blocked KV pool: row r
    advances by a span of q_lens[r] tokens (a prefill chunk, one decode
    token, or nothing). inputs (B, W) int tokens; block_tables (B, MB)
    int32; ctx_lens, q_lens (B,) int32; pool from
    `runtime.kvblocks.init_paged_cache`, updated in place. Returns
    (logits (B, 1, V) f32 at each row's last valid span position, pool).
    Idle rows compute garbage the caller discards.

    verify_width > 0 is the speculative verify mode
    (`runtime.speculation`): the logits of span positions
    0..verify_width-1 come first, then each row's last valid position,
    (B, verify_width + 1, V), so the lm head runs on verify_width + 1
    positions whatever W is."""
    check_paged_support(cfg)
    h = embed(params, inputs, cfg, ctx_lens)
    for i, lp in enumerate(_layer_list(params, cfg)):
        pl = {k: v[i] for k, v in pool.items()}
        hn = apply_norm(h, lp["ln1"], cfg.norm, cfg.norm_eps)
        a, _ = attn.span_attention_paged(lp["attn"], hn, pl, block_tables,
                                         ctx_lens, q_lens, cfg)
        h, hn = add_norm(h, a, lp["ln2"], cfg.norm, cfg.norm_eps)
        h = h + _ffn(cfg, lp, hn)[0]
    h = apply_norm(h, params["final_norm"], cfg.norm, cfg.norm_eps)
    last = torch.clamp(q_lens.long() - 1, min=0)
    h1 = h[torch.arange(h.shape[0], device=h.device), last][:, None]
    if verify_width:
        if verify_width > h.shape[1]:
            raise ValueError(f"verify_width {verify_width} exceeds span "
                             f"width {h.shape[1]}")
        h1 = torch.cat([h[:, :verify_width], h1], dim=1)
    return logits_for(params, h1, cfg), pool


def serve_step(params, pool, block_tables, step_buf, prev, recent,
               stop_seqs, cfg, *, sample: bool = False, stop: bool = False):
    """One serving dispatch: `unified_step`, then the token and the stop
    mask (`runtime.sampling`).

    step_buf (B, W + 3 + SAMP_COLS) int32: span tokens (B, W), the
    scheduling columns (ctx_lens, q_lens, use_prev), then each row's
    packed sampling/stop metadata. Decode rows take their first token
    from `prev`, the previous step's device-resident tokens, so token
    values never round-trip through the host. `recent` (B, S) is the
    ring of each row's last S tokens and `stop_seqs` (B, NS, S) its stop
    sequences, both on the device.

    `sample` and `stop` are fixed for a serve call: with neither, this
    is the greedy step (argmax, the first maximum; no top-k, no PRNG, no
    ring), with the same launches. With `sample`, rows with temperature
    <= 0 still take the argmax. Returns (toks (B, 1) int32, finished
    (B,) int32 or None without `stop`, recent, pool)."""
    m = smp.SAMP_COLS
    tokens = step_buf[:, :-(3 + m)]
    ctx_lens = step_buf[:, -(3 + m)].contiguous()
    q_lens = step_buf[:, -(2 + m)].contiguous()
    use_prev = step_buf[:, -(1 + m)].bool()
    first = torch.where(use_prev, prev[:, 0], tokens[:, 0])
    tokens = torch.cat([first[:, None], tokens[:, 1:]], dim=1)
    logits, pool = unified_step(params, pool, block_tables, ctx_lens, q_lens,
                                tokens, cfg)
    last = logits[:, -1]
    if sample:
        sp = smp.unpack_meta(step_buf)
        keys = smp.row_keys(sp["seed"], sp["rid"], sp["counter"])
        toks = smp.sample_tokens(last, sp["temperature"], sp["top_k"],
                                 sp["top_p"], keys)[:, None]
    else:
        toks = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    fin = None
    if stop:
        sp = smp.unpack_meta(step_buf)
        recent = smp.push_recent(recent, toks)
        fin = smp.finished_mask(toks[:, 0], recent, sp, stop_seqs)
    return toks, fin, recent, pool
