"""Mixture-of-Experts block (port of `repro.models.moe`): top-k routing
with capacity-bounded scatter/gather dispatch, shared (always-on) experts
(DeepSeek-MoE), and the Switch load-balance aux loss.

Tokens are scattered into per-expert buffers (E, C, D) whose positions
come from a cumsum over the routing mask, in the flattened (B, S) order:
every position routes, padding and idle serving rows included, and an
earlier position takes an expert's slot before a later one, so a token's
output depends on what shares its step. The experts then run as stacked
linears, one kernel launch for each projection of all E experts
(`kernels.ops`), as the reference's vmap over the stacks does.

Nothing here reads a value back to the host: the capacity is a Python
int from the static shape, and the scatter and gather are index_add_ and
index_select over device indices, so a captured step (`runtime.graphs`)
may run it. Expert parallelism (the reference's sharding hints) is not
ported.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import mlp_apply
from repro_torch.runtime.sampling import lax_top_k


def moe_init(cfg, normal) -> dict:
    """Parameters of one MoE block, each leaf with the leading dims
    `normal` adds (the stacked layers): `normal(*shape, std=...)` draws
    them. The reference's shapes and scales: routed expert stacks (E, K,
    N), a float32 router (D, E), and the shared experts as one MLP of
    width d_ff * num_shared."""
    d, f, m = cfg.d_model, cfg.d_ff, cfg.moe
    e = m.num_experts
    mats = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    shapes = {"up": (d, f), "down": (f, d), "gate": (d, f)}
    experts = {n: normal(e, *shapes[n], std=shapes[n][0] ** -0.5)
               for n in ["up", "down", "gate"][:mats]}
    p = {"router": normal(d, e, std=d ** -0.5, dtype=torch.float32),
         "experts": experts}
    if m.num_shared:
        fs = f * m.num_shared
        p["shared"] = {"up": normal(d, fs, std=d ** -0.5),
                       "down": normal(fs, d, std=fs ** -0.5)}
        if mats == 3:
            p["shared"]["gate"] = normal(d, fs, std=d ** -0.5)
    return p


def capacity_for(tokens: int, cfg) -> int:
    """Slots per expert for a step of `tokens` positions: the reference's
    `max(1, int(t * k * capacity_factor / e))`, the same Python float
    expression, rounded up to a multiple of 512 above 512."""
    m = cfg.moe
    cap = max(1, int(tokens * m.top_k * m.capacity_factor / m.num_experts))
    if cap > 512:
        cap = -(-cap // 512) * 512
    return cap


def route(params, xt, cfg, capacity: int):
    """Routing of the (T, D) tokens: (probs (T, E) f32, gates (T, k) f32,
    expert ids (T, k), routing mask (T, E), target rows (T, k) of the
    (E * C + 1, D) buffer, E * C the dump row of a dropped copy).

    The router's logits are the float64 product rounded once to float32,
    and the softmax and the gates' renormalization are float64 rounded
    once, so the card and the CPU pick the same experts with the same
    gates; the top-k order is `lax.top_k`'s (the larger value first, the
    lower expert first among equal values)."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    logits = (xt.to(torch.float64)
              @ params["router"].to(torch.float64)).to(torch.float32)
    probs = torch.softmax(logits.to(torch.float64), dim=-1).to(torch.float32)
    gate, idx = lax_top_k(probs, k)
    g64 = gate.to(torch.float64)
    gate = (g64 / torch.clamp(g64.sum(-1, keepdim=True), min=1e-9)).to(
        torch.float32)
    mask = torch.zeros((idx.shape[0], e), dtype=torch.long,
                       device=idx.device).scatter_add_(
                           1, idx, torch.ones_like(idx))  # (T, E) in 0..k
    pos_in_e = torch.cumsum(mask, dim=0) - mask           # 0-based slots
    pos = torch.gather(pos_in_e, 1, idx)                  # (T, k)
    tgt = torch.where(pos < capacity, idx * capacity + pos,
                      torch.full_like(pos, e * capacity))
    return probs, gate, idx, mask, tgt


def moe_apply(params, x, cfg, *, capacity: int | None = None):
    """x (B, S, D) -> (y (B, S, D), aux), aux the Switch load-balance
    loss (a 0-dim float32 tensor). `capacity` overrides the slots per
    expert (default `capacity_for` the step's B * S positions)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    if capacity is None:
        capacity = capacity_for(t, cfg)
    xt = x.reshape(t, d)
    probs, gate, _, mask, tgt = route(params, xt, cfg, capacity)
    # scatter the token copies (copy j of token i is row i * k + j) into
    # (E * C + 1, D): each kept copy has a row of its own, only dropped
    # copies share the dump row, which nothing reads
    flat_tgt = tgt.reshape(-1)
    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, flat_tgt, xt.repeat_interleave(k, dim=0))
    # the stacked experts (E, K, N): each linear one launch over all E
    yb = mlp_apply(buf[:-1].reshape(e, capacity, d), params["experts"],
                   cfg.mlp_act)
    flat = torch.cat([yb.reshape(e * capacity, d),
                      torch.zeros((1, d), dtype=yb.dtype, device=yb.device)])
    picked = flat.index_select(0, flat_tgt).reshape(t, k, d)
    # the gated sum over k in the reference's order: products added from
    # the first pick to the last
    g = gate.to(x.dtype)
    y = g[:, 0, None] * picked[:, 0]
    for j in range(1, k):
        y = y + g[:, j, None] * picked[:, j]
    if "shared" in params:
        y = y + mlp_apply(xt, params["shared"], cfg.mlp_act)
    # the Switch loss, in float64 rounded once (card and CPU agree)
    frac_tokens = mask.to(torch.float64).mean(0) * e / k
    frac_prob = probs.to(torch.float64).mean(0) * e
    aux = torch.mean(frac_tokens * frac_prob).to(torch.float32)
    return y.reshape(b, s, d), aux
