"""Self-speculative decoding with the truncated ITERA cascade as the draft
(port of `repro.runtime.speculation`).

A rank-r ITERA cascade's first r' components are the rank-r' ITERA model
(`core.itera.truncate`), so every compressed layer already holds a cheaper
copy of itself: a draft model with the same resident weights.

  1. draft  -- each greedy decode row runs k width-1 steps with the
     truncated cascade, chaining argmax tokens; their K/V lands in the
     same blocked pool.
  2. verify -- one full-model `unified_step` over the (k+1)-wide span
     [last committed token, d_1 .. d_k], which overwrites every
     draft-written K/V slot with full-model values.
  3. accept -- the longest draft prefix that matches the full model's
     argmax chain is kept, plus the full model's own next token, so the
     emitted tokens are always the full model's: speculative serve gives
     the plain serve's tokens.

Scheduling (per-row clamps, provisional KV blocks and their rollback) is
`runtime.scheduler`'s; the serve loop is `api.engine`'s. On a
tensor-parallel engine each rank runs the whole round on its slice: the
draft is derived from the full weights and then sliced by the served
weights' rules (truncation acts on the rank axis, the slice on heads and
hidden columns, so they commute), over the rank's head slice of the pool;
the accept bookkeeping is the same on every rank.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.compress import flatten, map_with_path
from repro_torch.core.itera import LowRankQ, truncate
from repro_torch.core.quant import QuantizedTensor, pack_weights, unpack_weights
from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.runtime import sampling as smp


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """How to derive the draft model from the served weights.

    k             : draft tokens proposed per decode row per round.
    rank_fraction : the draft keeps `draft_rank(r, rank_fraction)`
                    components of every rank-r cascade.
    act_wl        : optional activation word length of the draft pass
                    (e.g. A8 serve, A6 draft); None keeps the plan's.
    """

    k: int = 4
    rank_fraction: float = 0.5
    act_wl: int | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"draft k must be >= 1, got {self.k}")
        if not 0.0 < self.rank_fraction <= 1.0:
            raise ValueError(f"rank_fraction must be in (0, 1], got "
                             f"{self.rank_fraction}")
        if self.act_wl is not None and not 2 <= self.act_wl <= 8:
            raise ValueError(f"draft act_wl={self.act_wl} outside [2, 8]")

    def to_dict(self) -> dict:
        d = {"k": self.k, "rank_fraction": self.rank_fraction}
        if self.act_wl is not None:
            d["act_wl"] = int(self.act_wl)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DraftSpec":
        return cls(k=int(d.get("k", 4)),
                   rank_fraction=float(d.get("rank_fraction", 0.5)),
                   act_wl=None if d.get("act_wl") is None
                   else int(d["act_wl"]))


def draft_rank(rank: int, fraction: float) -> int:
    """round(fraction * rank), floored to a multiple of 64 when the full
    rank is at least 256 (the reference's rank granularity)."""
    rd = max(1, int(round(fraction * rank)))
    if rank >= 256 and rd >= 64:
        rd = (rd // 64) * 64
    return min(rd, rank)


def _contiguous(q: QuantizedTensor) -> QuantizedTensor:
    return dataclasses.replace(q, values=q.values.contiguous(),
                               scale=q.scale.contiguous())


def derive_draft_params(params, spec: DraftSpec):
    """The draft's parameter tree: every dense tensor (embeddings, lm
    head, norms) and every node the spec leaves alone is the served
    tree's own object; each `LowRankQ` keeps its first `draft_rank`
    components (unpacked, `truncate`d, repacked where the served node
    was packed and the packing rule admits the new width, and stored
    contiguous); with `spec.act_wl`, quantized nodes are restamped to
    the draft's activation word length."""

    def f(_, leaf):
        if isinstance(leaf, LowRankQ):
            r = int(leaf.w2.shape[-2])
            rd = draft_rank(r, spec.rank_fraction)
            if rd == r and spec.act_wl is None:
                return leaf
            lr = LowRankQ(unpack_weights(leaf.w1), unpack_weights(leaf.w2))
            if rd < r:
                lr = truncate(lr, rd)
            w1, w2 = lr.w1, lr.w2
            if spec.act_wl is not None:
                w1 = dataclasses.replace(w1, act_wl=spec.act_wl)
                w2 = dataclasses.replace(w2, act_wl=spec.act_wl)
            if leaf.w1.packed:
                w1 = pack_weights(w1)
            if leaf.w2.packed:
                w2 = pack_weights(w2)
            return LowRankQ(_contiguous(w1), _contiguous(w2))
        if isinstance(leaf, QuantizedTensor) and spec.act_wl is not None:
            return dataclasses.replace(leaf, act_wl=spec.act_wl)
        return leaf

    return map_with_path(f, params)


def is_exact_draft(params, draft_params) -> bool:
    """True when the draft is the served tree itself, node for node (no
    cascade truncated, no act_wl changed): speculation would then accept
    everything and save nothing."""
    a, b = flatten(params), flatten(draft_params)
    return a.keys() == b.keys() and all(a[p] is b[p] for p in a)


def speculative_step(params, draft_params, pool, block_tables, step_buf,
                     prev, cfg, k: int, sample: bool = False):
    """One draft -> verify -> accept dispatch.

    step_buf (B, W + 4 + SAMP_COLS) int32: span tokens (B, W), then
    ctx_lens, q_lens, use_prev, spec_lens, then each row's packed
    sampling metadata. Decode rows carry q_lens = 1 + spec_lens (the
    previous token and their drafts); prefill rows their chunk and
    spec_lens = 0. W >= k + 1.

    draft  -- k width-1 `unified_step`s with `draft_params` over the
              same pool; row r takes part in draft i iff
              i < spec_lens[r], starting from `prev` (its last committed
              token, on the device) and feeding each argmax to the next.
    verify -- one full-model `unified_step` over the spans, with
              verify_width = k + 1.
    accept -- n_acc[r] = the length of the matching draft prefix.

    With `sample`, rows with temperature > 0 (which never draft) replace
    their emitted token by a sample from the last valid position's
    logits, keyed as in the plain step.

    Returns (full_toks (B, k + 2) int32, n_acc (B,) int32, next_prev
    (B, 1) int32, pool): a decode row emits full_toks[r, :n_acc + 1], a
    row finishing its prompt full_toks[r, k + 1]; next_prev is each
    row's newest token."""
    m = smp.SAMP_COLS
    tokens = step_buf[:, :-(4 + m)]
    ctx_lens = step_buf[:, -(m + 4)].contiguous()
    q_lens = step_buf[:, -(m + 3)].contiguous()
    use_prev = step_buf[:, -(m + 2)].bool()
    spec_lens = step_buf[:, -(m + 1)]

    # ---- draft: k chained single-token passes of the truncated model
    drafts = []
    d = prev
    for i in range(k):
        ql = (spec_lens > i).to(torch.int32)
        dlogits, pool = tfm.unified_step(draft_params, pool, block_tables,
                                         ctx_lens + i, ql, d, cfg)
        d = torch.argmax(dlogits[:, -1], dim=-1)[:, None].to(torch.int32)
        drafts.append(d)

    # ---- verify: prev + drafts spliced into the span, one full pass
    first = torch.where(use_prev, prev[:, 0], tokens[:, 0])
    cols = [first[:, None]]
    if k:
        draft_mat = torch.cat(drafts, dim=1)                      # (B, k)
        spec_cols = (torch.arange(k, device=step_buf.device)[None, :]
                     < spec_lens[:, None])
        cols.append(torch.where(spec_cols, draft_mat, tokens[:, 1:k + 1]))
    cols.append(tokens[:, k + 1:])
    tokens = torch.cat(cols, dim=1)
    logits, pool = tfm.unified_step(params, pool, block_tables, ctx_lens,
                                    q_lens, tokens, cfg, verify_width=k + 1)
    full_toks = torch.argmax(logits, dim=-1).to(torch.int32)     # (B, k+2)
    if sample:
        # column k + 1 is the last valid position, which for a q = 1
        # decode row is column 0 too: both carry the sample
        meta = smp.unpack_meta(step_buf)
        keys = smp.row_keys(meta["seed"], meta["rid"], meta["counter"])
        samp = smp.sample_tokens(logits[:, -1], meta["temperature"],
                                 meta["top_k"], meta["top_p"], keys)
        srow = meta["temperature"] > 0.0
        full_toks = full_toks.clone()
        for c in (0, k + 1):
            full_toks[:, c] = torch.where(srow, samp, full_toks[:, c])

    # ---- accept: the longest matching draft prefix
    if k:
        match = (draft_mat == full_toks[:, :k]) & spec_cols
        n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        n_acc = n_acc.to(torch.int32)
    else:
        n_acc = torch.zeros_like(spec_lens)
    last_idx = torch.where(use_prev, n_acc.long(),
                           torch.full_like(n_acc, k + 1, dtype=torch.long))
    next_prev = torch.gather(full_toks, 1, last_idx[:, None])
    return full_toks, n_acc, next_prev, pool


class SpeculationController:
    """The engine's draft model: derives and holds the draft tree (and its
    per-layer views) and runs `speculative_step` with it. With a serving
    `mesh` (`launch.mesh.ServingMesh`), `params` are the full weights:
    the draft is derived from them and then sliced to this rank, and the
    steps run with the per-rank config."""

    def __init__(self, spec: DraftSpec, cfg, params, draft_params=None, *,
                 mesh=None):
        self.spec = spec
        draft = (derive_draft_params(params, spec) if draft_params is None
                 else draft_params)
        self.exact = is_exact_draft(params, draft)
        if mesh is not None:
            cfg = shd.tp_local_config(cfg, mesh.size)
            draft = shd.tp_shard_params(draft, mesh.size, mesh.rank)
        self.cfg = cfg
        self.draft_params = draft
        self._draft_step = tfm.split_layers(draft, cfg.num_layers)

    def step(self, step_params, pool, block_tables, step_buf, prev, k: int,
             sample: bool = False):
        """`speculative_step` with the served model's per-layer views
        `step_params` and this draft, at draft width k."""
        return speculative_step(step_params, self._draft_step, pool,
                                block_tables, step_buf, prev, self.cfg, k,
                                sample=sample)
