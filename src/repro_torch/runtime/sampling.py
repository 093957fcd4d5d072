"""Fused sampling and stop evaluation for the serving step (port of
`repro.runtime.sampling`).

  * **Packed metadata** -- every step buffer ends in `SAMP_COLS` int32
    columns a row: temperature and top_p as float32 bit patterns, top_k,
    the request's seed, rid and emission counter (its PRNG key), and eos
    id and max_tokens (its stop mask). `write_row_meta` packs a row on
    the host; `unpack_meta` reads it back on the device with
    `Tensor.view(torch.float32)`, so sampling rides the one per-step
    upload.

  * **Counter-based keys** -- row r samples its c-th output token with
    `fold_in(fold_in(prng_key(seed_r), rid_r), c)` (`runtime.prng`, bit
    for bit jax's threefry): a function of the request and the emission
    index alone, not of the batch row, the prefix cache or speculation,
    so a seeded serve replays token for token, and gives the reference's
    tokens.

  * **One sampler** -- `sample_tokens` scales by temperature, takes the
    top `TOPK_CAP` candidates, keeps the top-k of them and then the
    smallest prefix whose probability mass (over the whole vocabulary)
    reaches top_p, and draws by Gumbel-max with noise keyed by token id.
    Rows with temperature <= 0 take the raw-logits argmax, the greedy
    step's token.

  * **Device stops** -- `push_recent` keeps each row's last S emissions
    in a ring; `finished_mask` matches eos, stop sequences and
    max_tokens there (a length-l stop counts only when l <= counter + 1,
    which keeps a row's previous occupant out of reach).
    `match_stop_host` is the numpy oracle with the same inclusive
    semantics.

Precision. The candidate window is an exact integer selection: each
logit's order-preserving int32 image and its token id make one unique
int64 key, so `torch.topk` has one answer on every device, and it is
`lax.top_k`'s (larger first, the lower token id first among equal
values, +0.0 above -0.0). Scaling is one float32 division, correctly
rounded on the CPU and the card alike. The log-sum-exp, the
probabilities, their running sum and the Gumbel noise (from the float32
uniforms) are taken in float64, for the reason the port takes attention
and the norms there: float32 reductions sum in another order on the card
than on the CPU, and float32 `log` differs between the two in the last
bit, where either flips a draw near a tie. The reference takes these in
float32; the two give the same tokens unless a comparison falls within
float32 rounding of its threshold, which the tests' seeds do not meet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime import prng

SAMP_COLS = 8
# column offsets inside the block (negative-indexed from the buffer end)
TEMP, TOPK, TOPP, SEED, RID, COUNTER, EOS, MAXTOK = range(SAMP_COLS)

TOPK_CAP = 256       # the static candidate window (top_k is clamped to it)
F32_TINY = float(np.finfo(np.float32).tiny)


def f32_bits(x: float) -> int:
    """Host-side float32 -> int32 bit pattern (the inverse of the view in
    `unpack_meta`)."""
    return int(np.float32(x).view(np.int32))


def write_row_meta(buf: np.ndarray, row: int, req, counter: int) -> None:
    """Pack one row's sampling/stop metadata into the buffer's trailing
    SAMP_COLS columns. `req` is a resolved `runtime.scheduler.Request`;
    `counter` is the index of the output token this dispatch samples."""
    m = buf[row, -SAMP_COLS:]
    m[TEMP] = f32_bits(req.temperature)
    m[TOPK] = int(req.top_k)
    m[TOPP] = f32_bits(req.top_p)
    m[SEED] = int(req.seed)
    m[RID] = int(req.rid)
    m[COUNTER] = int(counter)
    m[EOS] = -1 if req.eos_id is None else int(req.eos_id)
    m[MAXTOK] = int(req.max_tokens)


def unpack_meta(step_buf: torch.Tensor) -> dict:
    """The trailing SAMP_COLS int32 columns as per-row tensors (the two
    float columns viewed as float32). All-zero metadata (idle rows)
    reads as temperature 0, eos 0 and max_tokens 0."""
    m = step_buf[:, -SAMP_COLS:]

    def col(i):
        return m[:, i].contiguous()

    return {"temperature": col(TEMP).view(torch.float32),
            "top_k": col(TOPK), "top_p": col(TOPP).view(torch.float32),
            "seed": col(SEED), "rid": col(RID), "counter": col(COUNTER),
            "eos": col(EOS), "max_tokens": col(MAXTOK)}


# ------------------------------------------------------------- keys --
def row_keys(seed, rid, counter) -> torch.Tensor:
    """(B,) ints -> (B, 2) keys fold_in(fold_in(prng_key(seed), rid),
    counter)."""
    return prng.fold_in(prng.fold_in(prng.prng_key(seed), rid), counter)


# ---------------------------------------------------------- sampler --
def lax_top_k(scaled: torch.Tensor, cap: int):
    """`lax.top_k(scaled, cap)`: the cap largest values of each row in
    descending order, the lower index first among equal values, and
    their token ids, from a topk over unique int64 keys."""
    v = scaled.shape[-1]
    bits = scaled.contiguous().view(torch.int32)
    order = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    ids = torch.arange(v, dtype=torch.int64, device=scaled.device)
    top = torch.topk(order * (1 << 32) + (v - 1 - ids), cap, dim=-1).values
    cand_idx = (v - 1) - (top & prng.MASK)
    return torch.gather(scaled, -1, cand_idx), cand_idx


def _token_gumbel(keys: torch.Tensor, token_ids: torch.Tensor):
    """(B, 2) keys + (B, cap) token ids -> (B, cap) float64 Gumbel noise
    -log(-log(u)), u = uniform(fold_in(key, token), minval=tiny): a
    function of (row key, token id), not of the token's window rank."""
    u = prng.uniform(prng.fold_in(keys[:, None, :], token_ids), F32_TINY)
    return -torch.log(-torch.log(u.to(torch.float64)))


def sample_tokens(logits, temperature, top_k, top_p, keys) -> torch.Tensor:
    """Per-row temperature / top-k / top-p sampling over (B, V) float32
    logits; `keys` from `row_keys`. Returns (B,) int32 tokens.

    Scale by temperature, take the top min(V, TOPK_CAP) candidates, keep
    the top-k of them (k == 0 or k > cap keeps the window), keep the
    smallest prefix of those whose cumulative probability (normalised
    over the full vocabulary) reaches top_p (the top token always
    stays), then Gumbel-max over what is left. Rows with temperature
    <= 0 return the raw-logits argmax (the first maximum)."""
    v = logits.shape[-1]
    cap = min(v, TOPK_CAP)
    greedy = temperature <= 0.0
    scaled = logits / torch.where(greedy, 1.0, temperature)[:, None]
    cand, cand_idx = lax_top_k(scaled, cap)
    k = torch.where((top_k <= 0) | (top_k > cap), cap, top_k).long()
    kth = torch.gather(cand, -1, (k - 1)[:, None])
    in_k = (torch.arange(cap, device=logits.device)[None, :]
            < k[:, None])
    s64 = scaled.to(torch.float64)
    mx = s64.amax(dim=-1, keepdim=True)
    lse = mx + torch.log(torch.exp(s64 - mx).sum(dim=-1, keepdim=True))
    c64 = cand.to(torch.float64)
    probs = torch.where(in_k, torch.exp(c64 - lse), 0.0)
    before = torch.cumsum(probs, dim=-1) - probs   # mass ranked above
    keep = (before < top_p.to(torch.float64)[:, None]) & in_k
    n_keep = torch.clamp(keep.sum(dim=-1), min=1)
    pth = torch.gather(cand, -1, (n_keep - 1)[:, None])
    masked = torch.where((cand < kth) | (cand < pth), -torch.inf, c64)
    choice = torch.argmax(masked + _token_gumbel(keys, cand_idx), dim=-1)
    sampled = torch.gather(cand_idx, -1, choice[:, None])[:, 0]
    return torch.where(greedy, torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)


# ---------------------------------------------------- stop criteria --
def push_recent(recent: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Shift this step's (B, 1) tokens into the (B, S) ring of the last S
    emissions (every row, every step; `finished_mask`'s counter guard
    never reads what rows that did not emit pushed)."""
    return torch.cat([recent[:, 1:], toks], dim=1)


def finished_mask(toks, recent, meta, stop_seqs) -> torch.Tensor:
    """(B,) int32: 1 where this step's emission finishes the row.

    toks (B,) this step's tokens; recent (B, S) the ring AFTER
    `push_recent`; meta from `unpack_meta`; stop_seqs (B, NS, S) each
    row's stop sequences right-aligned, -1 padded. A length-l stop
    matches only when l <= counter + 1. eos < 0 disables the eos check,
    max_tokens <= 0 the length check."""
    counter = meta["counter"]
    fin = (meta["eos"] >= 0) & (toks == meta["eos"])
    fin |= (meta["max_tokens"] > 0) & (counter + 1 >= meta["max_tokens"])
    pad = stop_seqs < 0
    lens = (~pad).sum(dim=-1)
    hit = ((pad | (stop_seqs == recent[:, None, :])).all(dim=-1)
           & (lens >= 1) & (lens <= counter[:, None] + 1))
    return (fin | hit.any(dim=-1)).to(torch.int32)


def pack_stop_seqs(stops, n_stops: int, max_len: int) -> np.ndarray:
    """One row's stop sequences -> (n_stops, max_len) int32, right-aligned,
    -1 padded (the layout `finished_mask` matches against)."""
    out = np.full((n_stops, max_len), -1, np.int32)
    for j, s in enumerate(stops):
        out[j, max_len - len(s):] = np.asarray(s, np.int32)
    return out


def match_stop_host(tokens, eos_id, stops, max_tokens) -> int | None:
    """The output length at which generation stops (inclusive of the
    matching token), or None if `tokens` never stops: `finished_mask`
    consumed token by token, in numpy."""
    stops = [tuple(int(t) for t in s) for s in (stops or ())]
    for j, t in enumerate(tokens):
        t = int(t)
        if eos_id is not None and t == int(eos_id):
            return j + 1
        for s in stops:
            n = len(s)
            if n and n <= j + 1 and tuple(
                    int(x) for x in tokens[j + 1 - n:j + 1]) == s:
                return j + 1
        if max_tokens is not None and j + 1 >= int(max_tokens):
            return j + 1
    return None
