"""Paged attention over the blocked KV pool: wrapper of
`csrc/paged_attention.cu` and its plain version (port of
`repro.kernels.paged_attention` and of the gather oracle
`repro.models.attention._span_attend_gather`).

On a CUDA tensor `paged_attention` launches the kernel (or raises); on a
CPU tensor it runs the plain version, which gathers each row's whole
block-table view and takes one masked softmax over it. Both give the
gather oracle's value at every span position of every row: past q_lens
and in idle rows too, which a mixture-of-experts layer routes with the
real tokens (the reference's own Pallas kernel gives zeros for idle rows
and sees only the valid blocks past q_lens; its CPU oracle, which the
port is held to, does not).

Both take their arithmetic in float64 from the fp32 (or dequantized int8)
inputs and round once to fp32. They sum in different orders, and the
card's float64 `exp` is not correctly rounded, so their float64 results
differ in the last bits; rounding once to fp32 makes an fp32 difference
rare, not impossible. That matters because the attention output is
requantized at the next linear, where a last-bit difference between the
card and the CPU flips an int8 code and, through the layers, may flip a
greedy token. The reference computes in fp32, within 1e-5 of this. The
function itself is fp32 attention: float64 is the port's choice, for
parity, and costs the kernel time above its fp32 bound.

A bfloat16 model's attention (bfloat16 q, a bfloat16 pool or an int8 one
with fp32 scales, a bfloat16 output) keeps the reference's rounding
points (`attend_bf16`): int8 K/V dequantized as code.astype(bf16) *
scale.astype(bf16), scores rounded to fp32 and scaled in fp32, the
softmax's p rounded to bfloat16 before the PV product, the output rounded
to fp32 and then bfloat16. Between those points both versions compute in
float64. The kernel takes this path for Dh 32, 64, 128, 160 and 192, in two
passes over the keys (max and denominator, then P.V), both products on
the FP64 tensor cores, the keys of a tile split over a thread-block
cluster (`choose_bf16_splits`) whose CTAs combine their partials in rank
order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.quant_matmul import _check

NEG = -2.3819763e38  # large negative for masking in f32 (the reference's)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "paged_attention_launch": (_I, (_P,) * 10 + (_I,) * 11 + (_D, _D, _P)),
    "paged_attention_smem_bytes": (ctypes.c_longlong, (_I, _I, _I, _I)),
    "paged_attention_bf16_launch": (_I, (_P,) * 8 + (_I,) * 11
                                    + (_D, _D, _P)),
    "paged_attention_bf16_smem_bytes": (ctypes.c_longlong, (_I,) * 4),
}
DH_FP32 = (32, 64, 128)          # head dims of the fp32 kernel
DH_BF16 = (32, 64, 128, 160, 192)  # head dims of the bfloat16 kernel
QT_DECODE, QT_PREFILL = 16, 64  # query rows per CTA of the two tile kinds
STAGE_KEYS = 64                 # keys the kernel stages per step
_WARPS = 4
BF16_QT_DECODE, BF16_QT_PREFILL = 8, 64  # query rows a bf16 tile
BF16_CLUSTER = 8                # most key splits (cluster ranks) a bf16 tile
_BF16_WARPS = 8


def smem_bytes(qt: int, dh: int, quant, bs: int) -> int:
    """Shared memory of one CTA, in Python: csrc
    `paged_attention_smem_bytes`. The Q tile (qt x (Dh + 4) floats),
    decode tiles' per-warp float64 softmax states (m, l, acc), and two
    ring stages of K and V rows (a stage's keys, whole blocks, rounded up
    to 64 rows; int8 rows padded by 16 bytes with their two scales)."""
    per_stage = 1 if bs >= STAGE_KEYS else STAGE_KEYS // bs
    rows = -(-per_stage * bs // 64) * 64
    kv = 2 * (dh + 16) if quant else (dh + 4) * 4 + (dh + 8) * 4
    stage = rows * kv + (rows * 8 if quant else 0)
    states = _WARPS * qt * (dh + 2) * 8 if qt <= QT_DECODE else 0
    return qt * (dh + 4) * 4 + states + 2 * stage


def choose_splits(b: int, hk: int, w: int, g: int, mb: int, bs: int,
                  num_sms: int) -> tuple[int, int, int]:
    """(qt, kps, splits) of a launch, from the shapes alone (the host never
    reads ctx_lens, which live on the card).

    qt: query rows per tile, 16 (decode tiles, W*G <= 16) or 64 (prefill
    tiles, on the tensor cores). Each tile's keys are cut into splits of
    kps keys, whole blocks of at least one stage: the widest power of two
    of stages that still gives B x Hk x tiles x splits >= `waves` x the
    SM count for the longest possible row (MB blocks). Decode tiles take
    two waves (two CTAs share an SM), so a decode step covers the card.
    Prefill tiles take four: causal tiles differ in length by up to the
    span, and a long tile cut into splits no longer holds the launch up."""
    qt = QT_DECODE if w * g <= QT_DECODE else QT_PREFILL
    tiles = -(-w * g // qt)
    waves = 2 if qt == QT_DECODE else 4
    step = max(1, STAGE_KEYS // bs)     # blocks per stage
    bps = step
    while bps < mb:
        bps *= 2
    while bps > step and b * hk * tiles * -(-mb // bps) < waves * num_sms:
        bps //= 2
    return qt, bps * bs, max(1, -(-mb // bps))


def bf16_smem_bytes(qt: int, dh: int, quant, splits: int) -> int:
    """Shared memory of one CTA of the bfloat16 kernel, in Python: csrc
    `paged_attention_bf16_smem_bytes`. The Q tile (bf16 rows of 2 * Dh + 32
    bytes); each row's (M, L) and, for decode tiles, each warp's (m, l);
    the (m, l) slots of the cluster's exchange; a decode tile's column
    shares received from the cluster; then the larger of the two ring
    stages (64 K and 64 V rows of 2 * Dh + 32 bytes, an int8 pool's two
    scale planes) and what the region holds after the passes: decode
    tiles' per-warp P.V partials, prefill tiles' received shares, all
    float64."""
    wk = _BF16_WARPS * 8 // qt
    row = 2 * dh + 32
    stage = STAGE_KEYS * 2 * row + (STAGE_KEYS * 8 if quant else 0)
    wpart = wk * qt * dh * 8 if wk > 1 else 0
    recv = splits * qt * -(-dh // splits) * 8 if splits > 1 else 0
    own = qt == BF16_QT_DECODE
    head = (qt * row + qt * 16 * (1 + wk if wk > 1 else 1)
            + splits * qt * 16 + (recv if own else 0))
    return head + max(2 * stage, wpart + (0 if own else recv))


def choose_bf16_splits(b: int, hk: int, w: int, g: int, mb: int, bs: int,
                       num_sms: int) -> tuple[int, int, int]:
    """(qt, kps, splits) of a bfloat16 launch, from the shapes alone (the
    host never reads ctx_lens, which live on the card).

    qt: query rows per tile, 8 (decode tiles, W*G <= 16) or 64 (prefill
    tiles). The keys of the longest possible row (MB blocks) are cut into
    `splits` <= 8 ranges of kps keys, whole 64-key stages, one CTA of a
    cluster each: the fewest splits that give B x Hk x tiles x splits >=
    2 x the SM count (decode; four times for prefill tiles, whose lengths
    differ by up to the span) and, for decode tiles, at most two stages a
    split, so that pass 2 reads K and V from shared memory."""
    qt = BF16_QT_DECODE if w * g <= 16 else BF16_QT_PREFILL
    ctas = b * hk * -(-w * g // qt)
    chunks = -(-mb * bs // STAGE_KEYS)
    waves = 2 if qt == BF16_QT_DECODE else 4
    s = 1
    while s < min(BF16_CLUSTER, chunks) and (
            ctas * s < waves * num_sms
            or (qt == BF16_QT_DECODE and -(-chunks // s) > 2)):
        s += 1
    kps = -(-chunks // s) * STAGE_KEYS
    return qt, kps, -(-mb * bs // kps)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap > 0 else x


def attend_bf16(qg, k, v, mask, cap: float = 0.0) -> torch.Tensor:
    """Attention of a bfloat16 model at the reference's rounding points:
    qg (B, Sq, Hk, G, Dh) bfloat16 queries grouped by kv head; k, v (B, Sk,
    Hk, Dh) bfloat16; mask broadcastable to (B, Hk, G, Sq, Sk). Scores
    q.k are rounded to fp32 (the reference's preferred_element_type) and
    scaled by fp32 Dh^-0.5 in fp32, softcapped in float64 and rounded; the
    softmax is float64, its p rounded to fp32 and then bfloat16 (the
    reference's `p.astype(v.dtype)`); the PV product is float64, rounded
    to fp32 and then bfloat16. Returns (B, Sq, Hk, G, Dh) bfloat16."""
    dh = qg.shape[-1]
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32).item()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float64),
                     k.to(torch.float64)).to(torch.float32)
    s = (s.to(torch.float64) * scale).to(torch.float32).to(torch.float64)
    if cap > 0:
        s = (cap * torch.tanh(s / cap)).to(torch.float32).to(torch.float64)
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1).to(torch.float32).to(torch.bfloat16)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.float64),
                     v.to(torch.float64))
    return o.to(torch.float32).to(torch.bfloat16)


def span_attend_gather(q, pool, block_table, ctx_lens, logit_softcap=0.0):
    """The plain version: gather the FULL logical pool view
    block_table -> (B, MB*bs, Hk, Dh) (dequantized whole when the pool is
    int8) and take one masked softmax over it. Query (r, i) sees slots at
    positions <= ctx_lens[r] + i, in every row and at every span
    position. A bfloat16 q takes `attend_bf16`'s rounding points."""
    b, w, h, dh = q.shape
    _, bs, hk, _ = pool["k"].shape
    mb = block_table.shape[1]
    bt = block_table.long()

    def view(key):
        x = pool[key][bt].reshape(b, mb * bs, hk, -1).to(q.dtype)
        if "ks" in pool:
            x = x * pool[key[0] + "s"][bt].reshape(b, mb * bs, hk, 1).to(
                q.dtype)
        return x if q.dtype == torch.bfloat16 else x.to(torch.float64)

    ck, cv = view("k"), view("v")
    pos = ctx_lens.long()[:, None] + torch.arange(w, device=q.device)[None]
    valid = (torch.arange(mb * bs, device=q.device)[None, None, :]
             <= pos[:, :, None])                                 # (B, W, S)
    if q.dtype == torch.bfloat16:
        o = attend_bf16(q.reshape(b, w, hk, h // hk, dh), ck, cv,
                        valid[:, None, None], logit_softcap)
        return o.reshape(b, w, h, dh)
    qg = q.to(torch.float64).reshape(b, w, hk, h // hk, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck) * (dh ** -0.5)
    s = softcap(s, logit_softcap)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, cv)
    return o.reshape(b, w, h, dh).to(q.dtype)


def paged_attention(q, pool, block_table, ctx_lens, *,
                    logit_softcap: float = 0.0,
                    keys_per_split: int | None = None) -> torch.Tensor:
    """Span queries against ONE layer's blocked pool, reading no block
    past the last key a query sees.

    q (B, W, H, Dh) f32 or bfloat16 (post-RoPE); pool {"k", "v"[, "ks",
    "vs"]} with leaves (NB, bs, Hk, *) in q's dtype, or int8 with fp32
    scales, already holding this step's span K/V; block_table (B, MB)
    int32; ctx_lens (B,) int32. Returns (B, W, H, Dh) in q's dtype (a
    bfloat16 q takes `attend_bf16`'s rounding points on both devices;
    the kernel raises for a head dim it does not take, fp32 Dh 32 / 64 /
    128, bfloat16 also 160 and 192): query (r, i) attends over the slots
    at positions <= ctx_lens[r] + i of row r's block-table view, at every
    span position of every row (the gather oracle's values; how many of them are real
    tokens does not enter). keys_per_split overrides the kernel's key
    split (`choose_splits`, `choose_bf16_splits`); any positive count is
    exact, block-aligned or not (a bfloat16 q takes at most 8 splits)."""
    if q.device.type == "cpu":
        return span_attend_gather(q, pool, block_table, ctx_lens,
                                  logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    b, w, h, dh = q.shape
    nb_, bs, hk, _ = pool["k"].shape
    mb = block_table.shape[1]
    quant = "ks" in pool
    if q.dtype == torch.bfloat16:
        return _launch_bf16(q, pool, block_table, ctx_lens, logit_softcap,
                            keys_per_split)
    if q.dtype != torch.float32:
        raise TypeError(f"paged_attention takes a float32 or bfloat16 q, "
                        f"not {q.dtype}")
    if dh not in DH_FP32 or h % hk:
        raise ValueError(f"paged_attention kernel needs Dh in {DH_FP32} "
                         f"and H % Hk == 0, got Dh={dh} H={h} Hk={hk}")
    dev = q.device
    # the kernel copies K/V rows 16 bytes at a time
    kv_dtype = torch.int8 if quant else torch.float32
    _check(q, "q", torch.float32, (b, w, h, dh), dev)
    _check(pool["k"], "k", kv_dtype, (nb_, bs, hk, dh), dev, 16)
    _check(pool["v"], "v", kv_dtype, (nb_, bs, hk, dh), dev, 16)
    if quant:
        _check(pool["ks"], "ks", torch.float32, (nb_, bs, hk, 1), dev)
        _check(pool["vs"], "vs", torch.float32, (nb_, bs, hk, 1), dev)
    _check(block_table, "block_table", torch.int32, (b, mb), dev)
    _check(ctx_lens, "ctx_lens", torch.int32, (b,), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load("paged_attention", _SIGNATURES)
    qt, kps, splits = choose_splits(b, hk, w, h // hk, mb, bs,
                                    build.sm_count(dev.index or 0))
    if keys_per_split is not None:
        kps, splits = _forced_split(keys_per_split, mb * bs)
    smem = lib.paged_attention_smem_bytes(qt, dh, int(quant), bs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_attention: block size {bs} at Dh {dh} needs "
                         f"{smem} bytes of shared memory per CTA")
    ws_ml = ws_acc = None
    if splits > 1:
        rows = b * hk * -(-w * (h // hk) // qt) * splits * qt
        ws_ml = torch.empty((rows, 2), dtype=torch.float64, device=dev)
        ws_acc = torch.empty((rows, dh), dtype=torch.float64, device=dev)
    err = lib.paged_attention_launch(
        q.data_ptr(), pool["k"].data_ptr(), pool["v"].data_ptr(),
        pool["ks"].data_ptr() if quant else None,
        pool["vs"].data_ptr() if quant else None,
        block_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
        ws_ml.data_ptr() if splits > 1 else None,
        ws_acc.data_ptr() if splits > 1 else None, b, w, h, hk, dh, bs, mb,
        int(quant), qt, kps, splits, float(dh) ** -0.5,
        float(logit_softcap), build.stream_handle(dev))
    build.check(err, "paged_attention")
    build.LAUNCHES["paged_attention"] += 1
    return out


def _forced_split(keys_per_split: int, slots: int) -> tuple[int, int]:
    """(kps, splits) of a caller's keys_per_split over `slots` keys."""
    if keys_per_split < 1:
        raise ValueError(f"keys_per_split must be >= 1, got "
                         f"{keys_per_split}")
    return keys_per_split, max(1, -(-slots // keys_per_split))


def _launch_bf16(q, pool, block_table, ctx_lens, logit_softcap,
                 keys_per_split):
    """The bfloat16 kernel (csrc `paged_attention_bf16_launch`): one
    cluster of `splits` CTAs per (batch row, kv head, tile of 8 or 64
    query rows), each CTA taking kps of the tile's keys through both
    passes (see the .cu file); the plan is `choose_bf16_splits`'s, or
    keys_per_split's."""
    b, w, h, dh = q.shape
    nb_, bs, hk, _ = pool["k"].shape
    mb = block_table.shape[1]
    quant = "ks" in pool
    if dh not in DH_BF16 or h % hk:
        raise ValueError(f"paged_attention bfloat16 kernel needs Dh in "
                         f"{DH_BF16} and H % Hk == 0, got Dh={dh} H={h} "
                         f"Hk={hk}")
    dev = q.device
    kv_dtype = torch.int8 if quant else torch.bfloat16
    _check(q, "q", torch.bfloat16, (b, w, h, dh), dev)
    _check(pool["k"], "k", kv_dtype, (nb_, bs, hk, dh), dev, 16)
    _check(pool["v"], "v", kv_dtype, (nb_, bs, hk, dh), dev, 16)
    if quant:
        _check(pool["ks"], "ks", torch.float32, (nb_, bs, hk, 1), dev)
        _check(pool["vs"], "vs", torch.float32, (nb_, bs, hk, 1), dev)
    _check(block_table, "block_table", torch.int32, (b, mb), dev)
    _check(ctx_lens, "ctx_lens", torch.int32, (b,), dev)
    qt, kps, splits = choose_bf16_splits(b, hk, w, h // hk, mb, bs,
                                         build.sm_count(dev.index or 0))
    if keys_per_split is not None:
        kps, splits = _forced_split(keys_per_split, mb * bs)
        if splits > BF16_CLUSTER:
            raise ValueError(f"paged_attention bfloat16 kernel takes at most "
                             f"{BF16_CLUSTER} key splits, {keys_per_split} "
                             f"keys a split give {splits}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load("paged_attention", _SIGNATURES)
    if lib.paged_attention_bf16_smem_bytes(qt, dh, int(quant),
                                           splits) > SMEM_LIMIT:
        raise ValueError(f"paged_attention: Dh {dh} does not fit one CTA")
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32).item()
    err = lib.paged_attention_bf16_launch(
        q.data_ptr(), pool["k"].data_ptr(), pool["v"].data_ptr(),
        pool["ks"].data_ptr() if quant else None,
        pool["vs"].data_ptr() if quant else None,
        block_table.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(), b, w,
        h, hk, dh, bs, mb, int(quant), qt, kps, splits, scale,
        float(logit_softcap), build.stream_handle(dev))
    build.check(err, "paged_attention")
    build.LAUNCHES["paged_attention"] += 1
    return out


def stream_hbm_bytes(ctx_lens, q_lens, block_size: int, hk: int, dh: int,
                     *, kv_bits: int = 32, n_q_heads: int | None = None
                     ) -> int:
    """Least device bytes one launch must move: every valid K/V block of
    every active row read once (ceil((ctx + q) / bs) blocks; codes plus
    fp32 scale planes for int8 KV), and the fp32 query and output rows of
    the valid span positions read and written once."""
    h = n_q_heads or hk
    per_tok = kv_bytes_per_token(hk, dh, kv_bits)
    total = 0
    for ctx, ql in zip(ctx_lens, q_lens):
        ctx, ql = int(ctx), int(ql)
        if ql > 0:
            total += -(-(ctx + ql) // block_size) * block_size * per_tok
            total += 2 * ql * h * dh * 4
    return int(total)


def kv_bytes_per_token(hk: int, dh: int, kv_bits: int) -> int:
    """Device bytes one cached position takes across K and V in the port's
    pool: int8 codes and an fp32 scale per (token, head) at kv_bits 8,
    else bfloat16 (16) or fp32 (32)."""
    if kv_bits not in (8, 16, 32):
        raise ValueError(f"the port's pool is int8 (8), bfloat16 (16) or "
                         f"fp32 (32), got kv_bits={kv_bits}")
    return 2 * hk * (dh + 4) if kv_bits == 8 else 2 * hk * dh * kv_bits // 8


def gather_hbm_bytes(batch: int, max_blocks: int, block_size: int, hk: int,
                     dh: int, *, kv_bits: int = 32, w: int = 1,
                     n_q_heads: int | None = None) -> int:
    """Device bytes of the plain version (`span_attend_gather`): every row
    reads its whole (MB * bs) block-table view, valid or not; the
    gathered K and V are written and read again as float64 views (after
    an fp32 dequantized copy when the pool is int8); the fp32 queries
    and outputs of all W positions are read and written once."""
    h = n_q_heads or hk
    slots = batch * max_blocks * block_size
    per_view = 2 * slots * hk * dh              # K and V elements
    total = slots * kv_bytes_per_token(hk, dh, kv_bits) + per_view * 8 * 2
    if kv_bits == 8:
        total += per_view * 4 * 2
    return int(total + 2 * batch * w * h * dh * 4)


def attention_flops(ctx_lens, q_lens, h: int, dh: int) -> int:
    """Flops the causal span attention needs: 2·Dh for q·k and 2·Dh for
    p·v per (query, visible key) pair, summed over the valid queries."""
    total = 0
    for ctx, ql in zip(ctx_lens, q_lens):
        for i in range(int(ql)):
            total += (int(ctx) + i + 1) * 4 * dh * h
    return total


def launch_work(block_table, ctx_lens, w: int, block_size: int, hk: int,
                dh: int, *, kv_bits: int = 32, n_q_heads: int | None = None,
                q_bytes: int = 4) -> tuple[int, int]:
    """(bytes, flops) one launch of `paged_attention` must move and do:
    every span position of every row attends, so each row reads the
    table entries up to its last query's position (ctx + W - 1, at most
    MB * bs - 1), and each physical block they name is read once however
    many rows name it; the queries and outputs of all B x W positions
    (`q_bytes` an element: 4 fp32, 2 bfloat16) are read and written
    once; 4 * Dh flops a (query, visible key) pair, as in
    `attention_flops`. `stream_hbm_bytes` and
    `attention_flops` count only the positions before q_lens."""
    h = n_q_heads or hk
    slots = len(block_table[0]) * block_size
    blocks, flops = set(), 0
    for row, ctx in zip(block_table, ctx_lens):
        ctx = int(ctx)
        blocks.update(int(x) for x in row[:-(-min(ctx + w, slots)
                                           // block_size)])
        flops += sum(min(ctx + i + 1, slots) for i in range(w)) * 4 * dh * h
    nbytes = (len(blocks) * block_size * kv_bytes_per_token(hk, dh, kv_bits)
              + 2 * len(ctx_lens) * w * h * dh * q_bytes)
    return int(nbytes), int(flops)
