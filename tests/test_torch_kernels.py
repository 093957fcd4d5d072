"""The port's kernel modules against the JAX reference.

On the CPU every wrapper runs its kernel's plain version; those are held
to the reference bit for bit (integer paths) or within 1e-5 (attention,
whose softmax sums in another order). `test_torch_gpu.py` holds each CUDA
kernel to its plain version on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import itera as jitera
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.kernels import quant_matmul as jqm
from repro.models import attention as jattn
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import itera as titera
from repro_torch.core import quant as tquant
from repro_torch.kernels import build
from repro_torch.kernels import lowrank_qmm as tlr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models import attention as tattn

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)


def _codes(rng, shape, wl):
    m = tquant.qmax(wl)
    return rng.integers(-m, m + 1, size=shape).astype(np.int8)


def _qt_pair(values, scale, wl, axis, act_wl, packed):
    """The same QuantizedTensor in both packages (packed along the last
    axis when asked)."""
    j = jquant.QuantizedTensor(jnp.asarray(values), jnp.asarray(scale), wl,
                               axis, act_wl=act_wl)
    t = tquant.QuantizedTensor(torch.from_numpy(values.copy()),
                               torch.from_numpy(scale.copy()), wl, axis,
                               act_wl=act_wl)
    if packed:
        j = dataclasses.replace(j, values=jquant.pack_int4(j.values),
                                packed=True)
        t = dataclasses.replace(t, values=tquant.pack_int4(t.values),
                                packed=True)
    return j, t


CASES = [(4, 4, False), (4, 4, True), (4, 8, False), (4, 8, True),
         (6, 4, False), (6, 8, False), (8, 4, False), (8, 8, False)]


@pytest.mark.parametrize("wl,act_wl,packed", CASES)
def test_qmm_plain_equals_reference(wl, act_wl, packed):
    rng = np.random.default_rng(wl * 100 + act_wl)
    x = rng.standard_normal((3, 8, 96)).astype(np.float32)
    x[1, 2] = 0.0                           # a zero row keeps scale 1
    w = rng.standard_normal((96, 256)).astype(np.float32)
    jw = jquant.quantize(jnp.asarray(w), wl, axis=0)
    jw, tw = _qt_pair(np.asarray(jw.values), np.asarray(jw.scale), wl, 0,
                      act_wl, packed)
    yj = jops.qmm(jnp.asarray(x), jw, use_kernel=False)
    yt = tops.qmm(torch.from_numpy(x), tw)
    assert tuple(yt.shape) == (3, 8, 256)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("wl,act_wl,packed", CASES)
def test_lrmm_plain_equals_reference(wl, act_wl, packed, fused):
    """Both schedules of the port (the fused cascade and two quant_matmul
    launches with T in device memory) give the reference cascade's bits;
    W1 packs along R, W2 along N."""
    rng = np.random.default_rng(wl * 1000 + act_wl * 10 + fused)
    k, r, n = 64, 256, 512
    x = rng.standard_normal((40, k)).astype(np.float32)
    s1 = rng.uniform(0.01, 0.1, (1, r)).astype(np.float32)
    s2 = rng.uniform(0.01, 0.1, (r, 1)).astype(np.float32)
    j1, t1 = _qt_pair(_codes(rng, (k, r), wl), s1, wl, 0, act_wl, packed)
    j2, t2 = _qt_pair(_codes(rng, (r, n), wl), s2, wl, 1, act_wl, packed)
    yj = jops.lrmm(jnp.asarray(x), jitera.LowRankQ(j1, j2), use_kernel=False)
    yt = tops.lrmm(torch.from_numpy(x), titera.LowRankQ(t1, t2), fused=fused)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("r", [1056, 2560])
def test_lrmm_large_rank_equals_reference(r):
    """Ranks past 1024 (wide slices on the card) through `ops.lrmm` on the
    CPU: the reference cascade's bits, W4 packed on both factors."""
    rng = np.random.default_rng(r)
    k = n = 2560
    x = rng.standard_normal((8, k)).astype(np.float32)
    s1 = rng.uniform(0.01, 0.1, (1, r)).astype(np.float32)
    s2 = rng.uniform(0.01, 0.1, (r, 1)).astype(np.float32)
    j1, t1 = _qt_pair(_codes(rng, (k, r), 4), s1, 4, 0, 8, True)
    j2, t2 = _qt_pair(_codes(rng, (r, n), 4), s2, 4, 1, 8, True)
    yj = jops.lrmm(jnp.asarray(x), jitera.LowRankQ(j1, j2), use_kernel=False)
    yt = tops.lrmm(torch.from_numpy(x), titera.LowRankQ(t1, t2))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def _pool(rng, kv_bits, shape):
    """One layer's pool with random history: fp32 K/V, or int8 codes with
    fp32 scale planes."""
    if kv_bits == 8:
        sshape = (*shape[:-1], 1)
        return {"k": _codes(rng, shape, 8), "v": _codes(rng, shape, 8),
                "ks": rng.uniform(0.01, 0.1, sshape).astype(np.float32),
                "vs": rng.uniform(0.01, 0.1, sshape).astype(np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _block_table(ctx, ql, mb, bs):
    """Rows' tables over consecutive fresh blocks, padded with block 0."""
    table = np.zeros((len(ctx), mb), np.int32)
    nxt = 1
    for r, (c, q) in enumerate(zip(ctx, ql)):
        need = -(-(c + q) // bs)
        table[r, :need] = np.arange(nxt, nxt + need)
        nxt += need
    return table


def _attn_state(kv_bits, seed=0, b=3, w=4, bs=4):
    """A smoke-config layer: W8 q/k/v projections (bit-exact in both
    packages, so the scattered K/V agree exactly), a dense wo, a pool
    with random history, and a span batch: a prefill chunk mid-prompt, an
    idle row and a decode row."""
    rng = np.random.default_rng(seed)
    cfg_j = dataclasses.replace(j_get_config("opus-mt", smoke=True),
                                kv_cache_bits=kv_bits, num_layers=1)
    cfg_t = dataclasses.replace(t_get_config("opus-mt", smoke=True),
                                kv_cache_bits=kv_bits, num_layers=1)
    d, hk, hd = cfg_t.d_model, cfg_t.num_kv_heads, cfg_t.head_dim
    ctx, ql = np.array([5, 0, 9], np.int32), np.array([3, 0, 1], np.int32)
    mb = 4
    nb = 1 + b * mb
    table = _block_table(ctx, ql, mb, bs)
    pj, pt = {}, {}
    for name in ("wq", "wk", "wv"):
        wf = rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5
        jq = jquant.quantize(jnp.asarray(wf), 8, axis=0)
        pj[name], pt[name] = _qt_pair(np.asarray(jq.values),
                                      np.asarray(jq.scale), 8, 0, 8, False)
    wo = rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5
    pj["wo"], pt["wo"] = jnp.asarray(wo), torch.from_numpy(wo)
    pool = _pool(rng, kv_bits, (nb, bs, hk, hd))
    x = rng.standard_normal((b, w, d)).astype(np.float32)
    return cfg_j, cfg_t, pj, pt, pool, table, ctx, ql, x


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_span_attention_paged_matches_reference(kv_bits):
    """Scatter then attend: the pool after the scatter is the reference's
    exactly (int8 codes and scales included; in the trash block the last
    pad slot wins, as in the reference), and the attention output at
    every span position, past q_lens and in the idle row too, is within
    1e-5 (fp32, another reduction order)."""
    cfg_j, cfg_t, pj, pt, pool, table, ctx, ql, x = _attn_state(kv_bits)
    yj, pool_j = jattn.span_attention_paged(
        pj, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(table), jnp.asarray(ctx), jnp.asarray(ql), cfg_j,
        impl="ref")
    pool_t = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    yt, pool_t = tattn.span_attention_paged(
        pt, torch.from_numpy(x), pool_t, torch.from_numpy(table),
        torch.from_numpy(ctx), torch.from_numpy(ql), cfg_t)
    for key in pool:
        np.testing.assert_array_equal(pool_t[key].numpy(),
                                      np.asarray(pool_j[key]), key)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_paged_attention_plain_matches_pallas_interpret(kv_bits, softcap):
    """The port's plain paged attention against the reference Pallas
    kernel run in interpret mode, on the valid span positions."""
    _, _, _, _, pool, table, ctx, ql, _ = _attn_state(kv_bits, seed=1)
    rng = np.random.default_rng(2)
    b, w = table.shape[0], 4
    _, bs, hk, hd = pool["k"].shape
    q = rng.standard_normal((b, w, 2 * hk, hd)).astype(np.float32)  # G = 2
    oj = jpa.paged_attention(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(table), jnp.asarray(ctx), jnp.asarray(ql),
        logit_softcap=softcap, interpret=True)
    ot = tpa.paged_attention(
        torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in
                              pool.items()},
        torch.from_numpy(table), torch.from_numpy(ctx),
        logit_softcap=softcap)
    for r in range(b):
        np.testing.assert_allclose(ot.numpy()[r, :ql[r]],
                                   np.asarray(oj)[r, :ql[r]], rtol=0,
                                   atol=1e-5)


def test_byte_and_op_models():
    ctx, ql = [5, 0, 9], [3, 0, 1]
    # rows 0 and 2 read 2 and 3 blocks of 4 slots; the idle row nothing
    per_tok = 2 * 2 * 16 * 4
    io = 2 * (3 + 1) * 4 * 16 * 4
    assert tpa.stream_hbm_bytes(ctx, ql, 4, 2, 16, n_q_heads=4) == \
        (2 + 3) * 4 * per_tok + io
    # query i of row r sees ctx + i + 1 keys
    assert tpa.attention_flops(ctx, ql, 4, 16) == \
        (6 + 7 + 8 + 10) * 4 * 16 * 4
    w = tquant.QuantizedTensor(torch.zeros(512, 16, dtype=torch.int8),
                               torch.ones(1, 32), 4, 0, packed=True)
    assert tops.qmm_hbm_bytes(8, w) == 8 * 512 + 8 * 4 + 512 * 16 + 32 * 4 \
        + 8 * 32 * 4
    lr = titera.LowRankQ(w, tquant.QuantizedTensor(
        torch.zeros(32, 64, dtype=torch.int8), torch.ones(32, 1), 8, 1))
    # the (8, 32) intermediate never reaches device memory
    assert tops.lrmm_hbm_bytes(8, lr) == 8 * 512 + 8 * 4 + 512 * 16 + 32 * 64 \
        + (32 + 32) * 4 + 8 * 64 * 4


def _owned_columns(t, n):
    """Columns of Y each CTA writes, as lowrank_qmm.cu assigns them: CTA
    (ir, in) of a cluster takes share `in` of the cluster's span in chunks
    of at most 128 columns, and of each chunk its 1/Cr part."""
    cols = []
    cr, share = t.cluster // t.cn, t.ncl // t.cn
    nc = min(share, 128)
    for x in range(-(-n // t.ncl)):
        for rank in range(t.cluster):
            ir, i_n = divmod(rank, t.cn)
            for ch in range(share // nc):
                n0 = x * t.ncl + i_n * share + ch * nc
                part = nc // cr
                cols += [c for c in range(n0 + ir * part, n0 + (ir + 1) * part)
                         if c < n]
    return cols


@pytest.mark.parametrize("m,r,n", [(8, 256, 512), (8, 256, 2048),
                                   (8, 256, 512 + 32), (2048, 256, 2048),
                                   (300, 1024, 512), (8, 1024, 2048),
                                   (2048, 1024, 512), (5, 32, 64)])
def test_lowrank_tile_choice(m, r, n):
    """Clusters of at most 8 CTAs whose rank slices cover R, every column
    of Y written by exactly one CTA, shared memory within the card's
    limit, and about one wave (132 SMs) at the decode shapes."""
    t = tlr.choose_tiles(m, r, n, 132, tlr.smem_bytes)
    assert t.cluster in (1, 2, 4, 8) and t.cluster % t.cn == 0
    assert t.rs in (32, 64, 128) and t.cluster * t.rs >= r
    assert t.ncl % (32 * t.cn) == 0
    assert tlr.smem_bytes(t.bm, t.rs, t.cluster, t.cn,
                              t.ncl) <= tlr.SMEM_LIMIT
    assert sorted(_owned_columns(t, n)) == list(range(n))
    if m == 8 and r == 256:
        assert t.ctas(m, n) >= 0.9 * 132


@pytest.mark.parametrize("m,e", [(8, 1), (2048, 1), (8, 8), (2048, 8)])
@pytest.mark.parametrize("n", [512, 3584, 18432])
def test_lowrank_tile_choice_every_rank(m, e, n):
    """Every R % 32 from 32 to 18,432 (nemotron-4-340b's d_model, the
    widest min(K, N) of the configs) has a partition within shared
    memory whose slices cover R: clusters up to R 4096 (T on chip; wide
    slices past 1024, at most 32 rows), the grouped path past it; every
    column of Y written by exactly one CTA."""
    paths = set()
    for r in range(32, 18432 + 1, 32):
        t = tlr.choose_tiles(m, r, n, 132, tlr.smem_bytes, e)
        assert tlr.smem_bytes(*t) <= tlr.SMEM_LIMIT
        paths.add(t.path)
        if r <= 1024:
            assert t.rs in (32, 64, 128) and not t.groups
        if t.groups:
            assert r > 4096 and t.cluster == t.cn == 1
            assert t.rs == tlr.GROUP_RS and t.groups * t.rs >= r
            assert (t.groups - 1) * t.rs < r and t.ncl in (32, 64, 128)
            assert t.launches == 2
        else:
            assert r <= 4096 and t.cluster * t.rs >= r and t.rs % 32 == 0
            assert t.rs <= tlr.RS_WIDE and t.cluster % t.cn == 0
            assert (t.cluster * t.rs - r) < 32 * t.cluster or t.rs <= 128
            if t.rs > 128:
                assert t.bm <= 32 and t.cluster == 8
    assert paths == {"cluster", "grouped"}
    for r in (1056, 4096, 4128, 18432):
        t = tlr.choose_tiles(m, r, n, 132, tlr.smem_bytes, e)
        if t.groups:
            cols = [c for x in range(-(-n // t.ncl))
                    for c in range(x * t.ncl, min((x + 1) * t.ncl, n))]
        else:
            cols = _owned_columns(t, n)
        assert sorted(cols) == list(range(n))


def test_lowrank_tile_choice_refuses():
    # R 2048 is taken (wide slices); what is not a multiple of 32, or
    # fits no CTA, is refused
    assert tlr.choose_tiles(8, 2048, 512, 132, tlr.smem_bytes).rs == 256
    with pytest.raises(ValueError, match="% 32"):
        tlr.choose_tiles(8, 250, 512, 132, tlr.smem_bytes)
    with pytest.raises(ValueError, match="shared memory"):
        tlr.choose_tiles(8, 256, 512, 132, lambda *tiles: 1 << 30)


@pytest.mark.parametrize("b,hk,w,g,mb", [(8, 8, 1, 1, 32), (8, 8, 256, 1, 33),
                                         (1, 1, 1, 1, 3), (4, 2, 1, 8, 200),
                                         (2, 2, 40, 2, 9)])
def test_attention_split_choice(b, hk, w, g, mb):
    """Decode tiles (W*G <= 16) take 16 query rows, prefill tiles 64;
    splits are whole stages of blocks, cover the longest row once, and
    give two waves of CTAs (prefill: four) where the rows are long enough
    to split."""
    bs = 16
    qt, kps, splits = tpa.choose_splits(b, hk, w, g, mb, bs, 132)
    assert qt == (16 if w * g <= 16 else 64)
    assert kps % 64 == 0 and kps % bs == 0
    assert splits * kps >= mb * bs > (splits - 1) * kps
    tiles = -(-w * g // qt)
    waves = 2 if qt == 16 else 4
    if splits < -(-mb * bs // 64):      # could split further
        assert b * hk * tiles * splits >= waves * 132
    if (b, hk, w, mb) == (8, 8, 1, 32):  # the serving decode step
        assert b * hk * splits >= 132


@pytest.mark.parametrize("b,hk,w,g,mb", [
    (8, 10, 1, 4, 32), (8, 8, 1, 4, 32),      # the serving decode step
    (8, 10, 1, 4, 256), (8, 8, 1, 4, 256),    # ... at 4096 keys
    (8, 10, 256, 4, 32), (8, 8, 256, 4, 32),  # a W 256 prefill chunk
    (1, 8, 256, 4, 32), (1, 1, 1, 1, 3), (2, 2, 3, 4, 9), (8, 8, 8, 1, 32),
    (8, 8, 1, 12, 32), (8, 8, 256, 12, 32)])   # nemotron: a group of 12
def test_bf16_attention_split_choice(b, hk, w, g, mb):
    """The bf16 kernel's plan: decode tiles (W*G <= 16) of 8 query rows,
    prefill tiles of 64; at most 8 splits (a portable cluster) of whole
    64-key stages that cover the longest row once; the fewest splits that
    fill the card (two CTAs an SM, four for prefill tiles) and keep a
    decode split within the two ring stages, so that one more stage a
    split would break one of those; the serving decode step of phi3 (Hk
    10) and stablelm (Hk 8) covers the card, and two of its CTAs fit an
    SM; nemotron's decode rows (a group of 12) take two 8-row tiles a kv
    head and cover the card; every head dim's CTA fits the card's
    limit."""
    bs, sms = 16, 132
    qt, kps, splits = tpa.choose_bf16_splits(b, hk, w, g, mb, bs, sms)
    assert qt == (8 if w * g <= 16 else 64)
    assert kps % 64 == 0 and 1 <= splits <= tpa.BF16_CLUSTER
    assert splits * kps >= mb * bs > (splits - 1) * kps
    tiles = b * hk * -(-w * g // qt)
    waves = 2 if qt == 8 else 4
    fewer = -(-mb * bs // (kps + 64))
    if fewer < splits:
        assert (tiles * fewer < waves * sms
                or (qt == 8 and kps + 64 > 128))
    if (b, w, g, mb) == (8, 1, 4, 32):
        assert tiles * splits >= sms and kps <= 128
        for dh, quant in ((128, False), (128, True), (160, False),
                          (160, True)):
            smem = tpa.bf16_smem_bytes(qt, dh, quant, splits)
            assert 2 * (smem + 1024) <= 233472
    if mb * bs == 4096 and w == 1:
        assert splits == 8
    if (b, w, g) == (8, 1, 12):
        assert qt == 8 and tiles == b * hk * 2 and tiles * splits >= sms
    for dh in tpa.DH_BF16:
        for quant in (False, True):
            assert tpa.bf16_smem_bytes(qt, dh, quant, splits) <= \
                build.SMEM_LIMIT


def _assert_bf16_close(o, ref, share=1e-4):
    """The card gate of the bf16 kernel (`_assert_bf16_attention_close`
    in test_torch_gpu.py): equal bits but for at most `share` of the
    elements, those within one bf16 ulp of the larger value."""
    assert o.dtype == ref.dtype == torch.bfloat16
    a, b = o.float(), ref.float()
    diff = (a - b).abs()
    assert bool((diff <= torch.maximum(a.abs(), b.abs()) * 2.0 ** -7).all())
    assert (diff > 0).float().mean().item() <= share


def _bf16_split_mirror(q, pool, table, ctx, cap, kps):
    """The bf16 kernel's split arithmetic in torch (tests only): the
    reference's rounding points as `attend_bf16` takes them, then each
    split of kps keys finds its (m, l) in float64, the splits' are
    combined in split order (M = max m_j, L = sum of l_j exp(m_j - M)),
    p = bf16(fp32(exp(s - M) / L)), and the float64 P.V partials of the
    splits are summed in split order and rounded once."""
    b, w, h, dh = q.shape
    _, bs, hk, _ = pool["k"].shape
    slots = table.shape[1] * bs
    bt = table.long()
    f64, bf = torch.float64, torch.bfloat16

    def view(key):
        x = pool[key][bt].reshape(b, slots, hk, dh).to(bf)
        if "ks" in pool:
            x = x * pool[key[0] + "s"][bt].reshape(b, slots, hk, 1).to(bf)
        return x.to(f64)

    k, v = view("k"), view("v")
    qg = q.reshape(b, w, hk, h // hk, dh).to(f64)
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32).item()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    s = (s.to(f64) * scale).float().to(f64)
    if cap > 0:
        s = (cap * torch.tanh(s / cap)).float().to(f64)
    pos = ctx.long()[:, None] + torch.arange(w)[None]
    seen = torch.arange(slots)[None, None, :] <= pos[:, :, None]
    s = torch.where(seen[:, None, None], s, torch.full_like(s, -torch.inf))
    cuts = list(range(0, slots, kps))
    ms, ls = [], []
    for c in cuts:
        part = s[..., c:c + kps]
        m = part.amax(-1, keepdim=True)
        e = torch.exp(part - torch.where(m > -torch.inf, m, 0.0))
        ms.append(m)
        ls.append(e.sum(-1, keepdim=True))
    big_m = torch.stack(ms).amax(0)
    big_l = torch.zeros_like(big_m)
    for m, lj in zip(ms, ls):
        big_l = big_l + torch.where(lj > 0, lj * torch.exp(m - big_m), 0.0)
    p = (torch.exp(s - big_m) / big_l).float().to(bf).to(f64)
    o = torch.zeros((b, w, hk, h // hk, dh), dtype=f64)
    for c in cuts:
        o = o + torch.einsum("bhgqk,bkhd->bqhgd", p[..., c:c + kps],
                             v[:, c:c + kps])
    return o.float().to(bf).reshape(b, w, h, dh)


def _bf16_attention_case(rng, quant, dh=64, hk=2, g=4, bs=16):
    """A bf16 span batch: 4 rows with contexts 0 (an idle row with no
    queries), 21, 50 and 63 (its last span position sees every slot of
    its table), 5 span positions, over random blocks of a bf16 pool or of
    int8 codes with fp32 scales."""
    b, w, mb, nb = 4, 5, 5, 24
    ctx = np.array([0, 21, 50, 63], np.int32)
    q = rng.standard_normal((b, w, hk * g, dh)).astype(np.float32)
    if quant:
        pool = {"k": rng.integers(-127, 128, (nb, bs, hk, dh), np.int8),
                "v": rng.integers(-127, 128, (nb, bs, hk, dh), np.int8),
                "ks": rng.uniform(1e-3, 2e-2, (nb, bs, hk, 1)).astype(
                    np.float32),
                "vs": rng.uniform(1e-3, 2e-2, (nb, bs, hk, 1)).astype(
                    np.float32)}
    else:
        pool = {key: rng.standard_normal((nb, bs, hk, dh)).astype(np.float32)
                for key in ("k", "v")}
    table = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tpool = {key: torch.from_numpy(a).to(torch.bfloat16)
             if a.dtype == np.float32 and key in ("k", "v")
             else torch.from_numpy(a) for key, a in pool.items()}
    return tq, tpool, torch.from_numpy(table.astype(np.int32)), \
        torch.from_numpy(ctx)


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_bf16_split_mirror_equals_plain(splits, quant, cap):
    """The kernel's split arithmetic (1 to 8 splits of the 80 slots, split
    order for m, l and the P.V partials) against `span_attend_gather`, the
    yardstick the card is held to, under the card's gate."""
    rng = np.random.default_rng(splits * 10 + quant)
    q, pool, table, ctx = _bf16_attention_case(rng, quant)
    kps = -(-table.shape[1] * 16 // splits)
    got = _bf16_split_mirror(q, pool, table, ctx, cap, kps)
    _assert_bf16_close(got, tpa.span_attend_gather(q, pool, table, ctx, cap))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dh,g", [(160, 4), (192, 12)])
def test_bf16_split_mirror_matches_reference_oracle(dh, g, quant):
    """The split arithmetic at 3 splits against the reference's
    `_span_attend_gather` at bf16, as test_torch_bf16.py holds the plain
    version, at stablelm's Dh 160 with a group of 4 and nemotron's Dh 192
    with a group of 12: at most 0.1% of elements differ, each by at most
    2^-7 of its row's largest value."""
    rng = np.random.default_rng(7 + quant + (0 if dh == 160 else dh))
    q, pool, table, ctx = _bf16_attention_case(rng, quant, dh=dh, hk=2,
                                               g=g)
    cfg = dataclasses.replace(j_get_config("stablelm-12b", smoke=True),
                              num_heads=2 * g, num_kv_heads=2, head_dim=dh)
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    jpool = {key: jnp.asarray(v.float().numpy(), jnp.bfloat16)
             if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
             for key, v in pool.items()}
    pos = jnp.asarray(ctx.numpy())[:, None] + jnp.arange(q.shape[1])[None]
    want = np.asarray(jattn._span_attend_gather(
        jq, jpool, jnp.asarray(table.numpy()), pos, cfg)).astype(np.float32)
    got = _bf16_split_mirror(q, pool, table, ctx, 0.0, 27).float().numpy()
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 1e-3
    assert (diff <= 2.0 ** -7 * np.abs(want).max(-1, keepdims=True)).all()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n,blocks", [(8, 128, 256, (8, 64, 256)),
                                          (24, 192, 512, (8, 64, 256))])
def test_quant_matmul_plain_matches_pallas_interpret(packed, m, k, n,
                                                     blocks):
    """The port's plain quant_matmul (which the CUDA kernel is held to on
    the card) against the reference Pallas kernel in interpret mode, bit
    for bit, on int8 carrier and packed W4 weights."""
    rng = np.random.default_rng(m + k + n + packed)
    wl = 4 if packed else 8
    xq = _codes(rng, (m, k), 8)
    sx = rng.uniform(0.01, 1, (m, 1)).astype(np.float32)
    w = _codes(rng, (k, n), wl)
    sw = rng.uniform(0.001, 0.01, (1, n)).astype(np.float32)
    jw = jquant.pack_int4(jnp.asarray(w)) if packed else jnp.asarray(w)
    tw = tquant.pack_int4(torch.from_numpy(w)) if packed else \
        torch.from_numpy(w)
    bm, bk, bn = blocks
    yj = jqm.quant_matmul(jnp.asarray(xq), jnp.asarray(sx), jw,
                          jnp.asarray(sw), bm=bm, bk=bk, bn=bn,
                          interpret=True, w_packed=packed)
    yt = tqm.quant_matmul_plain(torch.from_numpy(xq), torch.from_numpy(sx),
                                tw, torch.from_numpy(sw), w_packed=packed)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


QMM_SHAPES = [(512, 512), (512, 2048), (2048, 512), (512, 32000),
              (512, 544), (96, 36), (528, 512)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k,n", QMM_SHAPES)
@pytest.mark.parametrize("m", [1, 8, 16, 17, 256, 2048])
def test_quant_tile_choice(m, k, n, packed):
    """A 16-row strip at M <= 16 and wider tiles above; K slices that
    cover K once, none of them empty; every column of Y written by
    exactly one CTA of its cluster (N 544 and 36, launched at the width
    `ops.qmm` pads them to, 544 and 64, are ragged against the tile
    widths); two CTAs' shared memory on an SM; the decode shapes of the
    serving path fill the card (132 SMs) by splitting K, the lm head
    needs no split."""
    n = -(-n // 32) * 32
    t = tqm.choose_tiles(m, k, n, packed, 132, tqm.smem_bytes)
    assert t.bm == (16 if m <= 16 else 64 if m <= 256 else 128)
    assert t.bn in ((32, 64, 128) if t.bm == 16 else (64, 128))
    assert t.cluster in (1, 2, 4, 8) and (t.bn // t.cluster) % 2 == 0
    assert t.kslice % 32 == 0 and t.bk % 32 == 0
    assert t.cluster * t.kslice >= k > (t.cluster - 1) * t.kslice
    assert tqm.smem_bytes(*t[:3], packed, t.cluster,
                            t.kslice) <= tqm.SMEM_TWO_PER_SM
    share = t.bn // t.cluster
    cols = [x * t.bn + rank * share + c for x in range(-(-n // t.bn))
            for rank in range(t.cluster) for c in range(share)]
    assert sorted(c for c in cols if c < n) == list(range(n))
    if m == 8 and n in (512, 2048) and k in (512, 2048):
        assert t.cluster > 1 and 0.9 * 132 <= t.ctas(m, n) <= 132
    if (m, n) == (8, 32000):
        assert t.cluster == 1 and t.ctas(m, n) >= 132


def test_quant_tile_choice_refuses():
    with pytest.raises(ValueError, match="K % 16"):
        tqm.choose_tiles(8, 500, 512, False, 132, tqm.smem_bytes)
    with pytest.raises(ValueError, match="N % 32"):
        tqm.choose_tiles(8, 512, 510, False, 132, tqm.smem_bytes)
    with pytest.raises(ValueError, match="N % 32"):
        tqm.choose_tiles(8, 512, 36, False, 132, tqm.smem_bytes)
    with pytest.raises(ValueError, match="shared memory"):
        tqm.choose_tiles(8, 512, 512, True, 132, lambda *tiles: 1 << 30)


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch; any other
    device is refused, never silently computed elsewhere."""
    build.reset_launches()
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(_codes(rng, (4, 32), 8))
    sx = torch.ones(4, 1)
    wq = torch.from_numpy(_codes(rng, (32, 8), 8))
    y = tqm.quant_matmul(xq, sx, wq, torch.ones(1, 8))
    assert torch.equal(y, tqm.quant_matmul_plain(xq, sx, wq, torch.ones(1, 8)))
    assert sum(build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        tqm.quant_matmul(xq.to("meta"), sx.to("meta"), wq.to("meta"),
                         torch.ones(1, 8, device="meta"))
