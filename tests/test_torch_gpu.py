"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports nothing of jax, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips the repository's conftest, which imports jax.)
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import itera
from repro_torch.core import quant
from repro_torch.kernels import build
from repro_torch.kernels import lowrank_qmm as lr
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quant_matmul as qm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _codes(rng, shape, wl):
    m = quant.qmax(wl)
    return torch.from_numpy(rng.integers(-m, m + 1, size=shape).astype(np.int8))


def _uniform(rng, shape, lo, hi):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def _qmm_padded(xq, sx, wq, sw, packed):
    """The kernel on the arguments `ops.qmm` gives it (K padded to 16, N
    to 32, with zero codes and unit scales), cut back to N columns."""
    n = sw.shape[1]
    return qm.quant_matmul(*ops._qmm_args(xq, sx, wq, sw, packed),
                           w_packed=packed)[:, :n]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n", [(8, 512, 2048), (100, 96, 36),
                                   (3, 16, 4)])
def test_quant_matmul_kernel_equals_plain(cuda, packed, m, k, n):
    rng = np.random.default_rng(m + n)
    xq = _codes(rng, (m, k), 8).to(cuda)
    sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
    w = _codes(rng, (k, n), 4 if packed else 8).to(cuda)
    wq = quant.pack_int4(w) if packed else w
    sw = _uniform(rng, (1, n), 0.01, 1).to(cuda)
    before = build.LAUNCHES["quant_matmul"]
    y = _qmm_padded(xq, sx, wq, sw, packed)
    torch.cuda.synchronize()
    assert build.LAUNCHES["quant_matmul"] == before + 1
    assert torch.equal(y, qm.quant_matmul_plain(xq, sx, wq, sw,
                                                w_packed=packed))


def test_quant_matmul_refuses_unpadded_rows(cuda):
    """Weight rows that are not whole 16-byte chunks are refused, not
    copied: padding is `ops.qmm`'s."""
    xq = torch.zeros((8, 512), dtype=torch.int8, device=cuda)
    w = torch.zeros((512, 36), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="N % 32"):
        qm.quant_matmul(xq, torch.ones((8, 1), device=cuda), w,
                        torch.ones((1, 36), device=cuda))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (8, 512, 512),      # decode strip, K split over a cluster of 8 CTAs
    (8, 2048, 512),     # K 2048: 256-row slices
    (1, 512, 32000),    # the lm head: strip, no cluster, 250 column tiles
    (8, 528, 512),      # K 528: the cluster shrinks so no slice is empty
    (16, 512, 2080),    # ragged N against the strip's tiles
    (17, 96, 36),       # 64-row tile; N 36 launched padded to 64
    (256, 512, 512),    # 64-row tiles, K split over clusters of 4
    (2048, 512, 2048),  # wide prefill tile, 128 rows
    (300, 2048, 544),   # ragged M and N against 128 x 64 tiles
    (0, 512, 512),      # M 0: nothing to launch
])
def test_quant_matmul_tiles_equal_plain(cuda, packed, m, k, n):
    """Every branch of `choose_tiles` (split-K cluster, M <= 16 strip,
    wide prefill tile) bit-equal to the plain version; one launch counted
    under its (K, N)."""
    rng = np.random.default_rng(m + k + n)
    xq = _codes(rng, (m, k), 8).to(cuda)
    sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
    w = _codes(rng, (k, n), 4 if packed else 8).to(cuda)
    wq = quant.pack_int4(w) if packed else w
    sw = _uniform(rng, (1, n), 0.001, 0.01).to(cuda)
    np_ = -(-n // 32) * 32
    before = build.LAUNCH_SHAPES["quant_matmul", k, np_]
    y = _qmm_padded(xq, sx, wq, sw, packed)
    torch.cuda.synchronize()
    assert build.LAUNCH_SHAPES["quant_matmul", k, np_] == before + (m > 0)
    assert tuple(y.shape) == (m, n)
    assert torch.equal(y, qm.quant_matmul_plain(xq, sx, wq, sw,
                                                w_packed=packed))


@pytest.mark.parametrize("act_wl", [4, 8])
@pytest.mark.parametrize("m,k,r,n", [(8, 512, 256, 2048),
                                     (300, 2048, 256, 512),
                                     (5, 80, 12, 36)])
def test_lowrank_qmm_kernel_equals_plain(cuda, act_wl, m, k, r, n):
    """The fused cascade through `ops.lrmm` (which pads odd widths) is
    bit-equal to the plain cascade; its only allocation is Y."""
    rng = np.random.default_rng(m + act_wl)
    node = itera.LowRankQ(
        quant.QuantizedTensor(_codes(rng, (k, r), 4),
                              _uniform(rng, (1, r), 0.01, 0.1), 4, 0,
                              act_wl=act_wl),
        quant.QuantizedTensor(_codes(rng, (r, n), 4),
                              _uniform(rng, (r, 1), 0.01, 0.1), 4, 1,
                              act_wl=act_wl))
    node = itera.LowRankQ(quant.pack_weights(node.w1),
                          quant.pack_weights(node.w2)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(cuda)
    y = ops.lrmm(x, node)
    torch.cuda.synchronize()
    qmx = quant.qmax(act_wl)
    xq, sx = ops.quantize_acts(x, qmx)
    ref = lr.lowrank_qmm_plain(
        xq, sx, node.w1.values, node.w1.scale, node.w2.values,
        node.w2.scale, w1_packed=node.w1.packed, w2_packed=node.w2.packed,
        act_qmax=qmx)
    assert torch.equal(y, ref)
    assert torch.equal(ops.lrmm(x, node, fused=False), ref)


def test_lowrank_qmm_allocates_only_y(cuda):
    rng = np.random.default_rng(0)
    m, k, r, n = 8, 512, 256, 2048
    xq = _codes(rng, (m, k), 8).to(cuda)
    sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
    w1 = quant.pack_int4(_codes(rng, (k, r), 4)).to(cuda)
    w2 = quant.pack_int4(_codes(rng, (r, n), 4)).to(cuda)
    s1 = _uniform(rng, (1, r), 0.01, 0.1).to(cuda)
    s2 = _uniform(rng, (r, 1), 0.01, 0.1).to(cuda)
    lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, w1_packed=True, w2_packed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, w1_packed=True,
                       w2_packed=True)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - base
    assert grown == -(-y.numel() * 4 // 512) * 512


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("w", [1, 40])
def test_paged_attention_kernel_equals_plain(cuda, kv_bits, w):
    """Decode (W = 1) and prefill spans, ragged contexts, one idle row,
    G = 2 query heads per kv head; every position of every row, past
    q_lens and in the idle row too."""
    rng = np.random.default_rng(kv_bits + w)
    bs, hk, hd = 16, 2, 64
    ctx = np.array([37, 0, 5, 100], np.int32)
    ql = np.array([w, 0, w, 1], np.int32)
    mb = -(-int((ctx + ql).max()) // bs)
    table = np.zeros((len(ctx), mb), np.int32)
    nxt = 1
    for r in range(len(ctx)):
        need = -(-int(ctx[r] + ql[r]) // bs)
        table[r, :need] = np.arange(nxt, nxt + need)
        nxt += need
    shape = (nxt, bs, hk, hd)
    if kv_bits == 8:
        # scales of |k|, |v| up to ~3, as the serving path's K/V have
        pool = {"k": _codes(rng, shape, 8), "v": _codes(rng, shape, 8),
                "ks": _uniform(rng, (*shape[:-1], 1), 0.005, 0.025),
                "vs": _uniform(rng, (*shape[:-1], 1), 0.005, 0.025)}
    else:
        pool = {"k": torch.randn(shape), "v": torch.randn(shape)}
    pool = {key: v.to(cuda) for key, v in pool.items()}
    q = torch.from_numpy(rng.standard_normal(
        (len(ctx), w, 2 * hk, hd)).astype(np.float32)).to(cuda)
    tab, ctx_t = (torch.from_numpy(a).to(cuda) for a in (table, ctx))
    o = pa.paged_attention(q, pool, tab, ctx_t)
    torch.cuda.synchronize()
    ref = pa.span_attend_gather(q, pool, tab, ctx_t)
    torch.testing.assert_close(o, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,r,n", [
    (37, 512, 288, 544),    # M not a multiple of bm; R not of 8 x cluster
    (8, 16, 256, 2080),     # K 16; N not a multiple of the cluster span
    (2048, 512, 256, 2048),  # prefill: clusters split N, not R
    (8, 2048, 1024, 512),   # the widest rank slice (R 1024)
])
def test_lowrank_qmm_cluster_partitions(cuda, packed, m, k, r, n):
    """The kernel itself (no padding by ops) at shapes that leave rank
    slices, row blocks and cluster spans partly or wholly empty."""
    rng = np.random.default_rng(m + k + r + n)
    wl = 4 if packed else 8
    xq = _codes(rng, (m, k), 8).to(cuda)
    sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
    w1 = _codes(rng, (k, r), wl).to(cuda)
    w2 = _codes(rng, (r, n), wl).to(cuda)
    if packed:
        w1, w2 = quant.pack_int4(w1), quant.pack_int4(w2)
    s1 = _uniform(rng, (1, r), 0.01, 0.1).to(cuda)
    s2 = _uniform(rng, (r, 1), 0.01, 0.1).to(cuda)
    kw = dict(w1_packed=packed, w2_packed=packed, act_qmax=127)
    before = build.LAUNCHES["lowrank_qmm"]
    y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lowrank_qmm"] == before + 1
    assert torch.equal(y, lr.lowrank_qmm_plain(xq, sx, w1, s1, w2, s2, **kw))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,k,r,n,e", [
    (8, 2048, 1056, 2048, 1),    # wide slices of 160, the last one partial
    (2048, 3584, 1792, 4096, 1),  # gemma2's R at prefill (bm 32)
    (8, 5120, 2560, 5120, 1),    # phi3's R at r0.5, wide slices of 320
    (37, 1024, 4096, 544, 1),    # the widest slice (512), ragged M and N
    (8, 1024, 4128, 1024, 1),    # the smallest grouped R: 33 slices
    (300, 512, 9216, 2080, 1),   # grouped, ragged M and N
    (8, 2048, 1280, 2048, 8),    # an expert stack past 1024
    (40, 512, 4160, 512, 3),     # an expert stack on the grouped path
])
def test_lowrank_qmm_every_rank_equals_plain(cuda, packed, out_dtype, m, k,
                                             r, n, e):
    """Ranks past 1024: wide slices on chip and the grouped path, one
    matrix and an expert stack, fp32 and bf16 Y, bit-equal to the plain
    cascade; one call counted, under its rank and launch shape."""
    rng = np.random.default_rng(m + k + r + n + e)
    wl = 4 if packed else 8
    lead = (e,) if e > 1 else ()
    xq = _codes(rng, (*lead, m, k), 8).to(cuda)
    sx = _uniform(rng, (*lead, m, 1), 0.01, 1).to(cuda)
    w1 = _codes(rng, (*lead, k, r), wl).to(cuda)
    w2 = _codes(rng, (*lead, r, n), wl).to(cuda)
    if packed:
        w1, w2 = quant.pack_int4(w1), quant.pack_int4(w2)
    s1 = _uniform(rng, (*lead, 1, r), 0.01, 0.1).to(cuda)
    s2 = _uniform(rng, (*lead, r, 1), 0.01, 0.1).to(cuda)
    kw = dict(w1_packed=packed, w2_packed=packed, act_qmax=127,
              out_dtype=out_dtype)
    before = build.LAUNCHES["lowrank_qmm"], build.LAUNCH_RANKS[r]
    y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, **kw)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["lowrank_qmm"], build.LAUNCH_RANKS[r]) == (
        before[0] + 1, before[1] + 1)
    ref = lr.lowrank_qmm_plain(xq, sx, w1, s1, w2, s2, **kw)
    assert y.dtype == out_dtype
    assert torch.equal(y.view(torch.int16) if out_dtype == torch.bfloat16
                       else y, ref.view(torch.int16)
                       if out_dtype == torch.bfloat16 else ref)


def test_lowrank_qmm_grouped_path_captures(cuda):
    """The grouped path's two launches replay in a CUDA graph (its
    scratch comes from the graph's pool) with the plain version's bits."""
    rng = np.random.default_rng(5)
    m, k, r, n = 8, 512, 4224, 1024
    xq = _codes(rng, (m, k), 8).to(cuda)
    sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
    w1 = quant.pack_int4(_codes(rng, (k, r), 4)).to(cuda)
    w2 = quant.pack_int4(_codes(rng, (r, n), 4)).to(cuda)
    s1 = _uniform(rng, (1, r), 0.01, 0.1).to(cuda)
    s2 = _uniform(rng, (r, 1), 0.01, 0.1).to(cuda)
    kw = dict(w1_packed=True, w2_packed=True)
    assert lr.choose_tiles(m, r, n, build.sm_count(cuda.index or 0),
                           lr.smem_bytes).path == "grouped"
    lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, **kw)       # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, **kw)
    xq.copy_(_codes(rng, (m, k), 8).to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, lr.lowrank_qmm_plain(xq, sx, w1, s1, w2, s2, **kw))


def _pa_case(rng, ctx, ql, kv_bits, bs=16, hk=2, g=2, hd=64):
    """A span batch over fresh consecutive blocks with random history."""
    ctx, ql = np.array(ctx, np.int32), np.array(ql, np.int32)
    w = int(ql.max())
    mb = max(1, -(-int((ctx + ql).max()) // bs))
    table = np.zeros((len(ctx), mb), np.int32)
    nxt = 1
    for r in range(len(ctx)):
        need = -(-int(ctx[r] + ql[r]) // bs)
        table[r, :need] = np.arange(nxt, nxt + need)
        nxt += need
    shape = (nxt, bs, hk, hd)
    if kv_bits == 8:
        pool = {"k": _codes(rng, shape, 8), "v": _codes(rng, shape, 8),
                "ks": _uniform(rng, (*shape[:-1], 1), 0.005, 0.025),
                "vs": _uniform(rng, (*shape[:-1], 1), 0.005, 0.025)}
    else:
        pool = {"k": torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)),
                "v": torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32))}
    q = torch.from_numpy(rng.standard_normal(
        (len(ctx), w, g * hk, hd)).astype(np.float32))
    return q, pool, table, ctx, ql


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("kps", [None, 40, 16, 4096])
@pytest.mark.parametrize("ctx,ql", [
    ([0, 32, 0, 95], [1, 1, 0, 1]),     # context 0; block-aligned; idle row
    ([0, 48, 7, 200], [9, 0, 20, 3]),   # prefill tiles (W*G > 16)
])
def test_paged_attention_splits(cuda, kv_bits, kps, ctx, ql):
    """Split-KV decode and prefill tiles against the plain version: splits
    that end mid-block (40 keys), more splits than valid blocks (16 keys),
    one split (4096), and the chooser's own (None); every position."""
    rng = np.random.default_rng(sum(ctx) + kv_bits)
    q, pool, table, ctx, ql = _pa_case(rng, ctx, ql, kv_bits)
    pool = {key: v.to(cuda) for key, v in pool.items()}
    q = q.to(cuda)
    tab, ctx_t = (torch.from_numpy(a).to(cuda) for a in (table, ctx))
    o = pa.paged_attention(q, pool, tab, ctx_t, keys_per_split=kps)
    torch.cuda.synchronize()
    ref = pa.span_attend_gather(q, pool, tab, ctx_t)
    torch.testing.assert_close(o, ref, rtol=0, atol=1e-5)


# ---------------------------------------------- sampling on the card --

def test_threefry_on_cuda_equals_cpu(cuda):
    """prng_key, fold_in and uniform give the CPU's bits on the card (the
    int64-masked words make no use of unsigned or float arithmetic
    beyond the last float32 steps, which are exact on both)."""
    from repro_torch.runtime import prng

    rng = np.random.default_rng(0)
    seed = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 4096)
                            .astype(np.int32))
    data = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 4096)
                            .astype(np.int32))
    for dev in ("cpu", cuda):
        k = prng.fold_in(prng.fold_in(prng.prng_key(seed.to(dev)),
                                      data.to(dev)), 7)
        u = prng.uniform(k, float(np.finfo(np.float32).tiny))
        if dev == "cpu":
            k_cpu, u_cpu = k, u
    torch.cuda.synchronize()
    assert torch.equal(k.cpu(), k_cpu)
    assert torch.equal(u.cpu().view(torch.int32), u_cpu.view(torch.int32))


@pytest.mark.parametrize("vocab", [32000, 100])
def test_sample_tokens_on_cuda_equal_cpu(cuda, vocab):
    """The sampler's tokens on the card equal the CPU's, on rows mixing
    temperature, top-k and top-p, one of them with integer logits (ties
    at the 256-wide window's edge), over several key sets."""
    from repro_torch.runtime import sampling as smp

    rng = np.random.default_rng(vocab)
    b = 12
    logits = (rng.standard_normal((b, vocab)) * 3).astype(np.float32)
    logits[-1] = np.round(logits[-1])
    temp = torch.tensor([0, .7, 1.5, .7, 1.5, .7, 1.5, .7, 1.5, .7, 1.5, .9],
                        dtype=torch.float32)
    topk = torch.tensor([0, 0, 1, 40, 256, 300, 0, 40, 256, 0, 300, 0],
                        dtype=torch.int32)
    topp = torch.tensor([1, .3, .9, 1, .3, .9, 1, .9, .9, .3, 1, 1],
                        dtype=torch.float32)
    x = torch.from_numpy(logits)
    for trial in range(8):
        seed = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, b)
                                .astype(np.int32))
        rid = torch.from_numpy(rng.integers(0, 100, b).astype(np.int32))
        ctr = torch.from_numpy(rng.integers(0, 50, b).astype(np.int32))
        want = smp.sample_tokens(x, temp, topk, topp,
                                 smp.row_keys(seed, rid, ctr))
        got = smp.sample_tokens(
            x.to(cuda), temp.to(cuda), topk.to(cuda), topp.to(cuda),
            smp.row_keys(seed.to(cuda), rid.to(cuda), ctr.to(cuda)))
        assert torch.equal(got.cpu(), want), f"trial {trial}"


# ------------------------------------ the speculative path's new shapes --

@pytest.mark.parametrize("act_qmax", [127, 31])
@pytest.mark.parametrize("r", [128, 160, 192])
@pytest.mark.parametrize("k,n", [(512, 512), (512, 2048), (2048, 512)])
def test_lowrank_qmm_draft_ranks_equal_plain(cuda, act_qmax, r, k, n):
    """The draft pass's cascades: a decode step (M 8) at the truncated
    ranks of rank fractions 0.5, 0.625 and 0.75 of R 256 -- at R 160 and
    192 the cluster of 8 CTAs of 32 rank columns has CTAs with no rank
    columns -- and at the A6 draft's clamp (act_qmax 31). W1 is packed
    where the packing rule admits R (160, 192), W2 always."""
    rng = np.random.default_rng(r + k + n + act_qmax)
    xq = _codes(rng, (8, k), 6 if act_qmax == 31 else 8).to(cuda)
    sx = _uniform(rng, (8, 1), 0.01, 1).to(cuda)
    w1 = _codes(rng, (k, r), 4)
    w1p = quant.packable(quant.QuantizedTensor(w1, None, 4, 0))
    w1 = (quant.pack_int4(w1) if w1p else w1).to(cuda)
    w2 = quant.pack_int4(_codes(rng, (r, n), 4)).to(cuda)
    s1 = _uniform(rng, (1, r), 0.01, 0.1).to(cuda)
    s2 = _uniform(rng, (r, 1), 0.01, 0.1).to(cuda)
    kw = dict(w1_packed=w1p, w2_packed=True, act_qmax=act_qmax)
    before = build.LAUNCHES["lowrank_qmm"], build.LAUNCH_RANKS[r]
    y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, **kw)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["lowrank_qmm"], build.LAUNCH_RANKS[r]) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y, lr.lowrank_qmm_plain(xq, sx, w1, s1, w2, s2, **kw))


def test_lowrank_qmm_verify_span_equals_plain(cuda):
    """The verify pass: M 64 rows (8 rows x a W 8 span) at R 256."""
    rng = np.random.default_rng(64)
    m, r = 64, 256
    for k, n in ((512, 512), (512, 2048), (2048, 512)):
        xq = _codes(rng, (m, k), 8).to(cuda)
        sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
        w1 = quant.pack_int4(_codes(rng, (k, r), 4)).to(cuda)
        w2 = quant.pack_int4(_codes(rng, (r, n), 4)).to(cuda)
        s1 = _uniform(rng, (1, r), 0.01, 0.1).to(cuda)
        s2 = _uniform(rng, (r, 1), 0.01, 0.1).to(cuda)
        kw = dict(w1_packed=True, w2_packed=True)
        y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, lr.lowrank_qmm_plain(xq, sx, w1, s1, w2, s2,
                                                   **kw)), (k, n)


def test_quant_matmul_verify_lm_head_equals_plain(cuda):
    """The W8 lm head over k + 2 = 6 positions of 8 rows at verify."""
    rng = np.random.default_rng(48)
    xq = _codes(rng, (48, 512), 8).to(cuda)
    sx = _uniform(rng, (48, 1), 0.01, 1).to(cuda)
    w = _codes(rng, (512, 32000), 8).to(cuda)
    sw = _uniform(rng, (1, 32000), 0.001, 0.01).to(cuda)
    y = qm.quant_matmul(xq, sx, w, sw)
    torch.cuda.synchronize()
    assert torch.equal(y, qm.quant_matmul_plain(xq, sx, w, sw))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_attention_verify_spans(cuda, kv_bits):
    """Verify spans of 1 + drafts tokens (q_lens 1-5) in a W 8 bucket,
    G = 1 as in opus-mt, with an idle row; every position."""
    rng = np.random.default_rng(kv_bits)
    ctx = [40, 511, 0, 130, 300, 75, 220, 17]
    ql = [5, 3, 0, 1, 5, 2, 4, 5]
    q, pool, table, ctx, ql = _pa_case(rng, ctx, ql, kv_bits, hk=8, g=1)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 8 - q.shape[1]))
    pool = {key: v.to(cuda) for key, v in pool.items()}
    q = q.to(cuda)
    tab, ctx_t = (torch.from_numpy(a).to(cuda) for a in (table, ctx))
    o = pa.paged_attention(q, pool, tab, ctx_t)
    torch.cuda.synchronize()
    ref = pa.span_attend_gather(q, pool, tab, ctx_t)
    torch.testing.assert_close(o, ref, rtol=0, atol=1e-5)


# ------------------------- the compression slice: svd plans, calibration --

_LAYER_KN = ((512, 512), (512, 2048), (2048, 512))


@pytest.mark.parametrize("m,k,r,n", [
    (8, 512, 384, 512),       # the svd plan's decode: 2 of 8 CTAs empty
    (8, 512, 384, 2048),
    (8, 2048, 384, 512),
    (8, 512, 384, 32000),     # the lm head as a cascade
    (48, 512, 384, 32000),    # ... at the speculative verify's rows
    (2048, 512, 384, 512),    # the calibration forward, M = 8 x 256
    (2048, 512, 384, 32000),
    (8, 512, 96, 512),        # R 96: one of 4 CTAs without rank columns
    # the svd plan's draft (R 192) and the SRA plans (R 256, and 320,
    # where 3 of 8 CTAs get no rank columns) at decode
    *[(8, k, r, n) for r in (192, 256, 320) for k, n in _LAYER_KN],
    *[(8, 512, r, 32000) for r in (192, 256, 320)],
    # the svd plan's speculative verify: 8 rows x a span of 8
    *[(64, k, 384, n) for k, n in _LAYER_KN],
    # the calibration forward at the ranks SRA probes (256 -+ 64)
    *[(2048, k, r, n) for r in (192, 256, 320)
      for k, n in _LAYER_KN + ((512, 32000),)],
    (2048, 512, 384, 2048),
    (2048, 2048, 384, 512),
])
def test_lowrank_qmm_unpacked_w8_equals_plain(cuda, m, k, r, n):
    """W8 factors stay int8 carriers (no packing): both of them unpacked,
    codes over the whole +-127 range, bit-equal to the plain version; one
    launch counted at its rank."""
    rng = np.random.default_rng(m + k + r + n)
    xq = _codes(rng, (m, k), 8).to(cuda)
    sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
    w1 = _codes(rng, (k, r), 8).to(cuda)
    w2 = _codes(rng, (r, n), 8).to(cuda)
    s1 = _uniform(rng, (1, r), 0.001, 0.01).to(cuda)
    s2 = _uniform(rng, (r, 1), 0.001, 0.01).to(cuda)
    before = build.LAUNCHES["lowrank_qmm"], build.LAUNCH_RANKS[r]
    y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["lowrank_qmm"], build.LAUNCH_RANKS[r]) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y, lr.lowrank_qmm_plain(xq, sx, w1, s1, w2, s2))


def test_forward_on_the_card_gives_the_cpu_greedy_tokens(cuda):
    """The calibration forward of an svd W8 model (shaped spectra,
    compressed once on the CPU and copied to the card): the card's
    greedy token equals the CPU's at every position."""
    from repro_torch.api.engine import params_to
    from repro_torch.api.plan import CompressionPlan
    from repro_torch.configs import get_config
    from repro_torch.core.compress import compress_params, shape_spectra
    from repro_torch.models import transformer as tfm

    cfg = get_config("opus-mt", smoke=True)
    params = shape_spectra(tfm.init_params(cfg, seed=0), alpha=2.0)
    plan = CompressionPlan.uniform(params, method="svd", weight_wl=8,
                                   rank_fraction=0.75)
    cpu, _ = compress_params(params, plan)
    gpu = params_to(cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    before = build.LAUNCHES["lowrank_qmm"]
    with torch.inference_mode():
        lc = tfm.logits_for(cpu, tfm.forward(cpu, toks, cfg)[0], cfg)
        lg = tfm.logits_for(gpu, tfm.forward(gpu, toks.to(cuda), cfg)[0],
                            cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lowrank_qmm"] == before + 6 * cfg.num_layers + 1
    assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))


def _mixed_engines(cuda, kv_bits):
    """Smoke opus-mt with 2 heads of 32 (a head width the paged-attention
    kernel takes, for the serve beside generate) under the mixed plan
    (ITERA W4 r0.5 for every layer linear, quant W8 for the lm head),
    compressed once on the CPU: an engine on the CPU and one on the card
    over the same tensors."""
    import dataclasses

    from repro_torch.api.engine import InferenceEngine, params_to
    from repro_torch.api.plan import CompressionPlan, LayerPlan
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_config("opus-mt", smoke=True),
                              num_heads=2, num_kv_heads=2, head_dim=32,
                              kv_cache_bits=kv_bits)
    params = tfm.init_params(cfg, seed=0)
    base = CompressionPlan.uniform(params, method="itera", weight_wl=4,
                                   rank_fraction=0.5,
                                   exclude=r"(embed|norm|ln|lm_head)")
    plan = base.replace(layers=base.layers + (LayerPlan("lm_head", "quant",
                                                        8),))
    cpu = InferenceEngine.build(cfg, plan, params=params, device="cpu")
    gpu = InferenceEngine(cfg, params_to(cpu.params, cuda), device=cuda,
                          plan=cpu.plan)
    return cpu, gpu


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_generate_on_the_card_gives_the_cpu_tokens(cuda, kv_bits,
                                                   temperature):
    """A rectangular batch (11 tokens, bucket 16) greedy and seeded
    sampled: the card's tokens equal the CPU's and the card's serve of the
    same prompts."""
    from repro_torch.api.engine import SamplingParams

    cpu, gpu = _mixed_engines(cuda, kv_bits)
    prompts = np.random.default_rng(1).integers(
        1, cpu.cfg.vocab_size, (3, 11)).astype(np.int32)
    sp = SamplingParams(max_tokens=6, temperature=temperature, top_k=20,
                        top_p=0.9, seed=7)
    got = gpu.generate(prompts, sp).tokens
    np.testing.assert_array_equal(got, cpu.generate(prompts, sp).tokens)
    np.testing.assert_array_equal(
        got, np.stack(gpu.serve(list(prompts), sp).outputs))


def test_generate_launch_counts_on_the_card(cuda):
    """One prefill and max_tokens - 1 decode steps: every layer linear a
    lowrank_qmm launch a pass, the lm head one quant_matmul launch a pass
    (prefill's at its last position only), no paged attention."""
    from repro_torch.api.engine import SamplingParams

    _, gpu = _mixed_engines(cuda, 8)
    prompts = np.ones((4, 29), np.int32)
    gpu.generate(prompts, SamplingParams(max_tokens=2))     # builds kernels
    torch.cuda.synchronize()
    build.reset_launches()
    gpu.generate(prompts, SamplingParams(max_tokens=5))
    torch.cuda.synchronize()
    per_pass = 6 * gpu.cfg.num_layers
    assert dict(build.LAUNCHES) == {"lowrank_qmm": per_pass * 5,
                                    "quant_matmul": 5}
    # prefill runs 4 x 32 rows (the bucket), decode 4 rows
    bms = collections.Counter()
    for key, c in build.LAUNCH_SHAPES.items():
        if key[0] == "lowrank_qmm":
            bms[key[1]] += c
    assert bms[16] == per_pass * 4 and sum(bms.values()) == per_pass * 5


# ---------------------------------------------------------- step graphs --
def _eager_twin(gpu):
    """An engine over the same tensors on the card that runs every step
    eagerly (`cuda_graphs=False`)."""
    from repro_torch.api.engine import InferenceEngine

    return InferenceEngine(gpu.cfg, gpu.params, device=gpu.device,
                           plan=gpu.plan, cuda_graphs=False)


def _counts():
    return (dict(build.LAUNCHES), dict(build.LAUNCH_SHAPES),
            dict(build.LAUNCH_RANKS))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_step_replay_equals_eager(cuda, kv_bits):
    """`decode_step` at a device position as a captured step: each replay's
    logits and cache bit-equal to the eager step's on a copy of the same
    cache, and the launch counters after the graph's calls equal those
    of as many eager steps."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.graphs import StepGraph

    _, gpu = _mixed_engines(cuda, kv_bits)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        1, gpu.cfg.vocab_size, (3, 16)).astype(np.int32)).to(cuda)
    with torch.inference_mode():
        _, cache = tfm.prefill(gpu._step_params, prompts, gpu.cfg,
                               max_len=24)
        twin = {"kv": {k: v.clone() for k, v in cache["kv"].items()}}

        def step(cache, tok, pos):
            logits, _ = tfm.decode_step(gpu._step_params, cache, tok, pos,
                                        gpu.cfg)
            tok.copy_(torch.argmax(logits[:, -1], -1)[:, None].int())
            pos.add_(1)
            return (logits,)

        ins = {"cache": cache, "tok": prompts[:, -1:].clone(),
               "pos": torch.full((), 16, dtype=torch.long, device=cuda)}
        graph = StepGraph(step, ins, capture=True)
        tok, n = prompts[:, -1:].clone(), 6
        build.reset_launches()
        for i in range(n):
            got, = graph()
            want, twin = tfm.decode_step(gpu._step_params, twin, tok,
                                         16 + i, gpu.cfg)
            tok = torch.argmax(want[:, -1], -1)[:, None].int()
            assert torch.equal(got, want), i
            for k, v in twin["kv"].items():
                assert torch.equal(cache["kv"][k], v), (i, k)
        torch.cuda.synchronize()
        assert graph.graph is not None
        counts = _counts()
        assert counts[0]["lowrank_qmm"] == 2 * n * 6 * gpu.cfg.num_layers
        assert counts[0]["quant_matmul"] == 2 * n
        for c in counts:
            assert all(v % 2 == 0 for v in c.values())


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_unified_step_replay_equals_eager(cuda, kv_bits):
    """One serving step over the blocked pool (a prefill chunk of 8 beside
    two decode rows, W 8) as a captured step: its replay's logits and
    pool bit-equal to the eager step's on a copy of the pool."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import kvblocks
    from repro_torch.runtime.graphs import StepGraph

    _, gpu = _mixed_engines(cuda, kv_bits)
    cfg = gpu.cfg
    rng = np.random.default_rng(3)
    pool = kvblocks.init_paged_cache(cfg, 13, 4, cuda)
    for name, leaf in pool.items():     # a history of random K/V
        if leaf.dtype == torch.int8:
            vals = rng.integers(-127, 128, leaf.shape)
        elif name in ("ks", "vs"):
            vals = rng.uniform(0.005, 0.02, leaf.shape)
        else:
            vals = rng.standard_normal(leaf.shape)
        leaf.copy_(torch.from_numpy(vals).to(leaf.dtype))
    twin = {k: v.clone() for k, v in pool.items()}
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 10, 11]],
                          dtype=torch.int32, device=cuda)
    ctx = torch.tensor([4, 9, 13], dtype=torch.int32, device=cuda)
    ql = torch.tensor([8, 1, 1], dtype=torch.int32, device=cuda)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, 8)).astype(
        np.int32)).to(cuda)

    def step(pool, tables, ctx, ql, toks):
        logits, _ = tfm.unified_step(gpu._step_params, pool, tables, ctx,
                                     ql, toks, cfg)
        return (logits,)

    with torch.inference_mode():
        graph = StepGraph(step, {"pool": pool, "tables": tables, "ctx": ctx,
                                 "ql": ql, "toks": toks}, capture=True)
        graph()                             # warm-up and capture
        for leaf, t in zip(pool.values(), twin.values()):
            leaf.copy_(t)
        got, = graph()                      # a replay
        want, _ = tfm.unified_step(gpu._step_params, twin, tables, ctx, ql,
                                   toks, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k in pool:      # the trash block too: its last pad slot wins
        assert torch.equal(pool[k], twin[k]), k


@pytest.mark.parametrize("mode", ["greedy", "sampled_stops", "speculative"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_captured_serve_equals_eager(cuda, kv_bits, mode):
    """A serve whose steps replay CUDA graphs against the same serve run
    eagerly on the card: identical tokens, launch counters and final KV
    pool; captured twice, the second on the held graphs."""
    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.runtime.speculation import DraftSpec

    _, base = _mixed_engines(cuda, kv_bits)
    spec = DraftSpec(k=3) if mode == "speculative" else None
    gpu, eager = (InferenceEngine(base.cfg, base.params, device=cuda,
                                  plan=base.plan, speculate=spec,
                                  cuda_graphs=graphs)
                  for graphs in (True, False))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, gpu.cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 17, 23, 9)]
    sp = SamplingParams(max_tokens=7)
    if mode == "sampled_stops":
        sp = SamplingParams(max_tokens=7, temperature=0.8, top_k=20,
                            top_p=0.9, seed=7, eos_id=11, stop=((5, 6),))
    runs = []
    for eng in (eager, gpu, gpu):
        build.reset_launches()
        res = eng.serve(prompts, sp)
        torch.cuda.synchronize()
        slot = next(reversed(eng._serve_slots.values()))
        runs.append((res, _counts(), {k: v.clone()
                                      for k, v in slot.pool.items()}))
    (want, wcounts, wpool) = runs[0]
    assert eager.graph_stats()["graphs"] == 0
    assert gpu.graph_stats()["graphs"] > 0
    for res, counts, pool in runs[1:]:
        for a, b in zip(res.outputs, want.outputs):
            np.testing.assert_array_equal(a, b)
        assert counts == wcounts
        for k in pool:
            assert torch.equal(pool[k], wpool[k]), k


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_generate_equals_eager(cuda, temperature):
    """generate's decode steps replayed against the eager loop on the
    card: identical tokens and launch counters, twice."""
    from repro_torch.api.engine import SamplingParams

    _, gpu = _mixed_engines(cuda, 8)
    eager = _eager_twin(gpu)
    prompts = np.random.default_rng(5).integers(
        1, gpu.cfg.vocab_size, (4, 13)).astype(np.int32)
    sp = SamplingParams(max_tokens=9, temperature=temperature, top_k=20,
                        top_p=0.9, seed=7)
    runs = []
    for eng in (eager, gpu, gpu):
        build.reset_launches()
        toks = eng.generate(prompts, sp).tokens
        torch.cuda.synchronize()
        runs.append((toks, _counts()))
    assert gpu.graph_stats()["graphs"] == 1
    for toks, counts in runs[1:]:
        np.testing.assert_array_equal(toks, runs[0][0])
        assert counts == runs[0][1]


def test_capturing_a_step_that_syncs_with_the_host_raises(cuda, tmp_path):
    """A step that reads a value back to the host (`.item()`) runs in its
    warm-up and makes the capture raise; nothing falls back to eager. In
    its own interpreter: a failed capture leaves that process's CUDA state
    unusable."""
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = (
        "import torch\n"
        "from repro_torch.runtime.graphs import StepGraph\n"
        "x = torch.arange(4, device='cuda')\n"
        "calls = []\n"
        "def step(x):\n"
        "    calls.append(int(x.sum().item()))\n"
        "    return (x + 1,)\n"
        "g = StepGraph(step, {'x': x}, capture=True)\n"
        "try:\n"
        "    g()\n"
        "except RuntimeError as e:\n"
        "    print('raised', calls, g.graph is None, str(e).splitlines()[0])\n"
        "else:\n"
        "    print('captured')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(src)})
    assert r.stdout.startswith("raised [6] True"), r.stdout + r.stderr


def test_capture_survives_a_dropped_engine(cuda):
    """An engine dropped with captured graphs (its steps' closures hold
    it in a reference cycle, so only the garbage collector frees them)
    does not break the next engine's capture, even with the collector
    set to run at nearly every allocation: freeing a graph during a
    capture would invalidate it."""
    import gc

    from repro_torch.api.engine import SamplingParams

    prompts = np.ones((2, 9), np.int32)
    sp = SamplingParams(max_tokens=3)
    _, first = _mixed_engines(cuda, 16)
    first.generate(prompts, sp)
    assert first.graph_stats()["graphs"] == 1
    del first
    _, second = _mixed_engines(cuda, 16)
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        second.generate(prompts, sp)
    finally:
        gc.set_threshold(*old)
    torch.cuda.synchronize()
    assert second.graph_stats()["graphs"] == 1


# chip_smoke.py phase 2's shapes and the dse phase's (M 512): every
# partition the choosers return there, at the card's SM count
_MIRROR_M = (1, 8, 16, 17, 48, 64, 256, 512, 1024, 2048)
_MIRROR_KN = ((512, 512), (512, 2048), (2048, 512), (512, 32000))


def test_quant_matmul_smem_mirror_equals_library(cuda):
    """`quant_matmul.smem_bytes` (Python) equals the library's
    `qmm_smem_bytes` at every partition `choose_tiles` returns, and the
    two give the same partition; also across every compiled tile."""
    lib = build.load("quant_matmul", qm._SIGNATURES)
    sms = build.sm_count(cuda.index or 0)
    for m in _MIRROR_M:
        for k, n in _MIRROR_KN + ((528, 512), (96, 64)):
            for packed in (False, True):
                t = qm.choose_tiles(m, k, n, packed, sms, lib.qmm_smem_bytes)
                assert t == qm.choose_tiles(m, k, n, packed, sms,
                                            qm.smem_bytes)
                args = (*t[:3], int(packed), t.cluster, t.kslice)
                assert qm.smem_bytes(*args) == lib.qmm_smem_bytes(*args)
    for bm, bn in qm.TILE_SHAPES + ((32, 32),):
        for bk in (32, 64, 256, 1024):
            for args in ((bm, bn, bk, p, c, ks) for p in (0, 1)
                         for c in (1, 2, 8) for ks in (32, 512, 2048)):
                assert qm.smem_bytes(*args) == lib.qmm_smem_bytes(*args)


def test_lowrank_qmm_smem_mirror_equals_library(cuda):
    """`lowrank_qmm.smem_bytes` equals `lrmm_smem_bytes` at every
    partition `choose_tiles` returns for the served ranks and widths."""
    lib = build.load("lowrank_qmm", lr._SIGNATURES)
    sms = build.sm_count(cuda.index or 0)
    for m in _MIRROR_M:
        for r in (32, 128, 160, 192, 256, 320, 384, 512, 1024, 1056,
                  1792, 2560, 4096, 4128, 9216, 18432):
            for n in (512, 2048, 32000):
                t = lr.choose_tiles(m, r, n, sms, lib.lrmm_smem_bytes)
                assert t == lr.choose_tiles(m, r, n, sms, lr.smem_bytes)
                assert lr.smem_bytes(*t) == lib.lrmm_smem_bytes(*t)


def test_paged_attention_smem_mirror_equals_library(cuda):
    lib = build.load("paged_attention", pa._SIGNATURES)
    for qt in (pa.QT_DECODE, pa.QT_PREFILL):
        for dh in (32, 64, 128):
            for quant in (0, 1):
                for bs in (4, 8, 16, 32, 64, 128):
                    assert pa.smem_bytes(qt, dh, quant, bs) == \
                        lib.paged_attention_smem_bytes(qt, dh, quant, bs)


# ------------------------------------------------------------- training --
def _smoke_train(device, steps=3):
    """Losses and grad norms of `steps` train steps of opus-mt smoke from
    seed-0 weights on Markov batches, on `device`."""
    from repro_torch.api.engine import _full_fp32, params_to
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTask
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    _full_fp32()
    cfg = get_config("opus-mt", smoke=True)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=steps)
    params = params_to(tfm.init_params(cfg, seed=0), device)
    state = adamw.init(params, opt)
    step = make_train_step(cfg, opt)
    task = MarkovTask(cfg.vocab_size, seed=0)
    out = []
    for s in range(steps):
        params, state, m = step(params, state,
                                task.batch(s, 4, 32, device=device))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def test_smoke_train_step_card_equals_cpu(cuda):
    """Three smoke train steps from the same weights and batches: the
    card's losses and grad norms within 1e-5 relative of the CPU's."""
    for (lg, gg), (lc, gc_) in zip(_smoke_train(cuda),
                                   _smoke_train(torch.device("cpu"))):
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        assert abs(gg - gc_) <= 1e-5 * abs(gc_)


def test_checkpoint_round_trip_from_cuda_tensors(cuda, tmp_path):
    """A train state and a compressed tree on the card saved and restored
    onto the card: equal tensors, on the card; `bridge` reads the same."""
    from repro_torch import bridge
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.compress import CompressionConfig, compress_params
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    cfg = get_config("opus-mt", smoke=True)
    params = tfm.init_params(cfg, seed=1, device=cuda)
    state = {"params": params,
             "opt": adamw.init(params, adamw.AdamWConfig(state_bits=8))}
    comp, _ = compress_params(params, CompressionConfig(method="itera",
                                                        weight_wl=4))
    for name, tree in (("state", state), ("compressed", comp)):
        ckpt.save(str(tmp_path / name), 5, tree)
        got, step = ckpt.restore(str(tmp_path / name), tree)
        assert step == 5
        a, b = ckpt.flatten(tree), ckpt.flatten(got)
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k].device.type == "cuda" and torch.equal(a[k], b[k]), k
    host = ckpt.flatten(bridge.load_checkpoint(str(tmp_path / "compressed")))
    for k, v in ckpt.flatten(comp).items():
        assert torch.equal(host[k], v.cpu()), k


# ------------------------------------------------------- expert stacks --
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("e,m,k,r,n", [(1, 8, 512, 256, 2048),
                                       (64, 1, 2048, 704, 1408),
                                       (8, 40, 1408, 704, 2048),
                                       (3, 100, 96, 64, 160)])
def test_stacked_kernels_equal_plain(cuda, packed, e, m, k, r, n):
    """Both kernels over an expert stack: one launch, bit-equal to the
    plain version and to each expert's single-matrix launch."""
    rng = np.random.default_rng(e + m)
    wl = 4 if packed else 8
    xq = _codes(rng, (e, m, k), 8).to(cuda)
    sx = _uniform(rng, (e, m, 1), 0.01, 1).to(cuda)
    w = _codes(rng, (e, k, n), wl).to(cuda)
    wq = quant.pack_int4(w) if packed else w
    sw = _uniform(rng, (e, 1, n), 0.001, 0.01).to(cuda)
    before = build.LAUNCHES["quant_matmul"]
    y = qm.quant_matmul(xq, sx, wq, sw, w_packed=packed)
    assert build.LAUNCHES["quant_matmul"] == before + 1
    assert torch.equal(y, qm.quant_matmul_plain(xq, sx, wq, sw,
                                                w_packed=packed))
    assert torch.equal(y[-1], qm.quant_matmul(
        xq[-1].contiguous(), sx[-1].contiguous(), wq[-1].contiguous(),
        sw[-1].contiguous(), w_packed=packed))
    w1 = _codes(rng, (e, k, r), wl).to(cuda)
    w2 = _codes(rng, (e, r, n), wl).to(cuda)
    s1 = _uniform(rng, (e, 1, r), 0.01, 0.1).to(cuda)
    s2 = _uniform(rng, (e, r, 1), 0.01, 0.1).to(cuda)
    args = (xq, sx, quant.pack_int4(w1) if packed else w1, s1,
            quant.pack_int4(w2) if packed else w2, s2)
    kw = dict(w1_packed=packed, w2_packed=packed)
    before = build.LAUNCHES["lowrank_qmm"]
    y = lr.lowrank_qmm(*args, **kw)
    assert build.LAUNCHES["lowrank_qmm"] == before + 1
    assert torch.equal(y, lr.lowrank_qmm_plain(*args, **kw))
    assert torch.equal(y[0], lr.lowrank_qmm(
        *(a[0].contiguous() for a in args), **kw))


@pytest.mark.parametrize("plan", ["quant", "itera"])
def test_moe_captured_serve_equals_eager_and_cpu(cuda, plan):
    """deepseek-moe-16b smoke on the card: captured and eager serves give
    the CPU's tokens and the same launch counters, one launch for each
    expert projection of a layer."""
    from repro_torch.api.engine import (InferenceEngine, SamplingParams,
                                        params_to)
    from repro_torch.core.compress import CompressionConfig

    from repro_torch.configs import get_config

    spec = CompressionConfig(method=plan, weight_wl=4, rank_fraction=0.5)
    # the smoke config with 2 heads of 32 (the kernel takes Dh 32, 64, 128)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              num_heads=2, num_kv_heads=2, head_dim=32)
    cpu = InferenceEngine.build(cfg, spec, device="cpu", max_batch=3,
                                block_size=4, chunk_tokens=8)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (13, 5, 9)]
    sp = SamplingParams(max_tokens=5)
    want = cpu.serve(prompts, sp)
    runs = []
    for graphs in (False, True):
        eng = InferenceEngine(cpu.cfg, params_to(cpu.params, cuda),
                              device=cuda, plan=cpu.plan, max_batch=3,
                              block_size=4, chunk_tokens=8,
                              cuda_graphs=graphs)
        build.reset_launches()
        res = eng.serve(prompts, sp)
        torch.cuda.synchronize()
        runs.append(_counts())
        for a, b in zip(res.outputs, want.outputs):
            np.testing.assert_array_equal(a, b)
    assert runs[0] == runs[1]
    # a step: 2 layers x (4 attention + 3 expert + 3 shared projections)
    # and the lm head, every one a single launch, and 2 attention launches
    name = "quant_matmul" if plan == "quant" else "lowrank_qmm"
    assert runs[0][0] == {name: (2 * (4 + 3 + 3) + 1) * res.steps,
                          "paged_attention": 2 * res.steps}


def test_unpack_int4_on_cuda_equals_cpu(cuda):
    b = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    assert torch.equal(quant.unpack_int4(b.to(cuda)).cpu(),
                       quant.unpack_int4(b))


# ---------------------------------------------------------- bfloat16 --
@pytest.mark.parametrize("m,k,n,packed,e", [
    (8, 5120, 1280, True, 1),     # decode strip, K split over a cluster
    (8, 17920, 5120, True, 1),    # phi3's mlp/down at decode
    (8, 5120, 100352, False, 1),  # the bf16 model's lm head shape (W8)
    (300, 512, 544, False, 1),    # ragged M and N, 128 x 64 tiles
    (2048, 512, 2048, True, 1),   # wide prefill tile
    (5, 256, 512, True, 4),       # an expert stack
])
def test_quant_matmul_bf16_epilogue_equals_plain(cuda, m, k, n, packed, e):
    """The kernel's bf16 epilogue is the plain float32 value rounded to
    nearest even, bit for bit, at every kind of tile."""
    rng = np.random.default_rng(m + k + n + e)
    lead = (e,) if e > 1 else ()
    xq = _codes(rng, (*lead, m, k), 8).to(cuda)
    sx = _uniform(rng, (*lead, m, 1), 0.01, 1).to(cuda)
    w = _codes(rng, (*lead, k, n), 4 if packed else 8).to(cuda)
    wq = quant.pack_int4(w) if packed else w
    sw = _uniform(rng, (*lead, 1, n), 0.001, 0.01).to(cuda)
    before = build.LAUNCHES["quant_matmul"]
    y = qm.quant_matmul(xq, sx, wq, sw, w_packed=packed,
                        out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["quant_matmul"] == before + 1
    assert y.dtype == torch.bfloat16
    want = qm.quant_matmul_plain(xq, sx, wq, sw, w_packed=packed,
                                 out_dtype=torch.bfloat16)
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("m,k,r,n,packed", [
    (8, 5120, 1024, 5120, True),     # phi3 wq/wo at rank fraction 0.2
    (8, 5120, 256, 1280, True),      # phi3 wk/wv
    (8, 17920, 1024, 5120, True),    # phi3 mlp/down
    (300, 5120, 1024, 17920, True),  # a prefill chunk through mlp/up
    (37, 512, 288, 544, False),      # ragged everything, carrier layout
])
def test_lowrank_qmm_bf16_epilogue_equals_plain(cuda, m, k, r, n, packed):
    """The cascade's bf16 epilogue is the plain float32 value rounded to
    nearest even, bit for bit."""
    rng = np.random.default_rng(m + k + r + n)
    wl = 4 if packed else 8
    xq = _codes(rng, (m, k), 8).to(cuda)
    sx = _uniform(rng, (m, 1), 0.01, 1).to(cuda)
    w1 = _codes(rng, (k, r), wl).to(cuda)
    w2 = _codes(rng, (r, n), wl).to(cuda)
    if packed:
        w1, w2 = quant.pack_int4(w1), quant.pack_int4(w2)
    s1 = _uniform(rng, (1, r), 0.01, 0.1).to(cuda)
    s2 = _uniform(rng, (r, 1), 0.01, 0.1).to(cuda)
    kw = dict(w1_packed=packed, w2_packed=packed, act_qmax=127,
              out_dtype=torch.bfloat16)
    before = build.LAUNCHES["lowrank_qmm"]
    y = lr.lowrank_qmm(xq, sx, w1, s1, w2, s2, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["lowrank_qmm"] == before + 1
    want = lr.lowrank_qmm_plain(xq, sx, w1, s1, w2, s2, **kw)
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))


def _assert_bf16_attention_close(o, ref):
    """The bf16 kernel against its plain version: equal bits but for at
    most 1 element in 10,000, and those within one bf16 ulp (float64 sums
    in other orders meeting a bf16 rounding boundary of p or the
    output)."""
    assert o.dtype == ref.dtype == torch.bfloat16
    a, b = o.float(), ref.float()
    diff = (a - b).abs()
    ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
    assert bool((diff <= ulp).all())
    assert (diff > 0).float().mean().item() <= 1e-4


@pytest.mark.parametrize("dh", [32, 64, 128, 160, 192])
@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("ctx,ql,cap,kps", [
    ([37, 0, 5, 100], [1, 0, 1, 1], 0.0, None),    # decode, one idle row
    ([0, 48, 7, 200], [64, 0, 20, 3], 0.0, None),  # prefill spans (W*G 256)
    ([4095, 0, 17, 1000], [1, 0, 1, 1], 0.0, None),  # 4096 keys, 8 splits
    ([10, 0, 30], [3, 1, 2], 0.0, None),     # W*G 12: two decode tiles
    ([63, 5, 20], [1, 1, 1], 5.0, None),     # row 0 fills its block table
    ([48, 0, 7], [16, 3, 9], 5.0, None),     # ... in a prefill tile
    ([37, 0, 5, 100], [1, 0, 1, 1], 0.0, 40),   # forced splits mid-block
    ([0, 48, 7, 200], [64, 0, 20, 3], 0.0, 100),
])
def test_paged_attention_bf16_equals_plain(cuda, dh, kv_bits, ctx, ql, cap,
                                           kps):
    """bf16 q over a bf16 pool (kv 16) or int8 codes with fp32 scales, Dh
    32 to 192 (phi3 128, stablelm 160, nemotron 192), 4 query heads a kv
    head (12 at Dh 192, nemotron's group, whose decode rows span two
    tiles), every position of every row: decode tiles split over a
    cluster, up to 4096 keys, two of them a row; prefill tiles; a row
    whose keys fill its whole block table; softcap; key splits forced
    mid-block. One launch a call."""
    rng = np.random.default_rng(dh + kv_bits + sum(ql) + sum(ctx))
    q, pool, table, ctx_a, _ = _pa_case(rng, ctx, ql, kv_bits,
                                        g=12 if dh == 192 else 4, hd=dh)
    q = q.to(torch.bfloat16)
    if kv_bits == 16:
        pool = {k: v.to(torch.bfloat16) for k, v in pool.items()}
    pool = {key: v.to(cuda) for key, v in pool.items()}
    tab, ctx_t = (torch.from_numpy(a).to(cuda) for a in (table, ctx_a))
    before = build.LAUNCHES["paged_attention"]
    o = pa.paged_attention(q.to(cuda), pool, tab, ctx_t, logit_softcap=cap,
                           keys_per_split=kps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_attention"] == before + 1
    _assert_bf16_attention_close(
        o, pa.span_attend_gather(q.to(cuda), pool, tab, ctx_t, cap))


def test_paged_attention_bf16_smem_mirror_equals_library(cuda):
    lib = build.load("paged_attention", pa._SIGNATURES)
    for qt in (pa.BF16_QT_DECODE, pa.BF16_QT_PREFILL):
        for dh in pa.DH_BF16:
            for quant in (0, 1):
                for splits in range(1, pa.BF16_CLUSTER + 1):
                    assert pa.bf16_smem_bytes(qt, dh, quant, splits) == \
                        lib.paged_attention_bf16_smem_bytes(qt, dh, quant,
                                                            splits)


def test_paged_attention_bf16_refuses_what_it_cannot_take(cuda):
    """A bf16 q over an fp32 pool, a head dim the kernel lacks, and more
    key splits than a cluster holds raise on the card: nothing falls back
    to the plain version."""
    rng = np.random.default_rng(0)
    q, pool, table, ctx, _ = _pa_case(rng, [3], [1], 16, hd=64)
    tab, ctx_t = (torch.from_numpy(a).to(cuda) for a in (table, ctx))
    pool = {key: v.to(cuda) for key, v in pool.items()}
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_attention(q.to(cuda, torch.bfloat16), pool, tab, ctx_t)
    q, pool, table, ctx, _ = _pa_case(rng, [3], [1], 16, hd=96)
    pool = {key: v.to(cuda, torch.bfloat16) for key, v in pool.items()}
    with pytest.raises(ValueError, match="Dh"):
        pa.paged_attention(q.to(cuda, torch.bfloat16), pool, tab, ctx_t)
    with pytest.raises(ValueError, match="Dh"):
        pa.paged_attention(q.to(cuda), {k: v.float() for k, v in
                                        pool.items()}, tab, ctx_t)
    q, pool, table, ctx, _ = _pa_case(rng, [3], [1], 16, hd=64)
    pool = {key: v.to(cuda, torch.bfloat16) for key, v in pool.items()}
    with pytest.raises(ValueError, match="key splits"):
        pa.paged_attention(q.to(cuda, torch.bfloat16), pool, tab, ctx_t,
                           keys_per_split=1)


# The Mamba layouts' linears at their full widths (falcon-mamba-7b,
# zamba2-2.7b at rank fraction 0.5): (K, R, N, X dtype, Y dtype), R the
# ITERA rank (unpadded: 16 and 40 pad to 32 and 64, N 80 to 96)
_MAMBA_LINEARS = [
    (4096, 2048, 16384, torch.bfloat16, torch.bfloat16),   # in_proj
    (8192, 128, 256, torch.bfloat16, torch.float32),       # dt_in
    (8192, 16, 32, torch.bfloat16, torch.float32),         # bc_proj
    (256, 128, 8192, torch.float32, torch.float32),        # dt_proj
    (8192, 2048, 4096, torch.bfloat16, torch.bfloat16),    # out_proj
    (2560, 1280, 10240, torch.bfloat16, torch.bfloat16),   # zx_proj, up
    (2560, 64, 128, torch.bfloat16, torch.bfloat16),       # bc_in
    (2560, 40, 80, torch.bfloat16, torch.float32),         # dt_lin
    (5120, 1280, 2560, torch.bfloat16, torch.bfloat16),    # out_proj
    (2560, 1280, 2560, torch.bfloat16, torch.bfloat16),    # wq/wk/wv/wo
    (10240, 1280, 2560, torch.bfloat16, torch.bfloat16),   # down
]


def _w4(rng, shape, axis):
    """A W4 node as compression stores it: packed where the rule packs."""
    scale_shape = (1, shape[1]) if axis == 0 else (shape[0], 1)
    return quant.pack_weights(quant.QuantizedTensor(
        _codes(rng, shape, 4), _uniform(rng, scale_shape, 0.001, 0.02), 4,
        axis))


@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("k,r,n,xd,yd", _MAMBA_LINEARS)
def test_mamba_linears_on_the_card_equal_the_cpu(cuda, m, k, r, n, xd, yd):
    """`ops.qmm` (W4) and `ops.lrmm` (ITERA W4) at the Mamba layouts'
    shapes and dtype pairs (a bf16 X to an fp32 Y; an fp32 X in a bf16
    model), the activations' quantization included: the card's kernels
    give the CPU's plain bits, one launch a call."""
    rng = np.random.default_rng(k + r + n + m)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        xd)
    nodes = [_w4(rng, (k, n), 0),
             itera.LowRankQ(_w4(rng, (k, r), 0), _w4(rng, (r, n), 1))]
    for w, fn, name in zip(nodes, (ops.qmm, ops.lrmm),
                           ("quant_matmul", "lowrank_qmm")):
        before = build.LAUNCHES[name]
        y = fn(x.to(cuda), w.to(cuda), out_dtype=yd)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == before + 1
        want = fn(x, w, out_dtype=yd)
        assert y.dtype == want.dtype == yd and y.shape == (m, n)
        assert torch.equal(y.cpu().view(torch.int16 if yd == torch.bfloat16
                                        else torch.int32),
                           want.view(torch.int16 if yd == torch.bfloat16
                                     else torch.int32))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_mamba_generate_on_the_card_gives_the_cpu_tokens(cuda, arch):
    """The smoke config in bf16 with every projection under ITERA W4 r0.5
    (the narrow ones too, so no dense bf16 matmul is left to sum in
    another order on the card; the hybrid's shared block too) and a W8
    head: `generate` captured on the card, greedy and sampled, gives the
    CPU's tokens, with exact launches a pass and none of
    paged_attention."""
    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.api.plan import CompressionPlan, LayerPlan
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params = init_params(cfg, seed=0)
    base = CompressionPlan.uniform(
        params, method="itera", weight_wl=4, rank_fraction=0.5, min_dim=4,
        exclude=r"(embed|norm|ln|lm_head|A_log|bias|conv|/D$)")
    plan = base.replace(layers=base.layers + (LayerPlan("lm_head", "quant",
                                                        8),))
    cpu = InferenceEngine.build(cfg, plan, params=params, device="cpu")
    gpu = InferenceEngine.build(cfg, None, params=cpu.params, device=cuda)
    invocations = cfg.num_layers // cfg.hybrid_period
    per_pass = sum(cfg.num_layers if lp.path.startswith("layers/")
                   else invocations for lp in base.layers)
    assert per_pass == cfg.num_layers * (5 if cfg.ssm.version == 1 else 4) \
        + (6 * invocations if cfg.layout == "hybrid" else 0)
    prompts = np.random.default_rng(1).integers(1, 256, (3, 12)).astype(
        np.int32)
    for sp in (SamplingParams(max_tokens=6),
               SamplingParams(max_tokens=6, temperature=0.8, top_k=20,
                              seed=3)):
        gpu.generate(prompts, sp)
        build.reset_launches()
        got = gpu.generate(prompts, sp).tokens
        torch.cuda.synchronize()
        assert dict(build.LAUNCHES) == {"lowrank_qmm": per_pass * 6,
                                        "quant_matmul": 6}
        assert np.array_equal(got, cpu.generate(prompts, sp).tokens)


# ------------------------------------------------- tensor-parallel serving --
def _tp_prompts(vocab):
    rng = np.random.default_rng(28)
    return [rng.integers(1, vocab, n).astype(np.int32)
            for n in (5, 40, 17, 23, 9)]


def test_tp1_nccl_captured_equals_solo(cuda):
    """tp 1 over NCCL in this process (a group of one): the mixed smoke
    engine's captured steps (an all-reduce over one rank launches nothing)
    give the solo captured engine's tokens and launch counters."""
    import torch.distributed as dist

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.launch.mesh import make_serving_mesh

    _, solo = _mixed_engines(cuda, 16)
    prompts = _tp_prompts(solo.cfg.vocab_size)
    sp = SamplingParams(max_tokens=7)
    mesh = make_serving_mesh(1)
    try:
        assert (mesh.backend, mesh.size) == ("nccl", 1)
        tp = InferenceEngine(solo.cfg, solo.params, device=mesh.device,
                             plan=solo.plan, mesh=mesh)
        runs = []
        for eng in (solo, tp, tp):
            build.reset_launches()
            res = eng.serve(prompts, sp)
            torch.cuda.synchronize()
            runs.append((res.outputs, _counts()))
        assert tp.graph_stats()["graphs"] > 0
        for outputs, counts in runs[1:]:
            for a, b in zip(outputs, runs[0][0]):
                np.testing.assert_array_equal(a, b)
            assert counts == runs[0][1]
    finally:
        dist.destroy_process_group()


def test_tp1_nccl_bf16_dense_k_site(cuda):
    """A dense bf16 K-site with a one-rank NCCL group bound: the float32
    partial (torch.mm's float32 output, no float32 copy of the weight)
    all-reduced and cast once is the float32 sum of the exact bf16
    products rounded to bf16: within one bf16 ulp of the float64 sum."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.layers import apply_linear
    from repro_torch.runtime import shardctx

    g = torch.Generator().manual_seed(28)
    x = torch.randn(2, 8, 512, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(512, 256, generator=g) / 20).to(cuda, torch.bfloat16)
    want = (x.double() @ w.double()).to(torch.bfloat16).double()
    mesh = make_serving_mesh(1)
    try:
        with shardctx.tp_group(mesh.group):
            y = apply_linear(x, w, reduce_tp=True)
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, 8, 256)
        torch.testing.assert_close(y.double(), want, rtol=2 ** -7, atol=1e-4)
    finally:
        dist.destroy_process_group()


def _tp_serve_rank(mesh, cfg, prompts, sp):
    """A rank of a gloo mesh on the card: the seed-0 dense engine, eager,
    serving `prompts`."""
    from repro_torch.api.engine import InferenceEngine

    eng = InferenceEngine.build(cfg, None, seed=0, mesh=mesh,
                                cuda_graphs=False)
    return eng.serve(prompts, sp).outputs


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_tp2_gloo_on_one_card_equals_solo(cuda, kv_bits):
    """Two gloo rank processes sharing the card (NCCL refuses two ranks on
    one device), eager: the dense smoke model's tokens equal the solo card
    engine's; with cuda_graphs left on, a gloo engine refuses to build."""
    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import ServingMesh, spawn

    cfg = dataclasses.replace(get_config("opus-mt", smoke=True),
                              num_heads=2, num_kv_heads=2, head_dim=32,
                              kv_cache_bits=kv_bits)
    prompts = _tp_prompts(cfg.vocab_size)
    sp = SamplingParams(max_tokens=7)
    want = InferenceEngine.build(cfg, None, seed=0,
                                 device=cuda).serve(prompts, sp).outputs
    got = spawn(_tp_serve_rank, 2, cfg, prompts, sp,
                devices=["cuda:0"] * 2, backend="gloo", timeout=300)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    mesh = ServingMesh(None, 0, 2, torch.device("cuda:0"), "gloo")
    with pytest.raises(ValueError, match="cuda_graphs=False"):
        InferenceEngine.build(cfg, None, seed=0, mesh=mesh)
