"""The port's hardware models (`repro_torch.hw.engine_model` and
`hw.h100_model`) against the JAX reference's (`repro.hw.engine_model`,
`repro.hw.tpu_model`) on the same inputs, and the H100 model's own
properties: it prices the partitions the port's kernels launch.

The ZCU111 model is a copy, so its points are identical. The H100 model
keeps the reference's platform-free formulas (speculation, the prefix
cache's MAC and byte counts, tensor parallelism's wire bytes): given the
reference's constants they give its numbers within 1e-12.
"""
import dataclasses

import numpy as np
import pytest

from repro.hw import engine_model as jem
from repro.hw import tpu_model as tm
from repro_torch.hw import engine_model as tem
from repro_torch.hw import h100_model as hm
from repro_torch.kernels import lowrank_qmm as tlr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm


def _close(a, b, tol=1e-12):
    """Dataclass fields equal: numbers within `tol` relative."""
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for key in da:
        x, y = da[key], db[key]
        if isinstance(x, float) or isinstance(y, float):
            assert x == pytest.approx(y, rel=tol, abs=tol), key
        else:
            assert x == y, key


# ------------------------------------------------------- the ZCU111 model --

@pytest.mark.parametrize("m,k,n,r,wl", [(8, 64, 96, None, 4),
                                        (16, 128, 64, 32, 4),
                                        (64, 96, 128, 24, 8)])
def test_engine_model_explore_is_the_reference(m, k, n, r, wl):
    """Every feasible engine point, in order, with the reference's fields,
    and the Pareto front over them."""
    got = tem.explore(m, k, n, r, weight_wl=wl)
    want = jem.explore(m, k, n, r, weight_wl=wl)
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
    assert [dataclasses.asdict(p) for p in tem.pareto_front(got)] == \
        [dataclasses.asdict(p) for p in jem.pareto_front(want)]


def test_engine_model_functions_are_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        m, k, n = (int(x) for x in rng.integers(1, 300, 3))
        t = tem.TileConfig(*(int(2 ** x) for x in rng.integers(0, 7, 3)))
        jt = jem.TileConfig(t.mt, t.nt, t.kf)
        wl, aw = int(rng.choice([4, 6, 8])), int(rng.choice([4, 8]))
        assert tem.tile_rates(k, n, t) == jem.tile_rates(k, n, jt)
        assert tem.tile_workloads(m, k, n, t) == jem.tile_workloads(m, k, n,
                                                                    jt)
        assert tem.tile_latency(m, k, n, t) == jem.tile_latency(m, k, n, jt)
        assert tem.dsp_tile(t, wl) == jem.dsp_tile(jt, wl)
        assert tem.bram_tile(k, t, wl, aw) == jem.bram_tile(k, jt, wl, aw)
        assert tem.bandwidth_bits_per_cycle(m, k, n, t, wl, aw) == \
            jem.bandwidth_bits_per_cycle(m, k, n, jt, wl, aw)
        r = int(rng.integers(1, 64))
        assert dataclasses.asdict(tem.single_engine(m, k, n, r, t, wl, aw)) \
            == dataclasses.asdict(jem.single_engine(m, k, n, r, jt, wl, aw))
        assert dataclasses.asdict(tem.cascade_engine(m, k, n, r, t, t, wl,
                                                     aw)) == \
            dataclasses.asdict(jem.cascade_engine(m, k, n, r, jt, jt, wl, aw))
    assert tem.ZCU111 == jem.ZCU111


# ------------------------------------------- platform-free formulas --

def test_speculation_formulas_are_the_reference():
    for k in range(0, 9):
        for a in np.linspace(0.0, 1.0, 11):
            assert hm.expected_tokens_per_round(k, float(a)) == \
                pytest.approx(tm.expected_tokens_per_round(k, float(a)),
                              rel=1e-12, abs=1e-12)
    for k in range(1, 9):
        for dc in (0.05, 0.3, 0.9, 1.2):
            for vc in (0.8, 1.0, 1.5):
                assert hm.breakeven_accept_rate(
                    k, draft_cost_ratio=dc, verify_cost_ratio=vc) == \
                    pytest.approx(tm.breakeven_accept_rate(
                        k, draft_cost_ratio=dc, verify_cost_ratio=vc),
                        rel=1e-12, abs=1e-12)
            for a in (0.0, 0.4, 0.95):
                _close(hm.speculation_point(k, a, full_step_s=0.004,
                                            draft_step_s=0.004 * dc),
                       tm.speculation_point(k, a, full_step_s=0.004,
                                            draft_step_s=0.004 * dc))


def test_tp_point_with_the_reference_link_is_the_reference():
    link = tm.ICI_BW_PER_LINK * tm.ICI_LINKS
    for tp in (1, 2, 4, 8):
        for step_s in (None, 0.004):
            geom = dict(batch=8, span_w=4, d_model=512, num_layers=12,
                        tp=tp, dtype_bytes=2, step_s=step_s)
            _close(hm.tp_point(**geom, link_bw=link), tm.tp_point(**geom))
    # the port's residual stream is fp32, over NVLink
    p = hm.tp_point(batch=8, span_w=1, d_model=512, num_layers=12, tp=2)
    assert p.payload_bytes == 8 * 512 * 4
    assert p.allreduce_s == pytest.approx(p.allreduce_bytes / hm.NVLINK_BW)


def test_sampling_point_with_the_reference_rates_is_the_reference():
    for batch, vocab, frac in ((8, 32000, 1.0), (1, 1024, 0.0),
                               (16, 128000, 0.5)):
        _close(hm.sampling_point(batch=batch, vocab=vocab, sampled_frac=frac,
                                 peak_ops=tm.PEAK_OPS_INT8 / 8,
                                 pcie_bw=tm.PCIE_BW,
                                 dispatch_s=tm.DISPATCH_S),
               tm.sampling_point(batch=batch, vocab=vocab,
                                 sampled_frac=frac))


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_prefix_cache_counts_are_the_reference(kv_bits):
    geom = dict(num_layers=4, d_model=256, d_ff=1024, num_heads=8,
                num_kv_heads=4, head_dim=32, block_size=16, kv_bits=kv_bits)
    for plen in (17, 256, 2048):
        for hr in (0.0, 0.3, 0.75, 1.0):
            got = hm.prefix_cache_point(plen, hr, **geom)
            want = tm.prefix_cache_point(plen, hr, **geom)
            for f in ("hit_rate", "tokens_cached", "tokens_computed", "macs",
                      "macs_nocache", "macs_saved", "kv_bytes_written",
                      "kv_bytes_saved"):
                assert getattr(got, f) == getattr(want, f), f


# ------------------------------- the reference's properties, on the H100 --

def test_h100_model_prices_paged_attention():
    """tests/test_paged_attention.py::test_tpu_model_prices_paged_attention
    of the H100 model, on both of the port's pools."""
    ctx, ql = [400, 290, 0, 500], [8, 1, 0, 8]
    for kv_bits in (32, 8):
        sp = hm.paged_attention_point(ctx, ql, num_kv_heads=4, head_dim=64,
                                      num_heads=8, block_size=16,
                                      max_blocks=32, kv_bits=kv_bits)
        gp = hm.paged_attention_point(ctx, ql, num_kv_heads=4, head_dim=64,
                                      num_heads=8, block_size=16,
                                      max_blocks=32, kv_bits=kv_bits,
                                      streamed=False)
        assert sp.kind == "pattn_stream" and gp.kind == "pattn_gather"
        assert sp.hbm_bytes < gp.hbm_bytes
        assert sp.latency_s < gp.latency_s          # decode attn is bw-bound
        assert sp.memory_s >= sp.compute_s
    # the launch's own key split: two waves of decode CTAs, a combine
    qt, kps, splits = tpa.choose_splits(4, 4, 8, 2, 32, 16, hm.NUM_SMS)
    assert sp.config["splits"] == splits > 1 and sp.launches == 2
    assert sp.smem_bytes == tpa.smem_bytes(qt, 64, True, 16)


def test_sampling_point_pricing():
    """tests/test_sampling.py::test_sampling_point_pricing of the H100
    model."""
    p = hm.sampling_point(batch=8, vocab=32000)
    g = hm.sampling_point(batch=8, vocab=32000, sampled_frac=0.0)
    assert g.overhead_vs_greedy == 1.0
    assert p.overhead_vs_greedy > 1.0
    assert p.speedup_vs_host > 10.0
    prev = None
    for v in (1024, 8192, 32000, 128000):
        pt = hm.sampling_point(batch=8, vocab=v)
        if prev is not None:
            assert pt.host_s > prev.host_s
            assert pt.fused_s > prev.fused_s
        assert pt.speedup_vs_host > 10.0
        prev = pt
    half = hm.sampling_point(batch=8, vocab=32000, sampled_frac=0.5)
    assert g.fused_s < half.fused_s < p.fused_s
    for bad in (dict(batch=0, vocab=8), dict(batch=1, vocab=1),
                dict(batch=1, vocab=8, sampled_frac=-0.1)):
        with pytest.raises(ValueError):
            hm.sampling_point(**bad)


def test_expected_tokens_per_round():
    f = hm.expected_tokens_per_round
    assert f(3, 0.0) == pytest.approx(1.0)
    assert f(3, 1.0) == pytest.approx(4.0)
    assert f(2, 0.5) == pytest.approx(1.75)
    assert f(0, 0.9) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        f(-1, 0.5)
    with pytest.raises(ValueError):
        f(3, 1.5)


def test_breakeven_monotone_in_k():
    for dc in (0.1, 0.3, 0.6):
        bs = [hm.breakeven_accept_rate(k, draft_cost_ratio=dc)
              for k in range(1, 9)]
        assert all(b2 >= b1 - 1e-12 for b1, b2 in zip(bs, bs[1:])), bs
        assert all(0.0 <= b <= 1.0 for b in bs)
    assert hm.breakeven_accept_rate(
        1, draft_cost_ratio=0.3) == pytest.approx(0.3, abs=1e-9)


def test_speculation_point_prices_the_trade():
    pt = hm.speculation_point(4, 0.8, full_step_s=1.0, draft_step_s=0.3)
    assert pt.expected_tokens == pytest.approx(
        hm.expected_tokens_per_round(4, 0.8))
    assert pt.round_s == pytest.approx(4 * 0.3 + 1.0)
    assert pt.speedup > 1.0
    assert pt.tokens_per_s == pytest.approx(
        pt.baseline_tokens_per_s * pt.speedup)
    lo = hm.speculation_point(4, pt.breakeven_accept_rate * 0.5,
                              full_step_s=1.0, draft_step_s=0.3)
    assert lo.speedup < 1.0


def test_prefix_cache_point_monotone_and_fp32_pool():
    """tests/test_prefix_cache.py's properties at the port's fp32 pool:
    more hits never cost more; fp32 writes twice bf16's KV bytes."""
    geom = dict(num_layers=4, d_model=256, d_ff=1024, num_heads=8,
                num_kv_heads=4, head_dim=32, block_size=16)
    for plen in (17, 256, 2048):
        prev = None
        for hr in np.linspace(0.0, 1.0, 9):
            pt = hm.prefix_cache_point(plen, float(hr), **geom)
            assert pt.tokens_cached + pt.tokens_computed == plen
            assert pt.tokens_cached <= plen - 1
            assert pt.macs + pt.macs_saved == pytest.approx(pt.macs_nocache)
            assert pt.ttft_speedup >= 1.0
            if prev is not None:
                assert pt.macs_saved >= prev.macs_saved
                assert pt.kv_bytes_saved >= prev.kv_bytes_saved
                assert pt.prefill_s <= prev.prefill_s + 1e-12
            prev = pt
    p32 = hm.prefix_cache_point(512, 0.75, **geom)
    p16 = hm.prefix_cache_point(512, 0.75, kv_bits=16, **geom)
    assert p32.kv_bytes_saved == 2 * p16.kv_bytes_saved
    with pytest.raises(ValueError, match="kv_bits"):
        hm.prefix_cache_point(64, 0.5, kv_bits=4, **geom)


# ------------------------------------ the H100 model prices the launches --

# a layer's (M, K, N, R): serving decode and the paper's batch at
# opus-mt's widths, and ragged widths `ops` pads
SHAPES = [(8, 512, 512, 256), (8, 512, 2048, 192), (8, 2048, 512, 256),
          (512, 512, 2048, 256), (512, 2048, 512, 192), (8, 512, 32000, None),
          (512, 512, 32000, None), (37, 200, 300, 100)]


def _up(x, m):
    return -(-x // m) * m


@pytest.mark.parametrize("wl", [8, 6, 4])
@pytest.mark.parametrize("m,k,n,r", SHAPES)
def test_h100_model_prices_the_launched_partition(m, k, n, r, wl):
    """Each engine prices the partition the wrapper's chooser returns at
    the widths `ops` pads to, with the runtime's packing (W4 packed where
    the rule admits the axis; W6 and W8 carriers); its bytes are at least
    the least bytes of the layer (`ops.qmm_hbm_bytes`,
    `ops.lrmm_hbm_bytes`)."""
    from repro_torch.core.itera import LowRankQ
    from repro_torch.core.quant import QuantizedTensor, packs

    import torch

    kp, np_ = _up(k, 16), _up(n, 32)
    packed = packs(wl, n)
    p = hm.dense_engine(m, k, n, weight_wl=wl)
    t = tqm.choose_tiles(m, kp, np_, packed, 132, tqm.smem_bytes)
    assert p.config["tiles"] == t._asdict() and p.config["packed"] == packed
    assert p.launches == 1 and p.smem_bytes <= tqm.SMEM_TWO_PER_SM
    w = QuantizedTensor(torch.zeros(kp, np_ // 2 if packed else np_,
                                    dtype=torch.int8), torch.ones(1, np_),
                        wl, 0, packed=packed)
    assert p.hbm_bytes >= tops.qmm_hbm_bytes(m, w)
    assert p.latency_s == pytest.approx(
        max(p.compute_s, p.memory_s) + hm.LAUNCH_S)
    if r is None:
        return
    rp = _up(r, 32)
    w1p, w2p = packs(wl, r), packed
    c = hm.cascade_engine(m, k, n, r, weight_wl=wl)
    lt = tlr.choose_tiles(m, rp, np_, 132, tlr.smem_bytes)
    assert c.config["tiles"] == lt._asdict()
    assert c.config["packed"] == [w1p, w2p]
    assert c.smem_bytes == tlr.smem_bytes(*lt) <= hm.SMEM_BYTES_PER_BLOCK
    lr = LowRankQ(
        QuantizedTensor(torch.zeros(kp, rp // 2 if w1p else rp,
                                    dtype=torch.int8), torch.ones(1, rp),
                        wl, 0, packed=w1p),
        QuantizedTensor(torch.zeros(rp, np_ // 2 if w2p else np_,
                                    dtype=torch.int8), torch.ones(rp, 1),
                        wl, 1, packed=w2p))
    assert c.hbm_bytes >= tops.lrmm_hbm_bytes(m, lr)
    s = hm.single_engine(m, k, n, r, weight_wl=wl)
    t1 = tqm.choose_tiles(m, kp, rp, w1p, 132, tqm.smem_bytes)
    t2 = tqm.choose_tiles(m, _up(r, 16), np_, w2p, 132, tqm.smem_bytes)
    assert s.launches == 2
    assert s.config["tiles"] == [t1._asdict(), t2._asdict()]
    # the two launches' bytes, and T read in fp32 and Tq written in int8
    # between them: the round trip the cascade keeps on chip
    assert s.hbm_bytes == (tqm.hbm_bytes_moved(m, kp, rp, w1p, t1)
                           + tqm.hbm_bytes_moved(m, _up(r, 16), np_, w2p, t2)
                           + m * rp * 5)
    assert hm.best_point(m, k, n, r, weight_wl=wl).latency_s == min(
        p.latency_s, s.latency_s, c.latency_s)


def test_h100_model_skips_what_the_kernels_refuse(monkeypatch):
    """R beyond 1024 is priced as the cascade the kernel now runs: R 1056
    on chip in wide slices (one launch), R 9216 on the grouped path (two
    launches, t's bytes counted); a partition that fits no CTA's shared
    memory is still refused, and best_point takes another engine."""
    lt = tlr.choose_tiles(8, 1056, 2048, 132, tlr.smem_bytes)
    assert lt.path == "cluster" and lt.cluster * lt.rs >= 1056
    c = hm.cascade_engine(8, 2048, 2048, 1056, weight_wl=8)
    assert c.kind == "cascade" and c.launches == 1
    assert c.config["tiles"] == lt._asdict()
    assert hm.best_point(8, 2048, 2048, 1056, weight_wl=8,
                         engines=("cascade",)).latency_s == c.latency_s
    assert hm.best_point(8, 2048, 2048, 1024, weight_wl=8,
                         engines=("cascade",)).kind == "cascade"
    g = hm.cascade_engine(8, 9216, 9216, 9216, weight_wl=8)
    gt = tlr.choose_tiles(8, 9216, 9216, 132, tlr.smem_bytes)
    assert gt.path == "grouped" and g.launches == 2
    assert g.hbm_bytes == tlr.hbm_bytes_moved(8, 9216, 9216, 9216, False,
                                              False, gt)
    # t (float32) and the row maxima, written once and read by every span
    spans = -(-9216 // gt.ncl)
    assert g.hbm_bytes > (8 * 9216 * 4 + gt.groups * 8 * 4) * (1 + spans)
    with pytest.raises(ValueError, match="shared memory"):
        tlr.choose_tiles(8, 1056, 2048, 132, lambda *tiles: 1 << 30)
    monkeypatch.setattr(tlr, "smem_bytes", lambda *tiles: 1 << 30)
    with pytest.raises(ValueError, match="shared memory"):
        hm.cascade_engine(8, 2048, 2048, 1056, weight_wl=8)
    p = hm.best_point(8, 2048, 2048, 1056, weight_wl=8)
    assert p is not None and p.kind in ("baseline", "single")
    assert hm.best_point(8, 2048, 2048, 1056, weight_wl=8,
                         engines=("cascade",)) is None


def test_h100_model_restricts_engines_and_prices_launches():
    """`engines` restricts the choice; with LAUNCH_S = 0 the model prices
    bytes and operations alone, and a decode step's launches are most of
    its priced time."""
    for engines in (("baseline",), ("single",), ("cascade",),
                    ("single", "cascade")):
        assert hm.best_point(8, 512, 2048, 256, weight_wl=4,
                             engines=engines).kind in engines
    assert hm.best_point(8, 512, 2048, None, engines=("cascade",)) is None
    p = hm.dense_engine(8, 512, 512, weight_wl=4)
    z = hm.dense_engine(8, 512, 512, weight_wl=4, launch_s=0.0)
    assert z.latency_s == max(z.compute_s, z.memory_s)
    assert p.latency_s - z.latency_s == pytest.approx(hm.LAUNCH_S)
    assert hm.LAUNCH_S > 10 * z.latency_s


def test_attention_byte_models():
    """The port's pool: fp32, bfloat16 (a bf16 model's), or int8 codes
    with an fp32 scale per (token, head); other widths are refused; the
    streaming kernel reads only valid blocks, the plain gather the whole
    table view and float64 copies of it."""
    assert tpa.kv_bytes_per_token(4, 64, 32) == 2 * 4 * 64 * 4
    assert tpa.kv_bytes_per_token(4, 64, 16) == 2 * 4 * 64 * 2
    assert tpa.kv_bytes_per_token(4, 64, 8) == 2 * (4 * 64 + 4 * 4)
    with pytest.raises(ValueError, match="kv_bits"):
        tpa.kv_bytes_per_token(4, 64, 4)
    ctx, ql = [400, 290, 0, 500], [8, 1, 0, 8]
    for kv in (32, 8):
        s = tpa.stream_hbm_bytes(ctx, ql, 16, 4, 64, kv_bits=kv, n_q_heads=8)
        g = tpa.gather_hbm_bytes(4, 32, 16, 4, 64, kv_bits=kv, w=8,
                                 n_q_heads=8)
        assert s < g
    per_view = 2 * 4 * 32 * 16 * 4 * 64
    assert tpa.gather_hbm_bytes(4, 32, 16, 4, 64, kv_bits=8) - \
        tpa.gather_hbm_bytes(4, 32, 16, 4, 64, kv_bits=32) == \
        4 * 32 * 16 * (tpa.kv_bytes_per_token(4, 64, 8)
                       - tpa.kv_bytes_per_token(4, 64, 32)) + per_view * 8
