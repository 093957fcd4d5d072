"""Analytical model of the port's linears and serving steps on one NVIDIA
H100 (SXM): the deployed card's counterpart of `repro.hw.tpu_model`, and
what `hw.dse.co_design(platform="h100")` prices a plan with.

A layer is priced from the launches the port's wrappers would make for
it: the partition that the kernel's own chooser returns (`choose_tiles`,
with its Python shared-memory mirror and the card's 132 SMs) at the widths
`kernels.ops` pads to (K to 16; R and N to 32), the bytes that partition
re-reads, and a fixed time per launch:

  latency = max(compute, memory) + launches x LAUNCH_S
  compute = MACs padded to the partition x 2 / the int8 tensor-core rate
  memory  = the partition's `hbm_bytes_moved` / the HBM rate

The kernels run `mma.sync.m16n8k32`, not `wgmma`, so the int8 rate is a
bound they do not reach. Every bm the choosers return is a whole number
of the mma's 16-row tiles, so how much of a tile holds rows is the M
padding the MACs already count (8 rows of a decode step fill half). W4
weights stream packed (two codes a byte) where the runtime packs them
(`core.quant.packs`); W6 and W8 ride int8 carriers, and the model prices
the bytes that actually stream.

Engines (paper §V):
  baseline -- one `quant_matmul` launch (the dense WxAy engine);
  single   -- `ops.lrmm(fused=False)`: two `quant_matmul` launches, the
              (M, R) intermediate written to and read from device memory;
  cascade  -- one `lowrank_qmm` launch, T kept on chip, up to R 4096;
              past it the kernel's grouped path, two launches with t and
              its row maxima written to and read from device memory
              (`lowrank_qmm.hbm_bytes_moved` counts those bytes);
  pattn    -- serving attention over the blocked KV pool
              (`paged_attention_point`): the streaming kernel against the
              plain gather version.

A shape that a wrapper refuses (a partition that does not fit shared
memory) raises ValueError, and `best_point` skips it: the counterpart of
the reference's VMEM pruning. `lowrank_qmm` takes every R % 32 up to the
widest configured model's 18,432, so no rank is refused for its size.
The platform-free formulas (speculation, the prefix cache's MAC and byte
counts, tensor parallelism's wire bytes) are the reference's, priced with
this card's numbers.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.quant import packs
from repro_torch.kernels import lowrank_qmm as lr
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels.build import SMEM_LIMIT

# NVIDIA H100 SXM data sheet and Hopper white paper (dense rates, 700 W)
NUM_SMS = 132                     # streaming multiprocessors
SMEM_BYTES_PER_BLOCK = SMEM_LIMIT  # 232,448 B of an SM's 256 KB
L2_BYTES = 50e6                   # 50 MB L2
HBM_BW = 3.35e12                  # B/s, 80 GB of HBM3
PEAK_OPS_INT8 = 1979e12           # int8 tensor-core OP/s (a wgmma rate)
PEAK_FLOPS_FP32 = 67e12           # fp32 FLOP/s outside the tensor cores
PEAK_FLOPS_BF16 = 989e12          # bf16 tensor-core FLOP/s, dense
PEAK_FLOPS_FP64_TC = 67e12        # float64 tensor-core FLOP/s (DMMA)
NVLINK_BW = 450e9                 # B/s each way to the host's other cards
PCIE_BW = 64e9                    # B/s each way, PCIe Gen5 x16
# The fixed time of one launch inside a replayed CUDA graph: the smallest
# decode launch (quant_matmul, M 8, K 512 -> N 512, packed W4) replayed
# 200 times back to back in one graph, 3.871 us a launch, less its own
# max(compute, memory). From a run of chip_smoke.py (phase 2 times that
# graph, and its dse phase prints each run's value beside this one) on an
# NVIDIA H100 80GB HBM3 at 700.00 W.
LAUNCH_S = 3.807e-6
# device kernels of the plain attention (`span_attend_gather`) on an fp32
# pool and on an int8 one (the scales' gathers and products, the casts),
# counted from its code: each is a launch the plain version pays
GATHER_KERNELS = {32: 18, 8: 24}

ENGINES = ("baseline", "single", "cascade")


@dataclasses.dataclass
class H100Point:
    kind: str
    latency_s: float
    compute_s: float
    memory_s: float
    hbm_bytes: float
    launches: int
    smem_bytes: int               # the largest CTA's shared memory
    config: dict


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _price(kind, macs, hbm, launches, smem, config, hbm_bw,
           launch_s) -> H100Point:
    """A point from its padded MACs, bytes and launches."""
    compute = 2 * macs / PEAK_OPS_INT8
    memory = hbm / hbm_bw
    return H100Point(kind, max(compute, memory) + launches * launch_s,
                     compute, memory, hbm, launches, smem, config)


def _qmm_launch(m, k, n, packed):
    """(tiles, padded MACs, bytes, smem) of one quant_matmul launch at the
    kernel's (padded) K and N."""
    t = qm.choose_tiles(m, k, n, packed, NUM_SMS, qm.smem_bytes)
    return (t, _up(m, t.bm) * k * n, qm.hbm_bytes_moved(m, k, n, packed, t),
            qm.smem_bytes(*t[:3], int(packed), t.cluster, t.kslice))


def dense_engine(m, k, n, *, weight_wl=8, hbm_bw=HBM_BW,
                 launch_s=LAUNCH_S) -> H100Point:
    """One quant_matmul launch of an (m, k) input against a (k, n) weight."""
    packed = packs(weight_wl, n)
    kp, np_ = _up(k, 16), _up(n, 32)
    t, macs, hbm, smem = _qmm_launch(m, kp, np_, packed)
    return _price("baseline", macs, hbm, 1, smem,
                  {"tiles": t._asdict(), "shape": [m, kp, np_],
                   "packed": packed}, hbm_bw, launch_s)


def single_engine(m, k, n, r, *, weight_wl=8, hbm_bw=HBM_BW,
                  launch_s=LAUNCH_S) -> H100Point:
    """`ops.lrmm(fused=False)`: quant_matmul (m, K -> R), the intermediate
    requantized in device memory (T read in fp32, Tq written in int8), then
    quant_matmul (m, R -> N)."""
    kp, rp, np_ = _up(k, 16), _up(r, 32), _up(n, 32)
    w1p, w2p = packs(weight_wl, r), packs(weight_wl, n)
    t1, macs1, hbm1, smem1 = _qmm_launch(m, kp, rp, w1p)
    t2, macs2, hbm2, smem2 = _qmm_launch(m, _up(r, 16), np_, w2p)
    return _price("single", macs1 + macs2, hbm1 + hbm2 + m * rp * 4 + m * rp,
                  2, max(smem1, smem2),
                  {"tiles": [t1._asdict(), t2._asdict()], "rank": r,
                   "shape": [m, kp, rp, np_], "packed": [w1p, w2p]},
                  hbm_bw, launch_s)


def cascade_engine(m, k, n, r, *, weight_wl=8, hbm_bw=HBM_BW,
                   launch_s=LAUNCH_S) -> H100Point:
    """One lowrank_qmm call. On the cluster path each cluster recomputes
    phase 1 for its span of N columns, so phase 1's MACs count once a
    span; the grouped path runs phase 1 once, in two launches."""
    kp, rp, np_ = _up(k, 16), _up(r, 32), _up(n, 32)
    w1p, w2p = packs(weight_wl, r), packs(weight_wl, n)
    t = lr.choose_tiles(m, rp, np_, NUM_SMS, lr.smem_bytes)
    mp = _up(m, t.bm)
    spans = 1 if t.groups else -(-np_ // t.ncl)
    macs = mp * kp * rp * spans + mp * rp * np_
    hbm = lr.hbm_bytes_moved(m, kp, rp, np_, w1p, w2p, t)
    return _price("cascade", macs, hbm, t.launches, lr.smem_bytes(*t),
                  {"tiles": t._asdict(), "rank": r,
                   "shape": [m, kp, rp, np_], "packed": [w1p, w2p]},
                  hbm_bw, launch_s)


def best_point(m, k, n, r=None, *, weight_wl=8, hbm_bw=HBM_BW,
               engines=ENGINES, launch_s=LAUNCH_S) -> H100Point | None:
    """The lowest-latency engine of `engines` that the wrappers accept for
    one layer (low-rank engines need a rank), or None."""
    kw = dict(weight_wl=weight_wl, hbm_bw=hbm_bw, launch_s=launch_s)
    makers = {"baseline": lambda: dense_engine(m, k, n, **kw)}
    if r is not None:
        makers["single"] = lambda: single_engine(m, k, n, r, **kw)
        makers["cascade"] = lambda: cascade_engine(m, k, n, r, **kw)
    best = None
    for kind in engines:
        if kind not in makers:
            continue
        try:
            p = makers[kind]()
        except ValueError:          # a launch the wrapper refuses
            continue
        if best is None or p.latency_s < best.latency_s:
            best = p
    return best


# ------------------------------------------------------ paged attention --
def paged_attention_point(ctx_lens, q_lens, *, num_kv_heads, head_dim,
                          num_heads=None, block_size=16, max_blocks=None,
                          kv_bits=32, streamed=True, hbm_bw=HBM_BW,
                          launch_s=LAUNCH_S) -> H100Point:
    """One serving-attention step over the blocked KV pool (fp32 pool:
    kv_bits 32; int8 codes and fp32 scales: 8).

    streamed=True prices the kernel: every active row streams its valid
    blocks once, at the key split `choose_splits` gives the launch; with
    more than one split a second launch combines the float64 partials,
    written and read once. streamed=False prices the plain version, which
    gathers each row's whole block-table view (`gather_hbm_bytes`) in
    GATHER_KERNELS launches. Compute is the causal flops (streamed) or the
    full key window (gather) at the fp32 rate: the kernel's float64
    arithmetic is a cost above that bound."""
    hk, dh = num_kv_heads, head_dim
    h = num_heads or hk
    ctx_lens = [int(c) for c in ctx_lens]
    q_lens = [int(q) for q in q_lens]
    if max_blocks is None:
        max_blocks = max((-(-(c + q) // block_size)
                          for c, q in zip(ctx_lens, q_lens)), default=1)
    b, w = len(ctx_lens), max(q_lens, default=1)
    config = {"block_size": block_size, "max_blocks": max_blocks,
              "kv_bits": kv_bits, "rows": b}
    if streamed:
        qt, kps, splits = pa.choose_splits(b, hk, w, h // hk, max_blocks,
                                           block_size, NUM_SMS)
        hbm = pa.stream_hbm_bytes(ctx_lens, q_lens, block_size, hk, dh,
                                  kv_bits=kv_bits, n_q_heads=h)
        launches = 1
        if splits > 1:
            rows = b * hk * -(-w * (h // hk) // qt) * splits * qt
            hbm += 2 * rows * (2 + dh) * 8
            launches = 2
        flops = pa.attention_flops(ctx_lens, q_lens, h, dh)
        smem = pa.smem_bytes(qt, dh, kv_bits == 8, block_size)
        config.update(qt=qt, keys_per_split=kps, splits=splits)
    else:
        hbm = pa.gather_hbm_bytes(b, max_blocks, block_size, hk, dh,
                                  kv_bits=kv_bits, w=w, n_q_heads=h)
        launches = GATHER_KERNELS[kv_bits]
        flops = sum(4 * dh * h * w * max_blocks * block_size
                    for q in q_lens if q > 0)
        smem = 0
    compute = flops / PEAK_FLOPS_FP32
    memory = hbm / hbm_bw
    return H100Point("pattn_stream" if streamed else "pattn_gather",
                     max(compute, memory) + launches * launch_s, compute,
                     memory, hbm, launches, smem, config)


# ------------------------------------------------------------- speculation --

@dataclasses.dataclass(frozen=True)
class SpeculationPoint:
    """Priced self-speculative decoding trade for one (k, accept_rate)
    operating point (runtime/speculation.py is the thing being priced)."""

    k: int
    accept_rate: float
    expected_tokens: float          # E[tokens emitted per round]
    round_s: float                  # k draft steps + one verify step
    tokens_per_s: float
    baseline_tokens_per_s: float    # plain decode: 1 / full_step_s
    speedup: float
    breakeven_accept_rate: float    # min a where this k stops losing


def expected_tokens_per_round(k: int, accept_rate: float) -> float:
    """E[tokens emitted per speculative round] under i.i.d. per-token
    draft acceptance probability a: the accepted prefix is geometric
    truncated at k, and the verify pass always adds one token:

        E = 1 + a + a^2 + ... + a^k = (1 - a^(k+1)) / (1 - a)
    """
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1], got {accept_rate}")
    if accept_rate >= 1.0:
        return float(k + 1)
    return (1.0 - accept_rate ** (k + 1)) / (1.0 - accept_rate)


def breakeven_accept_rate(k: int, *, draft_cost_ratio: float,
                          verify_cost_ratio: float = 1.0) -> float:
    """Smallest per-token acceptance rate at which drafting k tokens a
    round emits tokens at least as fast as plain decode: solves
    E(k, a) = k * draft_cost_ratio + verify_cost_ratio by bisection (E is
    increasing in a). Non-decreasing in k; 1.0 when even a perfect draft
    cannot pay for itself."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if draft_cost_ratio <= 0.0 or verify_cost_ratio <= 0.0:
        raise ValueError("cost ratios must be positive")
    target = k * draft_cost_ratio + verify_cost_ratio
    if expected_tokens_per_round(k, 1.0) <= target:
        return 1.0
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if expected_tokens_per_round(k, mid) < target:
            lo = mid
        else:
            hi = mid
    return hi


def speculation_point(k: int, accept_rate: float, *, full_step_s: float,
                      draft_step_s: float,
                      verify_step_s: float | None = None) -> SpeculationPoint:
    """Price one self-speculative operating point: k draft steps of
    `draft_step_s` and one verify pass (default: a full step) a round."""
    if full_step_s <= 0.0 or draft_step_s <= 0.0:
        raise ValueError("step times must be positive")
    verify_step_s = full_step_s if verify_step_s is None else verify_step_s
    e = expected_tokens_per_round(k, accept_rate)
    round_s = k * draft_step_s + verify_step_s
    tps = e / round_s
    base = 1.0 / full_step_s
    return SpeculationPoint(
        k=int(k), accept_rate=float(accept_rate), expected_tokens=e,
        round_s=round_s, tokens_per_s=tps, baseline_tokens_per_s=base,
        speedup=tps / base,
        breakeven_accept_rate=breakeven_accept_rate(
            k, draft_cost_ratio=draft_step_s / full_step_s,
            verify_cost_ratio=verify_step_s / full_step_s))


# -------------------------------------------------------- tensor parallel --

@dataclasses.dataclass(frozen=True)
class TpPoint:
    """Priced tensor-parallel serving point: the 2L boundary all-reduces
    of a sharded step over NVLink (math only: the port has no tensor
    parallelism yet)."""

    tp: int
    boundaries: int                 # all-reduce sites per step (2 a layer)
    payload_bytes: int              # logical bytes reduced per boundary
    allreduce_bytes: int            # wire bytes per card per step (ring)
    allreduce_s: float              # link time per step
    step_s: float | None            # single-card step, when supplied
    tp_step_s: float | None         # modeled sharded step (compute/tp + link)
    speedup: float | None           # step_s / tp_step_s


def tp_point(*, batch: int, span_w: int, d_model: int, num_layers: int,
             tp: int, dtype_bytes: int = 4, step_s: float | None = None,
             link_bw: float = NVLINK_BW) -> TpPoint:
    """Price one TP serving configuration: one all-reduce of the (batch,
    span_w, d_model) residual stream per attention and per MLP boundary,
    each a ring moving 2 (tp - 1) / tp of the payload per card over
    `link_bw`. dtype_bytes 4: the port's residual stream is fp32, and the
    reference reduces in f32 too. With `step_s`, also the sharded step
    (perfectly scaled compute plus the all-reduce) and its speedup."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if batch < 1 or span_w < 1 or d_model < 1 or num_layers < 1:
        raise ValueError("batch/span_w/d_model/num_layers must be >= 1")
    boundaries = 2 * num_layers
    payload = batch * span_w * d_model * dtype_bytes
    wire = int(boundaries * payload * 2 * (tp - 1) / tp)
    allreduce_s = wire / link_bw
    tp_step_s = speedup = None
    if step_s is not None:
        if step_s <= 0.0:
            raise ValueError(f"step_s must be positive, got {step_s}")
        tp_step_s = step_s / tp + allreduce_s
        speedup = step_s / tp_step_s
    return TpPoint(tp=int(tp), boundaries=boundaries, payload_bytes=payload,
                   allreduce_bytes=wire, allreduce_s=allreduce_s,
                   step_s=step_s, tp_step_s=tp_step_s, speedup=speedup)


# ----------------------------------------------------------- prefix cache --

@dataclasses.dataclass(frozen=True)
class PrefixCachePoint:
    """Priced prefix-cache operating point: the prefill work a serving
    engine skips at a given cache hit rate (MACs not run, KV bytes not
    written)."""

    hit_rate: float
    tokens_cached: int              # block-aligned prompt tokens skipped
    tokens_computed: int
    macs: float                     # prefill MACs actually run
    macs_nocache: float
    macs_saved: float
    kv_bytes_written: float         # KV writeback for computed tokens
    kv_bytes_saved: float           # writeback skipped for cached tokens
    prefill_s: float                # max(compute, writeback) with cache
    prefill_s_nocache: float
    ttft_speedup: float             # prefill_s_nocache / prefill_s


def prefix_cache_point(prompt_len: int, hit_rate: float, *, num_layers: int,
                       d_model: int, d_ff: int, num_heads: int,
                       num_kv_heads: int, head_dim: int, block_size: int = 16,
                       kv_bits: int = 32,
                       hbm_bw: float = HBM_BW) -> PrefixCachePoint:
    """Price one (prompt_len, hit_rate) prefix-cache point. The hit rate
    is rounded down to whole blocks and the last position is always
    computed (its logits seed decoding); cached positions cost no MACs
    and no KV writeback. kv_bits: 32 (the port's fp32 pool), 16, or 8
    (int8 codes and an fp32 scale per token and head). Monotone: more
    hits never price a slower prefill."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    if not 0.0 <= hit_rate <= 1.0:
        raise ValueError(f"hit_rate must be in [0, 1], got {hit_rate}")
    if kv_bits not in (8, 16, 32):
        raise ValueError(f"kv_bits must be 8, 16 or 32, got {kv_bits}")
    h, hk, dh = num_heads, num_kv_heads, head_dim
    cached = min((int(hit_rate * prompt_len) // block_size) * block_size,
                 prompt_len - 1)
    # per-token linear MACs of all layers: QKV, output projection, MLP
    lin = num_layers * (d_model * h * dh + 2 * d_model * hk * dh
                        + h * dh * d_model + 3 * d_model * d_ff)

    def tri(n: int) -> int:
        return n * (n + 1) // 2

    def _macs(n_cached: int) -> float:
        # causal attention: position p costs 2 (p + 1) h dh MACs
        u = prompt_len - n_cached
        attn = 2 * num_layers * h * dh * (tri(prompt_len) - tri(n_cached))
        return u * lin + attn

    kv_tok = num_layers * 2 * hk * (dh + 4 if kv_bits == 8
                                    else dh * kv_bits // 8)

    def _seconds(n_cached: int) -> float:
        u = prompt_len - n_cached
        compute = 2 * _macs(n_cached) / PEAK_OPS_INT8
        return max(compute, u * kv_tok / hbm_bw)

    with_cache, nocache = _seconds(cached), _seconds(0)
    return PrefixCachePoint(
        hit_rate=float(hit_rate), tokens_cached=cached,
        tokens_computed=prompt_len - cached,
        macs=_macs(cached), macs_nocache=_macs(0),
        macs_saved=_macs(0) - _macs(cached),
        kv_bytes_written=(prompt_len - cached) * kv_tok,
        kv_bytes_saved=cached * kv_tok,
        prefill_s=with_cache, prefill_s_nocache=nocache,
        ttft_speedup=nocache / with_cache)


# -------------------------------------------------------------- sampling --

@dataclasses.dataclass(frozen=True)
class SamplingPoint:
    """Priced per-step sampling point: selection on the card, where the
    logits are, against shipping the logits to the host over PCIe and
    launching once more to upload the picked tokens."""

    batch: int
    vocab: int
    sampled_frac: float             # fraction of rows with temperature > 0
    fused_ops: float                # argmax scan + top-k window ops
    fused_s: float                  # selection time on the card per step
    host_bytes: float               # logits shipped per step if host-sampled
    host_s: float                   # PCIe transfer + one more launch
    overhead_vs_greedy: float       # fused_s_sampled / fused_s_greedy
    speedup_vs_host: float          # host_s / fused_s


def sampling_point(*, batch: int, vocab: int, sampled_frac: float = 1.0,
                   logit_bytes: int = 4, peak_ops: float = PEAK_FLOPS_FP32,
                   pcie_bw: float = PCIE_BW,
                   dispatch_s: float = LAUNCH_S) -> SamplingPoint:
    """Price one (batch, vocab) sampling configuration. Greedy rows cost
    one O(B V) argmax scan; sampled rows add the top-`TOPK_CAP` window
    (O(B V log cap) compare-exchange operations). Selection is compare
    work, priced at `peak_ops`: the fp32 rate outside the tensor cores.
    The host alternative moves (batch, vocab) logits over PCIe each step
    and pays one more launch."""
    if batch < 1 or vocab < 2:
        raise ValueError(f"need batch >= 1 and vocab >= 2, got "
                         f"batch={batch} vocab={vocab}")
    if not 0.0 <= sampled_frac <= 1.0:
        raise ValueError(
            f"sampled_frac must be in [0, 1], got {sampled_frac}")
    from repro_torch.runtime.sampling import TOPK_CAP

    argmax_ops = batch * vocab
    window_ops = batch * vocab * math.log2(min(vocab, TOPK_CAP))
    fused_ops = argmax_ops + sampled_frac * window_ops
    fused_s = fused_ops / peak_ops
    host_bytes = batch * vocab * logit_bytes
    host_s = host_bytes / pcie_bw + dispatch_s
    greedy_s = argmax_ops / peak_ops
    return SamplingPoint(
        batch=int(batch), vocab=int(vocab),
        sampled_frac=float(sampled_frac), fused_ops=fused_ops,
        fused_s=fused_s, host_bytes=host_bytes, host_s=host_s,
        overhead_vs_greedy=fused_s / greedy_s,
        speedup_vs_host=host_s / fused_s)
