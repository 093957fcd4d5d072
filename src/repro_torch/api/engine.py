"""`InferenceEngine`: compress, then serve (port of the greedy serving half
of `repro.api.engine`).

    eng = InferenceEngine.build("opus-mt", plan)          # on cuda
    res = eng.serve(prompts, SamplingParams(max_tokens=32))

`serve` is in-flight batching with chunked prefill: every forward pass is
one token-budget step (`models.transformer.serve_step`) mixing prefill
chunks of newly admitted prompts with in-flight decode rows over the
blocked KV pool, scheduled by `runtime.scheduler.Scheduler` (FCFS,
prefix-cache admission with copy-on-write, pool-pressure preemption).

Devices: the engine runs on `cuda` unless the caller passes
`device="cpu"` (as the tests do); with no GPU and no explicit CPU it
raises. On CUDA every compressed linear runs the CUDA kernels and the
attention the paged-attention kernel; on CPU the same code runs their
plain versions.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.api.plan import CompressionPlan
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.compress import compress_params, flatten, map_with_path
from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models import transformer as tfm
from repro_torch.runtime import kvblocks
from repro_torch.runtime.scheduler import Request, Scheduler


def resolve_device(device=None) -> torch.device:
    """The engine's device: `cuda` by default, raising when there is no
    GPU; "cpu" only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _full_fp32() -> None:
    """opus-mt is an fp32 model: keep every float32 product (compression's
    power iterations included) in full float32 on the card; TF32 would
    keep about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def params_to(params, device):
    """The parameter tree with every tensor (and compressed node) moved to
    `device`."""
    return map_with_path(lambda _, leaf: leaf.to(device), params)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-call generation controls. Only greedy decoding is ported, so
    the only control is the number of new tokens."""

    max_tokens: int = 32

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")


def _percentile(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


@dataclasses.dataclass
class ServeResult:
    """Per-request continuations in submission order, plus step, chunk,
    prefix-cache and latency accounting (seconds on the host clock; each
    token is stamped when its readback completes)."""

    outputs: list
    prompt_lens: list
    seconds: float
    steps: int
    prefill_chunks: int
    prefill_tokens: int
    mixed_steps: int
    chunk_tokens: int
    max_queue_depth: int
    max_batch: int
    block_size: int
    num_blocks: int
    ttft: list = dataclasses.field(default_factory=list)
    tpot: list = dataclasses.field(default_factory=list)
    prefix_cache: bool = False
    cache_lookup_blocks: int = 0
    cache_hit_blocks: int = 0
    cache_hit_tokens: int = 0
    cache_cow_blocks: int = 0
    cache_evictions: int = 0
    preemptions: int = 0
    queue_times: list = dataclasses.field(default_factory=list)
    finish_times: list = dataclasses.field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return int(sum(o.size for o in self.outputs))

    @property
    def tokens_per_second(self) -> float:
        return self.total_tokens / max(self.seconds, 1e-9)

    @property
    def ttft_p50(self) -> float:
        return _percentile(self.ttft, 50)

    @property
    def tpot_p50(self) -> float:
        return _percentile([t for t in self.tpot if t > 0], 50)

    @property
    def cache_hit_rate(self) -> float:
        return (self.cache_hit_blocks / self.cache_lookup_blocks
                if self.cache_lookup_blocks else 0.0)


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << max(n - 1, 0).bit_length()


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host array that later host writes cannot reach.

    On CUDA the array is first copied into a fresh pinned buffer and sent
    with a non-blocking copy, so the host does not wait for the queued
    steps. PyTorch's pinned-memory allocator keeps that buffer from reuse
    until the copy has run, and `arr` itself is never read by the device."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class InferenceEngine:
    """Compressed model + greedy in-flight-batching server on one device."""

    def __init__(self, cfg: ModelConfig, params, *, device, plan=None,
                 report=None, max_batch: int = 8, block_size: int = 16,
                 chunk_tokens: int = 256, prefix_cache: bool = True):
        _full_fp32()
        self.cfg = cfg
        self.device = device
        self.params = params
        self.plan = plan
        self.report = report
        self.max_batch = max_batch
        self.block_size = block_size
        self.chunk_tokens = chunk_tokens
        self.prefix_cache = prefix_cache
        # per-layer views of the stacked weights, sliced once
        self._step_params = tfm.split_layers(params, cfg.num_layers)
        # seeds the prefix-cache content hashes: blocks are never shared
        # across engines whose K/V for the same tokens would differ
        plan_id = plan.dumps() if plan is not None else "dense"
        self._cache_fingerprint = hashlib.sha256(
            f"{cfg.name}:{cfg.dtype}:{cfg.kv_cache_bits}:{plan_id}".encode()
        ).digest()

    def weight_bytes(self) -> int:
        """Bytes the parameter tensors occupy on the device (packed W4
        codes count their halved size)."""
        total = 0
        for leaf in flatten(self.params).values():
            nodes = ([leaf.w1, leaf.w2] if isinstance(leaf, LowRankQ)
                     else [leaf])
            for q in nodes:
                parts = ((q.values, q.scale)
                         if isinstance(q, QuantizedTensor) else (q,))
                total += sum(t.numel() * t.element_size() for t in parts)
        return total

    # ------------------------------------------------------------- build --
    @classmethod
    def build(cls, arch, plan=None, *, params=None, smoke: bool = False,
              seed: int = 0, device=None, verbose: bool = False,
              max_batch: int = 8, block_size: int = 16,
              chunk_tokens: int = 256, prefix_cache: bool = True,
              kv_bits: int | None = None) -> "InferenceEngine":
        """arch: config name or a ModelConfig. plan: CompressionPlan or
        None (serve `params` as given: dense, or already compressed, e.g.
        from `repro_torch.bridge`). params: weights; freshly initialised
        from `seed` when omitted. kv_bits: override cfg.kv_cache_bits
        (8 = int8 KV codes with fp32 scales)."""
        dev = resolve_device(device)
        _full_fp32()                        # before compression runs
        cfg = get_config(arch, smoke=smoke) if isinstance(arch, str) else arch
        if kv_bits is not None:
            cfg = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
        if params is None:
            params = tfm.init_params(cfg, seed=seed, device=dev)
        else:
            params = params_to(params, dev)
        report = None
        if plan is not None:
            if not isinstance(plan, CompressionPlan):
                raise TypeError(f"plan must be a CompressionPlan, got "
                                f"{type(plan).__name__}")
            t0 = time.perf_counter()
            params, report = compress_params(params, plan)
            plan = report.plan
            if verbose:
                print(f"[engine] compressed in {time.perf_counter() - t0:.1f}"
                      f"s: {report.summary()}")
        return cls(cfg, params, device=dev, plan=plan, report=report,
                   max_batch=max_batch, block_size=block_size,
                   chunk_tokens=chunk_tokens, prefix_cache=prefix_cache)

    # ------------------------------------------------------------- serve --
    def serve(self, requests, sampling: SamplingParams | None = None, *,
              max_batch: int | None = None, block_size: int | None = None,
              num_blocks: int | None = None,
              chunk_tokens: int | None = None,
              prefix_cache: bool | None = None) -> ServeResult:
        """In-flight batching with chunked prefill: ragged prompts,
        per-request max_tokens, one fused step per scheduler step.

        requests: token sequences or `runtime.scheduler.Request`s. The
        loop is pipelined two steps deep: scheduling depends only on
        token counts, so later steps are dispatched (decode rows fed the
        previous step's tokens on the device) before earlier steps' tokens
        are read back with `.cpu()`. Each step uploads a fresh step buffer
        and, when they changed, a fresh copy of the block tables, so no
        host array a queued step may still read is ever mutated.

        prefix_cache shares full KV blocks between requests with equal
        position-aligned prompt prefixes (greedy output is unchanged)."""
        sampling = sampling or SamplingParams()
        reqs: list[Request] = []
        for i, r in enumerate(requests):
            if not isinstance(r, Request):
                r = Request(tokens=r)
            r = dataclasses.replace(
                r, rid=i, max_tokens=(sampling.max_tokens
                                      if r.max_tokens is None
                                      else r.max_tokens))
            reqs.append(r)
        if not reqs:
            raise ValueError("empty request batch")
        kvblocks.check_paged_support(self.cfg)
        dev = self.device

        bs = block_size or self.block_size
        cap = min(max_batch or self.max_batch, len(reqs))
        budget = chunk_tokens or self.chunk_tokens
        need = [kvblocks.blocks_needed(r.tokens.size, r.max_tokens, bs)
                for r in reqs]
        mb = max(max(need), 1)              # block-table width
        if num_blocks is None:
            num_blocks = cap * mb + 1       # +1: the reserved trash block
        use_cache = self.prefix_cache if prefix_cache is None else prefix_cache
        pool_alloc = kvblocks.BlockPool(num_blocks, bs)
        sched = Scheduler(pool_alloc, cap, prefix_cache=use_cache,
                          fingerprint=self._cache_fingerprint)
        for r in reqs:
            sched.submit(r)

        pool = kvblocks.init_paged_cache(self.cfg, num_blocks, bs, dev)
        tables = np.zeros((cap, mb), np.int32)
        out_vals: list[list[int]] = [[] for _ in reqs]
        first_tok_t = [None] * len(reqs)
        finish_t = [0.0] * len(reqs)
        queue_t = [0.0] * len(reqs)
        steps = prefill_chunks = prefill_tokens = mixed_steps = 0
        t0 = time.perf_counter()

        def consume(emits, toks_dev):
            """Read back one step's tokens (waits for that step) and credit
            them to their requests."""
            vals = toks_dev.cpu().numpy()
            now = time.perf_counter()
            for rid, r in emits:
                out_vals[rid].append(int(vals[r, 0]))
                if first_tok_t[rid] is None:
                    first_tok_t[rid] = now
                if len(out_vals[rid]) >= reqs[rid].max_tokens:
                    finish_t[rid] = now

        tables_dev = None
        inflight = collections.deque()
        prev_toks = torch.zeros((cap, 1), dtype=torch.int32, device=dev)
        with torch.inference_mode():
            while sched.has_work():
                plan = sched.schedule(budget)
                for r in plan.preempted:    # victim rows: table to trash
                    tables[r] = 0
                    tables_dev = None
                for seq in plan.admitted:
                    tables[seq.row] = 0
                    tables[seq.row, :len(seq.block_ids)] = seq.block_ids
                    tables_dev = None
                    queue_t[seq.req.rid] = time.perf_counter() - t0
                    if seq.cow_dst is not None:
                        # fully-cached prompt: a private copy of the last
                        # matched block before this step rewrites its
                        # final position
                        kvblocks.copy_block(pool, seq.cow_src, seq.cow_dst)
                        sched.release_cow(seq)
                if not plan.prefill and not plan.decode:
                    raise RuntimeError("scheduler returned an empty step "
                                       "with work pending")
                # ---- the (cap, W + 3) step buffer, fresh every step ------
                w = _pow2_bucket(plan.max_span)
                buf = np.zeros((cap, w + 3), np.int32)
                for r, width in plan.prefill.items():
                    seq = sched.rows[r]
                    lo = seq.prefilled
                    buf[r, :width] = seq.req.tokens[lo:lo + width]
                    buf[r, -3] = lo
                    buf[r, -2] = width
                for r in plan.decode:
                    seq = sched.rows[r]
                    # the input token is last step's, still on the device
                    buf[r, -3] = seq.prompt_len + seq.n_emitted - 1
                    buf[r, -2] = 1
                    buf[r, -1] = 1
                if tables_dev is None:
                    tables_dev = _upload(tables, dev)
                toks_dev, pool = tfm.serve_step(
                    self._step_params, pool, tables_dev, _upload(buf, dev),
                    prev_toks, self.cfg)
                steps += 1
                prefill_chunks += len(plan.prefill)
                prefill_tokens += sum(plan.prefill.values())
                mixed_steps += plan.is_mixed
                prev_toks = toks_dev
                # ---- count-based bookkeeping at dispatch time ------------
                emits = []
                for r, width in plan.prefill.items():
                    sched.advance_prefill(sched.rows[r], width)
                for r in list(plan.prefill) + plan.decode:
                    seq = sched.rows[r]
                    if not seq.prefill_done:
                        continue            # mid-prompt: logits unused
                    seq.n_emitted += 1
                    emits.append((seq.req.rid, r))
                    if seq.done:
                        sched.finish(seq)
                        tables[r] = 0
                        tables_dev = None
                inflight.append((emits, toks_dev))
                if len(inflight) > 2:
                    consume(*inflight.popleft())
            while inflight:
                consume(*inflight.popleft())
        if pool_alloc.available != pool_alloc.capacity:
            raise RuntimeError(
                f"leaked KV blocks: {pool_alloc.capacity - pool_alloc.available}"
                f" of {pool_alloc.capacity} still allocated after drain")
        outputs = [np.asarray(v, np.int32) for v in out_vals]
        ttft = [first_tok_t[i] - t0 for i in range(len(reqs))]
        tpot = [(finish_t[i] - first_tok_t[i]) / (len(out_vals[i]) - 1)
                if len(out_vals[i]) > 1 else 0.0 for i in range(len(reqs))]
        return ServeResult(
            outputs=outputs, prompt_lens=[r.tokens.size for r in reqs],
            seconds=time.perf_counter() - t0, steps=steps,
            prefill_chunks=prefill_chunks, prefill_tokens=prefill_tokens,
            mixed_steps=mixed_steps, chunk_tokens=budget,
            max_queue_depth=sched.max_queue_depth, max_batch=cap,
            block_size=bs, num_blocks=num_blocks, ttft=ttft, tpot=tpot,
            prefix_cache=use_cache,
            cache_lookup_blocks=sched.cache_lookup_blocks,
            cache_hit_blocks=sched.cache_hit_blocks,
            cache_hit_tokens=sched.cache_hit_tokens,
            cache_cow_blocks=sched.cache_cow_blocks,
            cache_evictions=pool_alloc.evictions,
            preemptions=sched.preemptions, queue_times=queue_t,
            finish_times=[finish_t[i] - t0 for i in range(len(reqs))])
