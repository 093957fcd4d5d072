"""`InferenceEngine`: compress, then generate or serve (port of
`repro.api.engine`).

    eng = InferenceEngine.build("opus-mt", plan)          # on cuda
    out = eng.generate(prompts, SamplingParams(max_tokens=32))
    res = eng.serve(prompts, SamplingParams(max_tokens=32, top_k=40,
                                            temperature=0.8, seed=7))

`generate` on a rectangular (B, S) batch is the static-batching baseline:
one `prefill` of the whole batch (prompts right-padded to a power-of-two
length bucket where padding is inert; the Mamba layouts, whose state
would take the pads in, at exact length), then `decode_step`s in lockstep
over a contiguous KV cache, every row to max_tokens, with stops applied
afterwards. Ragged prompt lists go through `serve`. Both paths pick tokens
with the same sampler and counter-based keys, so their greedy and seeded
sampled tokens agree.

`serve` is in-flight batching with chunked prefill: every forward pass is
one token-budget step (`models.transformer.serve_step`) mixing prefill
chunks of newly admitted prompts with in-flight decode rows over the
blocked KV pool, scheduled by `runtime.scheduler.Scheduler` (FCFS,
prefix-cache admission with copy-on-write, pool-pressure preemption).
Sampling (temperature, top-k, top-p, seed) and stop criteria (eos, stop
sequences, max_tokens) run on the device inside that step
(`runtime.sampling`); tokens stream through `on_token`. With a draft
(`build(speculate=...)` or `plan.draft`) greedy rows decode speculatively,
the truncated ITERA cascade drafting (`runtime.speculation`).

Devices: the engine runs on `cuda` unless the caller passes
`device="cpu"` (as the tests do); with no GPU and no explicit CPU it
raises. On CUDA every compressed linear runs the CUDA kernels and the
attention the paged-attention kernel; on CPU the same code runs their
plain versions.

Steps: every decode step of `generate`, serve step and speculative step
runs through a `runtime.graphs.StepGraph`, one per static shape, the
port's form of the reference's jitted steps: on CUDA it is captured as a
CUDA graph on first use and replayed after, so one step is one replay.
The engine holds the graphs and the device state they are bound to (the
KV pool and the static step inputs of a serve geometry, the decode cache
of a generate geometry) across calls, and resets that state at the
start of each call. `cuda_graphs=False` runs the same steps eagerly on
the card, for A/B runs; on the CPU they always run eagerly.

Tensor parallelism (`build(mesh=...)`, a `launch.mesh.ServingMesh`): one
process a rank, each building the full weights from the same seed or the
same `params`, compressing them, then keeping its slice
(`launch.sharding`): column-sliced wq/wk/wv/gate/up, row-sliced wo/down,
a replicated embedding and lm head, and a KV pool (or decode cache) of
its own heads. Every step (serve, speculative, generate's prefill and
decode) runs with the per-rank config and all-reduces a float32 partial
at each wo and down (2L a step, `runtime.shardctx`), so every rank holds
the same residual stream, logits and tokens, and takes the same
scheduling decisions (they depend on token counts only). Over NCCL the
step graphs are captured with the all-reduce calls in their steps (at
one rank NCCL launches nothing for them; a capture across cards is not
verified); over gloo, which reduces CUDA tensors through the host, the
engine must be built with `cuda_graphs=False`. The engine runs on the
mesh's device. Every rank builds and compresses the full model on that
device before slicing it, so a rank needs the memory of the whole
compressed model.
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
from repro_torch.core.compress import (CompressionConfig, compress_params,
                                       flatten, map_with_path)
from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.runtime import graphs as gr
from repro_torch.runtime import kvblocks
from repro_torch.runtime import sampling as smp
from repro_torch.runtime import shardctx
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.speculation import DraftSpec, SpeculationController


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
    """Keep every float32 product on the card in full float32, whatever
    the model's dtype: an fp32 model's float paths, and the float32
    upcast a bfloat16 model is compressed from (ITERA's power iterations,
    SVD), where TF32 would keep about three decimal digits and give other
    codes than the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def params_to(params, device):
    """The parameter tree with every tensor (and compressed node) moved to
    `device`."""
    return map_with_path(lambda _, leaf: leaf.to(device), params)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-call sampling / stop controls (a `runtime.scheduler.Request`
    can override any of them per request). temperature <= 0 is greedy;
    top_k == 0 and top_p == 1.0 truncate no tighter than the sampler's
    top-`sampling.TOPK_CAP` window. `stop` is a tuple of token-id
    sequences matched inclusively (generation stops after the token that
    completes a match, which stays in the output); eos_id is a one-token
    stop. Seeded runs replay token for token across repeats, prefix
    cache on or off, and speculation (counter-based keys)."""

    max_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: int | None = None
    stop: tuple = ()

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.eos_id is not None and self.eos_id < 0:
            raise ValueError(f"eos_id must be >= 0, got {self.eos_id}")
        object.__setattr__(self, "stop", tuple(
            tuple(int(t) for t in s) for s in self.stop))
        if any(len(s) == 0 for s in self.stop):
            raise ValueError("empty stop sequence")

    def to_dict(self) -> dict:
        d = {"max_tokens": self.max_tokens, "temperature": self.temperature,
             "top_k": self.top_k, "top_p": self.top_p, "seed": self.seed}
        if self.eos_id is not None:
            d["eos_id"] = int(self.eos_id)
        if self.stop:
            d["stop"] = [list(s) for s in self.stop]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingParams":
        return cls(max_tokens=int(d.get("max_tokens", 32)),
                   temperature=float(d.get("temperature", 0.0)),
                   top_k=int(d.get("top_k", 0)),
                   top_p=float(d.get("top_p", 1.0)),
                   seed=int(d.get("seed", 0)),
                   eos_id=(None if d.get("eos_id") is None
                           else int(d["eos_id"])),
                   stop=tuple(tuple(s) for s in d.get("stop", ())))


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token, delivered by serve(on_token=...) when the
    readback confirms it (the time TTFT and TPOT use). `index` is its
    position in the request's output; `final` marks the request's last
    token."""

    rid: int
    token: int
    index: int
    time: float
    final: bool


@dataclasses.dataclass
class GenerationResult:
    """`generate`'s continuations, (B, max_tokens) int32 in request order
    (rows that stopped early end in zeros), and its host seconds."""

    tokens: np.ndarray
    prompt_len: int             # ragged batches: the longest prompt
    seconds: float
    prompt_lens: list | None = None     # set for ragged batches

    @property
    def tokens_per_second(self) -> float:
        b, g = self.tokens.shape
        return b * g / max(self.seconds, 1e-9)


def _percentile(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


@dataclasses.dataclass
class ServeResult:
    """Per-request continuations in submission order, plus step, chunk,
    speculation, prefix-cache and latency accounting (seconds on the
    host clock; each token is stamped when its readback completes)."""

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
    # speculation (0 when off): `drafted` draft tokens proposed, of which
    # `accepted` survived verification, over `spec_rounds` drafting
    # rounds of width spec_k
    spec_k: int = 0
    drafted: int = 0
    accepted: int = 0
    spec_rounds: int = 0
    prefix_cache: bool = False
    cache_lookup_blocks: int = 0
    cache_hit_blocks: int = 0
    cache_hit_tokens: int = 0
    cache_cow_blocks: int = 0
    cache_evictions: int = 0
    preemptions: int = 0
    # queue_times[i]: request i's wait for admission; finish_times[i]:
    # its completion, both from serve() start. `stopped_early` counts
    # requests an eos / stop sequence finished before max_tokens.
    queue_times: list = dataclasses.field(default_factory=list)
    finish_times: list = dataclasses.field(default_factory=list)
    stopped_early: int = 0

    @property
    def total_tokens(self) -> int:
        return int(sum(o.size for o in self.outputs))

    @property
    def tokens_per_second(self) -> float:
        return self.total_tokens / max(self.seconds, 1e-9)

    @property
    def accept_rate(self) -> float:
        """Fraction of proposed draft tokens the full model kept."""
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def ttft_p50(self) -> float:
        return _percentile(self.ttft, 50)

    @property
    def ttft_p95(self) -> float:
        return _percentile(self.ttft, 95)

    @property
    def tpot_p50(self) -> float:
        return _percentile([t for t in self.tpot if t > 0], 50)

    @property
    def tpot_p95(self) -> float:
        return _percentile([t for t in self.tpot if t > 0], 95)

    @property
    def queue_p50(self) -> float:
        return _percentile(self.queue_times, 50)

    @property
    def queue_p95(self) -> float:
        return _percentile(self.queue_times, 95)

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of looked-up full prompt blocks served by reference."""
        return (self.cache_hit_blocks / self.cache_lookup_blocks
                if self.cache_lookup_blocks else 0.0)

    @property
    def cache_hit_token_rate(self) -> float:
        """Fraction of all prompt tokens whose prefill was skipped."""
        total = sum(self.prompt_lens)
        return self.cache_hit_tokens / total if total else 0.0

    @property
    def cache_blocks_saved(self) -> int:
        """Physical blocks admission did not allocate thanks to sharing
        (copy-on-write sources still cost a private copy)."""
        return self.cache_hit_blocks - self.cache_cow_blocks

    def goodput(self, deadline_s: float) -> float:
        """Tokens per second counting only requests that finished within
        `deadline_s` of serve() start."""
        good = sum(self.outputs[i].size for i, f in enumerate(
            self.finish_times) if f <= deadline_s)
        return good / max(self.seconds, 1e-9)

    def slo_attainment(self, ttft_s: float, tpot_s: float) -> float:
        """Fraction of requests meeting both a TTFT and a per-output-token
        latency target."""
        n = len(self.outputs)
        if not n:
            return 0.0
        return sum(1 for i in range(n) if self.ttft[i] <= ttft_s
                   and self.tpot[i] <= tpot_s) / n


def _as_token_batch(requests):
    """A (B, S) int32 array when every prompt has the same length, else a
    list of 1-D int32 prompts (which `generate` serves through the
    scheduler)."""
    if isinstance(requests, (list, tuple)):
        if not requests:
            raise ValueError("empty request batch")
        rows = [np.asarray(r, np.int32) for r in requests]
        if any(r.ndim != 1 for r in rows):
            raise ValueError(
                f"each request must be a 1-D token sequence, got shapes "
                f"{[r.shape for r in rows]}")
        if any(r.size == 0 for r in rows):
            raise ValueError("empty prompt in request batch")
        if len({r.size for r in rows}) != 1:
            return rows
        requests = np.stack(rows)
    toks = np.asarray(requests, np.int32)
    if toks.ndim != 2:
        raise ValueError(f"requests must be (batch, seq), got {toks.shape}")
    return toks


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << max(n - 1, 0).bit_length()


def _generate_pick(logits, temperature, top_k, top_p, seed, counter):
    """(B, 1) int32 next tokens sampled from the last position of (B, ...,
    V) logits, for `generate`. The controls are 0-dim device tensors (a
    captured decode step reads them, and its counter, where the engine
    refills them) or host scalars, broadcast to every row; row r's key is
    row_keys(seed, r, counter): serve gives the same prompts rids 0..B-1
    and the same counters, so both paths sample the same tokens under one
    seed."""
    last = logits[:, -1]
    b, dev = last.shape[0], last.device

    def rows(x, dt):
        if isinstance(x, torch.Tensor):
            return x.to(dt).expand(b)
        return torch.full((b,), x, dtype=dt, device=dev)

    keys = smp.row_keys(rows(seed, torch.int32),
                        torch.arange(b, dtype=torch.int32, device=dev),
                        rows(counter, torch.int32))
    return smp.sample_tokens(last, rows(temperature, torch.float32),
                             rows(top_k, torch.int32),
                             rows(top_p, torch.float32), keys)[:, None]


def _pinned(arr: np.ndarray, device) -> torch.Tensor:
    """A host copy of `arr` that later host writes cannot reach, pinned
    when it goes to CUDA: a non-blocking copy from it does not wait for
    the queued steps, and PyTorch's pinned-memory allocator keeps the
    buffer from reuse until the copy has run."""
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.pin_memory() if device.type == "cuda" else t


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A fresh device copy of a host array (see `_pinned`)."""
    return _pinned(arr, device).to(device, non_blocking=True)


def _copy_in(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Refill a static step input from a host array (see `_pinned`)."""
    dst.copy_(_pinned(arr, dst.device), non_blocking=True)


def _resolve_speculate(speculate, plan) -> DraftSpec | None:
    """build(speculate=...): a DraftSpec as given; None defers to
    `plan.draft`; True takes the plan's draft or the defaults; False or 0
    is off; an int k is DraftSpec(k=k)."""
    if isinstance(speculate, DraftSpec):
        return speculate
    if speculate is None:
        return plan.draft if plan is not None else None
    if speculate is True:
        return (plan.draft if plan is not None and plan.draft is not None
                else DraftSpec())
    if not speculate:
        return None
    return DraftSpec(k=int(speculate))


_HELD_GEOMETRIES = 4     # serve / generate geometries whose state an engine keeps


class InferenceEngine:
    """Compressed model + in-flight-batching server on one device, or one
    rank of a tensor-parallel mesh."""

    def __init__(self, cfg: ModelConfig, params, *, device, plan=None,
                 report=None, max_batch: int = 8, block_size: int = 16,
                 chunk_tokens: int = 256, bucket_prompts: bool = True,
                 prefix_cache: bool = True,
                 speculate: DraftSpec | None = None,
                 cuda_graphs: bool = True, mesh=None):
        """params: the model's full weights on `device`; with a `mesh`
        (`launch.mesh.ServingMesh`) they lie on the mesh rank's device,
        where the engine runs (`device` is not read), and the engine keeps
        this rank's slice of them as `self.params`."""
        _full_fp32()
        self.cfg = cfg
        self.mesh = mesh
        tp, rank = (mesh.size, mesh.rank) if mesh is not None else (0, 0)
        if mesh is not None:
            device = mesh.device
            shd.check_tp_geometry(cfg, tp)
            if cuda_graphs and mesh.backend == "gloo" and \
                    device.type == "cuda":
                raise ValueError(
                    "gloo all-reduces CUDA tensors through the host, which a "
                    "CUDA graph cannot capture: build the engine with "
                    "cuda_graphs=False, or over NCCL")
        # the per-rank config the steps run with (the full one without a
        # mesh) and the TP group they bind (None: no all-reduce)
        self.step_cfg = shd.tp_local_config(cfg, tp)
        self._tp_group = mesh.group if mesh is not None else None
        self.params = (shd.tp_shard_params(params, tp, rank)
                       if mesh is not None else params)
        self.device = device
        self.plan = plan
        self.report = report
        self.max_batch = max_batch
        self.block_size = block_size
        self.chunk_tokens = chunk_tokens
        self.prefix_cache = prefix_cache
        # generate(): right-pad prompts to power-of-two length buckets, only
        # where padding is inert (see `_can_bucket`)
        self.bucket_prompts = bucket_prompts and self._can_bucket(cfg)
        # per-layer views of the stacked weights, sliced once
        self._step_params = tfm.split_layers(self.params, cfg.num_layers)
        # the draft shares every tensor it does not truncate with `params`
        # (with a mesh: derived from the full weights, then sliced)
        self.speculation = (SpeculationController(speculate, cfg, params,
                                                  mesh=mesh)
                            if speculate is not None else None)
        # seeds the prefix-cache content hashes: blocks are never shared
        # across engines whose K/V for the same tokens would differ
        plan_id = plan.dumps() if plan is not None else "dense"
        self._cache_fingerprint = hashlib.sha256(
            f"{cfg.name}:{cfg.dtype}:{cfg.kv_cache_bits}:{plan_id}:tp{tp}:"
            f"rank{rank}".encode()).digest()
        # steps are captured as CUDA graphs on the card unless the caller
        # asks for the eager loop (A/B runs); one private memory pool for
        # all of this engine's graphs (see `runtime.graphs`)
        self.cuda_graphs = cuda_graphs and device.type == "cuda"
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        # geometry -> its device state and step graphs, oldest first
        self._serve_slots: collections.OrderedDict = collections.OrderedDict()
        self._decoders: collections.OrderedDict = collections.OrderedDict()

    @staticmethod
    def _can_bucket(cfg) -> bool:
        """Right-padding a prompt is inert under dense global causal
        attention: pad K/V sit in slots no decode query sees before decode
        overwrites them. A rolling (windowed) cache would fold the pads
        into what decode reads."""
        return (cfg.layout == "dense" and not cfg.attn_window
                and not cfg.local_global_period)

    def weight_hbm_bytes(self) -> int:
        """Bytes the parameter tensors occupy on the device: every tensor of
        the tree, packed W4 codes at their halved size."""
        total = 0
        for leaf in flatten(self.params).values():
            nodes = ([leaf.w1, leaf.w2] if isinstance(leaf, LowRankQ)
                     else [leaf])
            for q in nodes:
                parts = ((q.values, q.scale)
                         if isinstance(q, QuantizedTensor) else (q,))
                total += sum(t.numel() * t.element_size() for t in parts)
        return total

    # ---------------------------------------------------------- generate --
    def generate(self, requests, sampling: SamplingParams | None = None
                 ) -> GenerationResult:
        """Continuations of a batch of prompts, (B, max_tokens), in request
        order.

        requests: (B, S) int tokens, an array or a list of equal-length
        token lists, run rectangular: one eager `prefill` of the batch
        (right-padded to a power-of-two bucket when `bucket_prompts`
        holds), then max_tokens - 1 lockstep `decode_step`s over the
        contiguous cache, each the replay of one step graph per (B, cache
        length, greedy or sampled), with no readback until the end.
        Ragged lists are served by `serve`.
        Stop criteria (eos_id, stop) are applied afterwards with
        `sampling.match_stop_host`: inclusive, with zeros after the stop,
        as `serve`'s outputs padded to max_tokens."""
        sampling = sampling or SamplingParams()
        toks = _as_token_batch(requests)
        if isinstance(toks, list):          # ragged: continuous batching
            res = self.serve(toks, sampling)
            out = np.zeros((len(res.outputs), sampling.max_tokens), np.int32)
            for i, o in enumerate(res.outputs):
                out[i, :o.size] = o         # stop-shortened rows: zero tail
            return GenerationResult(
                tokens=out, prompt_len=max(res.prompt_lens),
                seconds=res.seconds, prompt_lens=list(res.prompt_lens))
        s = toks.shape[1]
        padded = _pow2_bucket(s) if self.bucket_prompts else s
        if padded != s:
            toks = np.pad(toks, ((0, 0), (0, padded - s)))
        n = sampling.max_tokens
        sampled = sampling.temperature > 0.0
        controls = {"temperature": sampling.temperature,
                    "top_k": sampling.top_k, "top_p": sampling.top_p,
                    "seed": sampling.seed}
        t0 = time.perf_counter()
        with torch.inference_mode(), shardctx.tp_group(self._tp_group):
            logits, cache = tfm.prefill(self._step_params,
                                        _upload(toks, self.device),
                                        self.step_cfg, max_len=padded + n,
                                        last_pos=s - 1)
            tok = self._pick(logits, sampled, counter=0, **controls)
            out = [tok]
            if n > 1:
                step = self._decoder(toks.shape[0], padded + n, sampled)
                ins = step.inputs
                # "kv"; "local" and "global"; or "ssm" ({"h", "conv"})
                # and the hybrid's "shared_kv"
                for group, leaves in cache.items():
                    for name, leaf in leaves.items():
                        ins["cache"][group][name].copy_(leaf)
                ins["tok"].copy_(tok)
                ins["pos"].fill_(s)
                ins["counter"].fill_(1)
                for name, value in controls.items():
                    ins[name].fill_(value)
                out += [step()[0] for _ in range(1, n)]
            arr = torch.cat(out, dim=1).cpu().numpy()
        if sampling.eos_id is not None or sampling.stop:
            for row in arr:
                keep = smp.match_stop_host(row, sampling.eos_id,
                                           sampling.stop, n)
                row[keep:] = 0
        return GenerationResult(tokens=arr, prompt_len=s,
                                seconds=time.perf_counter() - t0)

    @staticmethod
    def _pick(logits, sampled: bool, *, temperature, top_k, top_p, seed,
              counter):
        """(B, 1) int32 next tokens from (B, ..., V) logits: the argmax of
        the last position (the first maximum), or, when `sampled`,
        `_generate_pick`'s draw for output index `counter`."""
        if not sampled:
            return torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32)
        return _generate_pick(logits, temperature, top_k, top_p, seed,
                              counter)

    def _decoder(self, b: int, max_len: int, sampled: bool):
        """The decode step graph of a (B, cache length, greedy or sampled)
        geometry, bound to the engine-held decode cache of that geometry,
        which `generate` refills from each prefill (opus-mt's 8 x 160
        positions hold about 31 MB; a local/global model holds both
        groups, the local one rolling; a Mamba model its blocks' states
        and conv tails, which each step updates in place, and the hybrid's
        shared-block KV caches); its static inputs are the input
        token, the position, the output counter and the sampling controls,
        each advanced in place by the step itself."""
        key = (b, max_len, sampled)
        step = _held(self._decoders, key)
        if step is not None:
            return step
        dev = self.device

        def scalar(dt, value=0):
            return torch.full((), value, dtype=dt, device=dev)

        inputs = {"cache": tfm.init_cache(self.step_cfg, b, max_len,
                                          device=dev),
                  "tok": torch.zeros((b, 1), dtype=torch.int32, device=dev),
                  "pos": scalar(torch.long), "counter": scalar(torch.int32),
                  "temperature": scalar(torch.float32),
                  "top_k": scalar(torch.int32),
                  "top_p": scalar(torch.float32, 1.0),
                  "seed": scalar(torch.int32)}

        def decode(cache, tok, pos, counter, **controls):
            logits, _ = tfm.decode_step(self._step_params, cache, tok, pos,
                                        self.step_cfg)
            nxt = self._pick(logits, sampled, counter=counter, **controls)
            tok.copy_(nxt)
            pos.add_(1)
            counter.add_(1)
            return (nxt,)

        step = self._step_graph(decode, inputs)
        _hold(self._decoders, key, step)
        return step

    def _step_graph(self, fn, inputs) -> gr.StepGraph:
        """A step graph of `fn` that runs (and is captured) with the
        engine's TP group bound."""
        def step(**kw):
            with shardctx.tp_group(self._tp_group):
                return fn(**kw)

        return gr.StepGraph(step, inputs, capture=self.cuda_graphs,
                            pool=self._graph_pool)

    def graph_stats(self) -> dict:
        """Step graphs this engine holds that were captured, the seconds
        their captures took and the device bytes they reserved (0 without
        capture)."""
        steps = list(self._decoders.values())
        for slot in self._serve_slots.values():
            steps += slot.graphs.values()
        return gr.stats(steps)

    # ------------------------------------------------------------- build --
    @classmethod
    def build(cls, arch, plan=None, *, params=None, smoke: bool = False,
              seed: int = 0, device=None, verbose: bool = False,
              max_batch: int = 8, block_size: int = 16,
              chunk_tokens: int = 256, prefix_cache: bool = True,
              kv_bits: int | None = None, speculate=None,
              cuda_graphs: bool = True, mesh=None) -> "InferenceEngine":
        """arch: config name or a ModelConfig. plan: CompressionPlan, a
        uniform `CompressionConfig` (lowered to a plan against the
        weights; its per-layer `ranks`, e.g. from SRA, go through
        `rank_for`), or None (serve `params` as given: dense, or already
        compressed, e.g. from `repro_torch.bridge`). params: weights;
        freshly initialised from `seed` when omitted. kv_bits: override
        cfg.kv_cache_bits (8 = int8 KV codes with fp32 scales).
        speculate: None defers to `plan.draft`; a DraftSpec, True (the
        plan's draft or the defaults) or an int draft depth k turns
        speculation on; False or 0 turns it off. cuda_graphs=False runs
        every step eagerly on the card instead of replaying its CUDA graph
        (for A/B runs; the CPU always runs eagerly). mesh: this process's
        `launch.mesh.ServingMesh` for tensor-parallel serving: the weights
        are built in full (from `seed` or `params`), compressed, then
        sliced to the rank, and the engine runs on the mesh's device
        (`device` is not read)."""
        if mesh is not None:
            device = mesh.device
        dev = resolve_device(device)
        _full_fp32()                        # before compression runs
        cfg = get_config(arch, smoke=smoke) if isinstance(arch, str) else arch
        if kv_bits is not None:
            cfg = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
        if mesh is not None:
            shd.check_tp_geometry(cfg, mesh.size)
        if params is None:
            params = tfm.init_params(cfg, seed=seed, device=dev)
        else:
            params = params_to(params, dev)
        report = None
        if isinstance(plan, CompressionConfig):
            plan = None if plan.method == "none" else plan.to_plan(params)
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
                   chunk_tokens=chunk_tokens, prefix_cache=prefix_cache,
                   speculate=_resolve_speculate(speculate, plan),
                   cuda_graphs=cuda_graphs, mesh=mesh)

    # ------------------------------------------------------------- serve --
    def serve(self, requests, sampling: SamplingParams | None = None, *,
              max_batch: int | None = None, block_size: int | None = None,
              num_blocks: int | None = None,
              chunk_tokens: int | None = None,
              speculate: bool | None = None,
              prefix_cache: bool | None = None,
              on_token=None) -> ServeResult:
        """In-flight batching with chunked prefill: ragged prompts,
        per-request sampling and stops, one step per scheduler step.

        requests: token sequences or `runtime.scheduler.Request`s, whose
        unset fields take `sampling`'s values. The loop is pipelined two
        steps deep: scheduling depends only on token counts, so later
        steps are dispatched (decode rows fed the previous step's tokens
        on the device) before earlier steps' tokens are read back with
        `.cpu()`. Each step uploads one fresh buffer (span tokens,
        scheduling columns and each row's packed sampling metadata) and,
        when they changed, fresh copies of the block tables and stop
        sequences, so no host array a queued step may read is mutated.

        Sampling and stop evaluation run on the device in the same step.
        The finished mask rides the pipelined readback, so a stop is
        learned up to two steps late: those steps' tokens for the row are
        discarded and the row's blocks freed. An all-greedy call with no
        stop criteria runs the greedy step (no top-k, no PRNG, no ring).

        With a draft (`build(speculate=...)` or `plan.draft`) the call
        runs the synchronous speculative loop instead: greedy decode rows
        draft and verify in one dispatch, with the plain serve's tokens;
        sampled rows never draft but sample in the same dispatch.
        `speculate=False` turns it off for this call, `speculate=True`
        requires a draft.

        on_token(TokenEvent) is called on the serving thread as each
        token's readback confirms it. prefix_cache shares full KV blocks
        between requests with equal position-aligned prompt prefixes
        (the tokens are unchanged).

        Each step is the replay of one step graph per (sample, stop, W),
        W the span's power-of-two bucket (speculative: per (draft width,
        W, sample)), bound to the engine-held KV pool and static inputs
        of the call's geometry (max_batch rows, table width, pool blocks,
        block size, stop shape), which the call first resets to a fresh
        pool's contents."""
        sampling = sampling or SamplingParams()
        ctl = self.speculation
        if speculate is False:
            ctl = None
        elif speculate is True and ctl is None:
            raise ValueError(
                "speculate=True but the engine has no draft model: build "
                "with speculate=DraftSpec(...) or a plan carrying .draft")
        reqs: list[Request] = []
        for i, r in enumerate(requests):
            if not isinstance(r, Request):
                r = Request(tokens=r)
            repl: dict = {"rid": i}
            for f in ("max_tokens", "temperature", "top_k", "top_p", "seed",
                      "eos_id"):
                if getattr(r, f) is None:
                    repl[f] = getattr(sampling, f)
            if not r.stop:
                repl["stop"] = sampling.stop
            reqs.append(dataclasses.replace(r, **repl))
        if not reqs:
            raise ValueError("empty request batch")
        kvblocks.check_paged_support(self.cfg)
        do_sample = any(r.temperature > 0.0 for r in reqs)
        do_stop = any(r.eos_id is not None or r.stop for r in reqs)

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

        # the stop buffers' shape: every row's stop sequences, right-aligned
        n_stops = max([len(r.stop) for r in reqs] + [1])
        stop_len = max([len(s) for r in reqs for s in r.stop] + [1])
        with torch.inference_mode():
            slot = self._serve_slot(cap, mb, num_blocks, bs, n_stops,
                                    stop_len)
            st = _ServeState(reqs, np.zeros((cap, mb), np.int32), slot,
                             on_token)
            if ctl is not None:
                self._spec_loop(st, sched, cap, budget, ctl, do_sample)
            else:
                self._pipelined_loop(st, sched, cap, budget, do_sample,
                                     do_stop)
        if pool_alloc.available != pool_alloc.capacity:
            raise RuntimeError(
                f"leaked KV blocks: {pool_alloc.capacity - pool_alloc.available}"
                f" of {pool_alloc.capacity} still allocated after drain")
        n = len(reqs)
        outputs = [np.asarray(v, np.int32) for v in st.out]
        ttft = [st.first_t[i] - st.t0 for i in range(n)]
        tpot = [(st.finish_t[i] - st.first_t[i]) / (len(st.out[i]) - 1)
                if len(st.out[i]) > 1 else 0.0 for i in range(n)]
        return ServeResult(
            outputs=outputs, prompt_lens=[r.tokens.size for r in reqs],
            seconds=time.perf_counter() - st.t0, steps=st.steps,
            prefill_chunks=st.prefill_chunks,
            prefill_tokens=st.prefill_tokens, mixed_steps=st.mixed_steps,
            chunk_tokens=budget, max_queue_depth=sched.max_queue_depth,
            max_batch=cap, block_size=bs, num_blocks=num_blocks, ttft=ttft,
            tpot=tpot, spec_k=ctl.spec.k if ctl is not None else 0,
            drafted=st.drafted, accepted=st.accepted,
            spec_rounds=st.spec_rounds, prefix_cache=use_cache,
            cache_lookup_blocks=sched.cache_lookup_blocks,
            cache_hit_blocks=sched.cache_hit_blocks,
            cache_hit_tokens=sched.cache_hit_tokens,
            cache_cow_blocks=sched.cache_cow_blocks,
            cache_evictions=pool_alloc.evictions,
            preemptions=sched.preemptions, queue_times=st.queue_t,
            finish_times=[st.finish_t[i] - st.t0 for i in range(n)],
            stopped_early=st.stopped_early)

    def _serve_slot(self, cap, mb, num_blocks, bs, n_stops, stop_len):
        """The engine-held device state of a serve geometry, reset to what
        a fresh pool holds."""
        key = (cap, mb, num_blocks, bs, n_stops, stop_len)
        slot = _held(self._serve_slots, key)
        if slot is None:
            slot = _ServeSlot(self.step_cfg, *key, self.device)
            _hold(self._serve_slots, key, slot)
        slot.reset()
        return slot

    def _admit(self, st, sched, plan, stop_buf=None) -> None:
        """Install the step's preempted and admitted rows: block tables
        (and stop sequences), queue times, copy-on-write copies."""
        for r in plan.preempted:            # victim rows: table to trash
            st.tables[r] = 0
            st.tables_dirty = True
        for seq in plan.admitted:
            st.tables[seq.row] = 0
            st.tables[seq.row, :len(seq.block_ids)] = seq.block_ids
            st.tables_dirty = True
            st.queue_t[seq.req.rid] = time.perf_counter() - st.t0
            if stop_buf is not None:
                stop_buf[seq.row] = smp.pack_stop_seqs(
                    seq.req.stop, stop_buf.shape[1], stop_buf.shape[2])
                st.stops_dirty = True
            if seq.cow_dst is not None:
                # fully-cached prompt: a private copy of the last matched
                # block before this step rewrites its final position
                # (eager, ordered on the stream with the replays)
                kvblocks.copy_block(st.slot.pool, seq.cow_src, seq.cow_dst)
                sched.release_cow(seq)
        if not plan.prefill and not plan.decode:
            raise RuntimeError("scheduler returned an empty step with work "
                               "pending")

    def _sync_tables(self, st) -> None:
        """Refill the static block tables where the host changed them."""
        if st.tables_dirty:
            _copy_in(st.slot.tables, st.tables)
            st.tables_dirty = False

    def _count_step(self, st, plan) -> None:
        st.steps += 1
        st.prefill_chunks += len(plan.prefill)
        st.prefill_tokens += sum(plan.prefill.values())
        st.mixed_steps += plan.is_mixed

    def _finish_row(self, st, sched, seq) -> None:
        sched.finish(seq)
        st.tables[seq.row] = 0
        st.tables_dirty = True

    def _serve_graph(self, slot, do_sample, do_stop, w) -> gr.StepGraph:
        """The serve step graph of span width `w` (`tfm.serve_step`): it
        reads a (cap, w + 3 + SAMP_COLS) step buffer of its own and the
        slot's tables, `prev`, `recent` and stop sequences, and writes its
        tokens into `prev` and the pushed ring into `recent`."""
        key = ("serve", do_sample, do_stop, w)
        step = slot.graphs.get(key)
        if step is not None:
            return step
        cap = slot.tables.shape[0]

        def serve(buf, tables, prev, recent, stops):
            toks, fin, pushed, _ = tfm.serve_step(
                self._step_params, slot.pool, tables, buf, prev, recent,
                stops, self.step_cfg, sample=do_sample, stop=do_stop)
            prev.copy_(toks)
            if do_stop:
                recent.copy_(pushed)
            return toks, fin

        buf = torch.zeros((cap, w + 3 + smp.SAMP_COLS), dtype=torch.int32,
                          device=self.device)
        step = self._step_graph(serve, {
            "buf": buf, "tables": slot.tables, "prev": slot.prev,
            "recent": slot.recent, "stops": slot.stops if do_stop else None})
        slot.graphs[key] = step
        return step

    def _spec_graph(self, slot, ctl, k_step, w, do_sample) -> gr.StepGraph:
        """The speculative step graph of draft width `k_step` and span
        width `w` (`SpeculationController.step`): a (cap, w + 4 +
        SAMP_COLS) step buffer of its own, the slot's tables and `prev`,
        into which it writes each row's newest token."""
        key = ("spec", k_step, w, do_sample)
        step = slot.graphs.get(key)
        if step is not None:
            return step
        cap = slot.tables.shape[0]

        def speculate(buf, tables, prev):
            full, n_acc, nxt, _ = ctl.step(self._step_params, slot.pool,
                                           tables, buf, prev, k_step,
                                           sample=do_sample)
            prev.copy_(nxt)
            return full, n_acc

        buf = torch.zeros((cap, w + 4 + smp.SAMP_COLS), dtype=torch.int32,
                          device=self.device)
        step = self._step_graph(speculate, {"buf": buf, "tables": slot.tables,
                                            "prev": slot.prev})
        slot.graphs[key] = step
        return step

    def _pipelined_loop(self, st, sched, cap, budget, do_sample,
                        do_stop) -> None:
        """The two-deep pipelined serve loop (see `serve`)."""
        m = smp.SAMP_COLS
        reqs = st.reqs
        stop_buf = (np.full(tuple(st.slot.stops.shape), -1, np.int32)
                    if do_stop else None)
        # rids whose stop fired before max_tokens, learned at consume
        # time; the loop top frees their rows
        stopped: set[int] = set()

        def consume(emits, toks_dev, fin_dev):
            """Read back one step's tokens and finished mask (waits for
            that step) and credit them to their requests."""
            vals = toks_dev.cpu().numpy()
            fins = None if fin_dev is None else fin_dev.cpu().numpy()
            now = time.perf_counter()
            for rid, r in emits:
                if rid in stopped:
                    continue        # dispatched past the row's stop
                done = st.emit(rid, [int(vals[r, 0])], now,
                               fins is not None and bool(fins[r]))
                if done and len(st.out[rid]) < reqs[rid].max_tokens:
                    stopped.add(rid)

        inflight = collections.deque()
        while sched.has_work():
            if stopped:
                for seq in list(sched.rows):
                    if seq is not None and seq.req.rid in stopped:
                        self._finish_row(st, sched, seq)
                if not sched.has_work():
                    break
            plan = sched.schedule(budget)
            self._admit(st, sched, plan, stop_buf)
            # ---- the (cap, W + 3 + SAMP_COLS) step buffer, fresh --------
            w = _pow2_bucket(plan.max_span)
            buf = np.zeros((cap, w + 3 + m), np.int32)
            for r, width in plan.prefill.items():
                seq = sched.rows[r]
                lo = seq.prefilled
                buf[r, :width] = seq.req.tokens[lo:lo + width]
                buf[r, -(m + 3)] = lo
                buf[r, -(m + 2)] = width
            for r in plan.decode:
                seq = sched.rows[r]
                # the input token is last step's, still on the device
                buf[r, -(m + 3)] = seq.prompt_len + seq.n_emitted - 1
                buf[r, -(m + 2)] = 1
                buf[r, -(m + 1)] = 1
            if do_sample or do_stop:        # the greedy step reads none
                for r in list(plan.prefill) + plan.decode:
                    seq = sched.rows[r]
                    smp.write_row_meta(buf, r, seq.req, seq.n_emitted)
            if do_stop and st.stops_dirty:
                _copy_in(st.slot.stops, stop_buf)
                st.stops_dirty = False
            self._sync_tables(st)
            step = self._serve_graph(st.slot, do_sample, do_stop, w)
            _copy_in(step.inputs["buf"], buf)
            toks_dev, fin_dev = step()
            self._count_step(st, plan)
            # ---- count-based bookkeeping at dispatch time ---------------
            emits = []
            for r, width in plan.prefill.items():
                sched.advance_prefill(sched.rows[r], width)
            for r in list(plan.prefill) + plan.decode:
                seq = sched.rows[r]
                if not seq.prefill_done:
                    continue                # mid-prompt: logits unused
                seq.n_emitted += 1
                emits.append((seq.req.rid, r))
                if seq.done:
                    self._finish_row(st, sched, seq)
            inflight.append((emits, toks_dev, fin_dev))
            if len(inflight) > 2:
                consume(*inflight.popleft())
        while inflight:
            consume(*inflight.popleft())
        st.stopped_early += len(stopped)

    def _spec_loop(self, st, sched, cap, budget, ctl, do_sample) -> None:
        """The speculative serve loop: one draft -> verify -> accept
        dispatch a step (`runtime.speculation.speculative_step`).

        Synchronous: how far a row advanced depends on the accept count,
        so the next schedule waits for this step's readback. A step
        drafts at width spec.k when any row drafts and at 0 otherwise.
        Sampled rows never draft but sample in the same dispatch. Stops
        are matched on the host with `sampling.match_stop_host`, since
        every token is read back here anyway."""
        m = smp.SAMP_COLS
        while sched.has_work():
            plan = sched.schedule(budget, spec_k=ctl.spec.k)
            self._admit(st, sched, plan)
            # a draft reservation can grow a row's table mid-flight
            for r in plan.spec:
                seq = sched.rows[r]
                if seq.draft_blocks:
                    st.tables[r, :len(seq.block_ids)] = seq.block_ids
                    st.tables_dirty = True
            # ---- (cap, W + 4 + SAMP_COLS): the meta gains spec_lens ----
            k_step = ctl.spec.k if plan.spec else 0
            w = _pow2_bucket(max(plan.max_span, k_step + 1))
            buf = np.zeros((cap, w + 4 + m), np.int32)
            for r, width in plan.prefill.items():
                seq = sched.rows[r]
                lo = seq.prefilled
                buf[r, :width] = seq.req.tokens[lo:lo + width]
                buf[r, -(m + 4)] = lo
                buf[r, -(m + 3)] = width
            for r in plan.decode:
                seq = sched.rows[r]
                kr = plan.spec.get(r, 0)
                # span: [prev (spliced on the device), kr draft slots]
                buf[r, -(m + 4)] = seq.prompt_len + seq.n_emitted - 1
                buf[r, -(m + 3)] = 1 + kr
                buf[r, -(m + 2)] = 1
                buf[r, -(m + 1)] = kr
            for r in list(plan.prefill) + plan.decode:
                seq = sched.rows[r]
                smp.write_row_meta(buf, r, seq.req, seq.n_emitted)
            self._sync_tables(st)
            step = self._spec_graph(st.slot, ctl, k_step, w, do_sample)
            _copy_in(step.inputs["buf"], buf)
            full_toks, n_acc = step()
            self._count_step(st, plan)
            st.spec_rounds += bool(plan.spec)
            # the accept counts decide how far each row advanced
            back = torch.cat([full_toks, n_acc[:, None]], dim=1).cpu()
            fv, na = back[:, :-1].numpy(), back[:, -1].numpy()
            now = time.perf_counter()
            for r, width in plan.prefill.items():
                sched.advance_prefill(sched.rows[r], width)
            for r in list(plan.prefill) + plan.decode:
                seq = sched.rows[r]
                if not seq.prefill_done:
                    continue                # mid-prompt: logits unused
                if r in plan.prefill:       # prompt done: last position
                    toks = fv[r, k_step + 1:k_step + 2]
                else:                       # accepted drafts + 1
                    toks = fv[r, :int(na[r]) + 1]
                seq.n_emitted += len(toks)
                kr = plan.spec.get(r, 0)
                if kr:
                    st.drafted += kr
                    st.accepted += len(toks) - 1
                    if sched.commit_speculation(seq):
                        # rollback released tail blocks: rewind the table
                        st.tables[r] = 0
                        st.tables[r, :len(seq.block_ids)] = seq.block_ids
                        st.tables_dirty = True
                rid = seq.req.rid
                got = st.out[rid] + [int(t) for t in toks]
                keep = smp.match_stop_host(got, seq.req.eos_id,
                                           seq.req.stop, seq.max_tokens)
                new = got[len(st.out[rid]):keep]
                st.emit(rid, new, now, keep is not None)
                if keep is not None:
                    st.stopped_early += keep < seq.max_tokens
                    self._finish_row(st, sched, seq)


def _held(cache: collections.OrderedDict, key):
    """The engine-held state of geometry `key`, made the newest, or
    None."""
    if key in cache:
        cache.move_to_end(key)
    return cache.get(key)


def _hold(cache: collections.OrderedDict, key, value) -> None:
    """Hold `value` for geometry `key`, letting go of the oldest geometry
    beyond `_HELD_GEOMETRIES` (its tensors and graphs are freed)."""
    cache[key] = value
    while len(cache) > _HELD_GEOMETRIES:
        cache.popitem(last=False)


class _ServeSlot:
    """A serve geometry's device state, held by the engine across calls:
    the KV pool, the static inputs every step graph of the geometry reads
    (block tables, `prev`, the `recent` ring, stop sequences) and those
    graphs, keyed by step kind and shape."""

    def __init__(self, cfg, cap, mb, num_blocks, bs, n_stops, stop_len,
                 device):
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        self.pool = kvblocks.init_paged_cache(cfg, num_blocks, bs, device)
        self.tables = zeros(cap, mb)
        self.prev = zeros(cap, 1)
        self.recent = zeros(cap, stop_len)
        self.stops = zeros(cap, n_stops, stop_len)
        self.graphs: dict = {}

    def reset(self) -> None:
        """What `kvblocks.init_paged_cache` and a fresh call hold: a zero
        pool with unit int8 scale planes, zero tables, tokens and ring, no
        stop sequence."""
        for name, leaf in self.pool.items():
            leaf.fill_(1 if name in ("ks", "vs") else 0)
        for t in (self.tables, self.prev, self.recent):
            t.zero_()
        self.stops.fill_(-1)


class _ServeState:
    """One serve call's mutable state: the request table, outputs and
    their timestamps, the host block tables (and whether the slot's
    device copy is stale), the engine-held slot, and the counters."""

    def __init__(self, reqs, tables, slot, on_token):
        n = len(reqs)
        self.reqs = reqs
        self.tables = tables
        self.tables_dirty = True
        self.stops_dirty = True
        self.slot = slot
        self.on_token = on_token
        self.out: list[list[int]] = [[] for _ in range(n)]
        self.first_t = [None] * n
        self.finish_t = [0.0] * n
        self.queue_t = [0.0] * n
        self.steps = self.prefill_chunks = self.prefill_tokens = 0
        self.mixed_steps = self.drafted = self.accepted = 0
        self.spec_rounds = self.stopped_early = 0
        self.t0 = time.perf_counter()

    def emit(self, rid: int, toks, now: float, stop: bool) -> bool:
        """Credit `toks` to request `rid` at time `now` and stream them to
        `on_token`; returns whether the request is now finished
        (max_tokens reached, or `stop`: its stop criterion fired)."""
        out = self.out[rid]
        start = len(out)
        out.extend(toks)
        if self.first_t[rid] is None:
            self.first_t[rid] = now
        done = stop or len(out) >= self.reqs[rid].max_tokens
        if done:
            self.finish_t[rid] = now
        if self.on_token is not None:
            for j in range(start, len(out)):
                self.on_token(TokenEvent(rid=rid, token=out[j], index=j,
                                         time=now,
                                         final=done and j == len(out) - 1))
        return done
