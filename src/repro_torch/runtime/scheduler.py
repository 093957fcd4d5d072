"""Continuous-batching request scheduler (bookkeeping only, no compute),
copied from `repro.runtime.scheduler` (the port imports nothing of the
reference).

Production serving never sees rectangular batches: requests arrive at
arbitrary times with arbitrary prompt/output lengths. The standard answer
(TensorRT-LLM "inflight batching" with chunked prefill, vLLM) is a shared
batch that gains a row the moment a request is admitted and loses it the
moment the request finishes — and whose every step mixes prefill *chunks*
of newly admitted prompts with in-flight decode tokens under one token
budget, so admissions never stall the batch. This module is the policy
half of that loop:

  * `Request`  — what a caller submits: prompt tokens + max_tokens (per
    request; a mixed workload is the whole point);
  * `Sequence` — a request bound to a batch row and a set of KV blocks,
    tracking how much of its prompt has been chunk-prefilled;
  * `Scheduler` — FCFS waiting queue + admission + eviction, plus
    `schedule(token_budget)`: the per-step work plan (`ScheduleOutput`)
    naming which rows get a prefill chunk and which a decode token. A
    request is admitted when a batch row is free AND the `BlockPool` can
    reserve its *worst-case* block count up front (prompt + every
    generated token), so a running sequence can never be starved of cache
    mid-decode and overflow queues instead of crashing.

Admission is strictly FCFS: if the head request does not fit, later ones
do not jump it (no starvation of long prompts); within a step, decode
rows claim budget first (they always advance), then prefilling rows
receive chunks oldest-first. The compute half — the unified token-budget
step — lives in `api.InferenceEngine.serve`, which drives this object
step by step; `runtime.kvblocks` owns the cache layout. The scheduler
itself touches no device tensors, which is what makes it unit-testable under
random admit/evict sequences (see tests/test_scheduler.py).

Two relaxations of plain FCFS-with-worst-case-reservation:

  * Prefix caching (`prefix_cache=True`): admission digests the prompt's
    full blocks (`kvblocks.prefix_digests`), walks the pool's content
    index for the longest cached position-aligned prefix, maps those
    blocks into the block table *by reference* (refcount++), charges the
    pool only for the new blocks, and starts chunked prefill at the
    first uncached position. A prompt whose every block is cached still
    needs the logits of its last position, so its final block is
    copy-on-write: share all but the last matched block, allocate a
    private `cow_dst`, and have the engine device-copy `cow_src`→
    `cow_dst` before the next dispatch (prefill then recomputes exactly
    position prompt_len-1 — bit-identical K/V, private block). Completed
    full prompt blocks are registered back into the index by
    `advance_prefill` as chunked prefill crosses each block boundary.
    Shared blocks are always the leading `n_shared` table entries and
    writes only ever target positions >= prefilled >= n_shared*bs, so
    no sequence -- speculative rollback included -- can touch a block
    another sequence holds.

  * Pool-pressure preemption: when the head request cannot be admitted
    even though a row is free (the pool cannot give enough blocks after
    evicting every refcount-0 cached block), the scheduler preempts the
    newest zero-output sequence(s) (policy: `runtime.elastic`), frees
    their blocks, admits the head, and requeues each victim's request
    immediately behind it. Victims are only taken when the arithmetic
    proves the head then fits, and a request yields at most once, so
    preemption always makes forward progress.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.runtime import elastic
from repro_torch.runtime.kvblocks import (BlockPool, blocks_for_positions,
                                          blocks_needed, prefix_digests)


@dataclasses.dataclass
class Request:
    """One generation request. max_tokens=None defers to the engine-level
    SamplingParams; rid is assigned by the engine (submission order).
    `requeued` is set by pool-pressure preemption — a request yields its
    blocks at most once.

    Per-request sampling / stop controls are plain fields, None meaning
    "defer to the engine-level SamplingParams"; `engine.serve` resolves
    every field to a concrete value before `submit`. temperature <= 0 is
    greedy; `stop` is a tuple of token-id tuples matched inclusively
    (the matching tokens stay in the output)."""

    tokens: np.ndarray
    max_tokens: int | None = None
    rid: int | None = None
    requeued: bool = False
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    seed: int | None = None
    eos_id: int | None = None
    stop: tuple = ()

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.tokens.size == 0:
            raise ValueError("empty prompt")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.top_k is not None and self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.eos_id is not None and self.eos_id < 0:
            raise ValueError(f"eos_id must be >= 0, got {self.eos_id}")
        self.stop = tuple(tuple(int(t) for t in s) for s in self.stop)
        if any(len(s) == 0 for s in self.stop):
            raise ValueError("empty stop sequence")


@dataclasses.dataclass
class Sequence:
    """A live request: bound to batch row `row`, owning `block_ids`.
    `prefilled` counts prompt tokens already written to the KV pool by
    chunked prefill; the row decodes once the whole prompt is in.
    `n_emitted` counts output tokens the engine has *dispatched* for this
    row — a count, not values: with per-request max_tokens and no early
    stopping, scheduling never depends on what the tokens turn out to
    be, which is what lets the engine pipeline steps without waiting for
    device results."""

    req: Request
    row: int
    block_ids: list[int]
    prefilled: int = 0
    n_emitted: int = 0
    # --- prefix-cache bookkeeping (all zero/empty with the cache off) ---
    # leading block_ids entries mapped by reference from the content
    # index; this row never writes them (its writes start at position
    # prefilled >= n_shared * block_size)
    n_shared: int = 0
    # chained digests of the prompt's full blocks (kvblocks.prefix_digests)
    digests: list[bytes] = dataclasses.field(default_factory=list)
    # pending copy-on-write: the engine device-copies cow_src -> cow_dst
    # before the next dispatch, then releases the cow_src pin. Set only
    # for fully-cached prompts (the last matched block must be rewritten
    # privately so its final position's logits can be recomputed).
    cow_src: int | None = None
    cow_dst: int | None = None
    # next full prompt-block index advance_prefill may register
    reg_next: int = 0
    # KV blocks provisionally allocated for a speculative draft span
    # beyond the row's committed holdings (tail of block_ids, position
    # order). Rolled back by commit_speculation after verify; empty
    # whenever admission reserved the worst case up front.
    draft_blocks: list[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.req.tokens.size)

    @property
    def max_tokens(self) -> int:
        return int(self.req.max_tokens)

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prompt_len

    @property
    def done(self) -> bool:
        return self.n_emitted >= self.max_tokens

    @property
    def sampled(self) -> bool:
        """True when this row decodes with temperature > 0. Sampled rows
        never draft: greedy speculative acceptance verifies an argmax
        chain."""
        t = self.req.temperature
        return t is not None and t > 0.0


@dataclasses.dataclass
class ScheduleOutput:
    """One step's work plan under the token budget: which rows run a
    prefill chunk (and how wide), which rows decode one token, and what
    was newly admitted this step (rows whose block tables the engine
    must install before the forward pass)."""

    admitted: list[Sequence]
    prefill: dict[int, int]       # row -> prompt-chunk width this step
    decode: list[int]             # rows advancing by one decode token
    # rows whose sequence was preempted under pool pressure this step —
    # the engine must reset their block tables to trash before the next
    # dispatch (then install any admitted sequence that reuses the row)
    preempted: list[int] = dataclasses.field(default_factory=list)
    # row -> draft tokens to speculate this step (subset of decode rows;
    # the row's verify span is 1 + spec[row] wide). Empty when
    # speculation is off or no budget was left for it.
    spec: dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def total_tokens(self) -> int:
        return (sum(self.prefill.values()) + len(self.decode)
                + sum(self.spec.values()))

    @property
    def max_span(self) -> int:
        """Widest per-row span this step (the forward pass's W)."""
        d = 0
        if self.decode:
            d = 1 + max((self.spec.get(r, 0) for r in self.decode),
                        default=0)
        return max(max(self.prefill.values(), default=0), d)

    @property
    def is_mixed(self) -> bool:
        return bool(self.prefill) and bool(self.decode)


class Scheduler:
    """FCFS admission over `max_batch` batch rows and a `BlockPool`,
    optionally with prefix-cache sharing and pool-pressure preemption."""

    def __init__(self, pool: BlockPool, max_batch: int, *,
                 prefix_cache: bool = False, fingerprint: bytes = b"",
                 preempt: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.pool = pool
        self.max_batch = max_batch
        self.prefix_cache = prefix_cache
        self.fingerprint = fingerprint
        self.preempt_under_pressure = preempt
        self.waiting: collections.deque[Request] = collections.deque()
        self.rows: list[Sequence | None] = [None] * max_batch
        self.max_queue_depth = 0
        # prefix-cache / preemption counters (ServeResult surfaces these)
        self.cache_lookup_blocks = 0
        self.cache_hit_blocks = 0
        self.cache_hit_tokens = 0
        self.cache_cow_blocks = 0
        self.preemptions = 0

    # ------------------------------------------------------------ submit --
    def submit(self, req: Request) -> None:
        """Queue a request. Raises if it can never fit the pool (worst-case
        block need exceeds total capacity) — that is a config error, not a
        load condition."""
        if req.max_tokens is None:
            raise ValueError(
                "request max_tokens is unresolved (None); fill it in before "
                "submitting — engine.serve resolves it from SamplingParams")
        need = blocks_needed(req.tokens.size, req.max_tokens,
                             self.pool.block_size)
        if need > self.pool.capacity:
            raise ValueError(
                f"request rid={req.rid} needs {need} KV blocks but the pool "
                f"only has {self.pool.capacity}; raise num_blocks or "
                f"block_size")
        self.waiting.append(req)
        self.max_queue_depth = max(self.max_queue_depth, len(self.waiting))

    # --------------------------------------------------------- admission --
    def _free_row(self) -> int | None:
        for i, s in enumerate(self.rows):
            if s is None:
                return i
        return None

    def _request_digests(self, req: Request) -> list[bytes]:
        """Chained full-block digests of a prompt, memoized on the
        request (a preempted request keeps its digests across requeue)."""
        if not self.prefix_cache:
            return []
        cached = getattr(req, "_prefix_digests", None)
        if cached is None:
            cached = prefix_digests(req.tokens, self.pool.block_size,
                                    self.fingerprint)
            req._prefix_digests = cached
        return cached

    def _match_prefix(self, req: Request):
        """(digests, n_hit, cow): longest cached position-aligned prefix
        of `req`'s full blocks, and whether admission must copy-on-write
        (every block cached — the final block is shared as a COW source,
        not mapped, so position prompt_len-1 can be recomputed for its
        logits into a private copy)."""
        digests = self._request_digests(req)
        n_hit = 0
        for d in digests:
            if self.pool.lookup(d) is None:
                break
            n_hit += 1
        cow = n_hit > 0 and n_hit * self.pool.block_size >= req.tokens.size
        return digests, n_hit, cow

    def try_admit(self) -> Sequence | None:
        """Admit the head-of-queue request if a row is free and its block
        budget is available; None when nothing is admissible now. With
        prefix caching on, cached full prompt blocks are mapped by
        reference and only the remaining blocks are charged to the
        pool."""
        if not self.waiting:
            return None
        row = self._free_row()
        if row is None:
            return None
        req = self.waiting[0]
        need = blocks_needed(req.tokens.size, req.max_tokens,
                             self.pool.block_size)
        digests, n_hit, cow = self._match_prefix(req)
        n_share = n_hit - 1 if cow else n_hit
        # Pin the matched blocks first: a share revives idle cached
        # blocks, so the availability check below no longer counts them.
        shared = [self.pool.share(d) for d in digests[:n_share]]
        cow_src = self.pool.share(digests[n_hit - 1]) if cow else None
        new_need = need - n_share
        if not self.pool.can_alloc(new_need):
            self.pool.free(shared)              # unwind; head stays queued
            if cow_src is not None:
                self.pool.free([cow_src])
            return None
        self.waiting.popleft()
        new_ids = self.pool.alloc(new_need)
        bs = self.pool.block_size
        seq = Sequence(
            req=req, row=row, block_ids=shared + new_ids,
            prefilled=req.tokens.size - 1 if cow else n_share * bs,
            n_shared=n_share, digests=digests,
            cow_src=cow_src, cow_dst=new_ids[0] if cow else None,
            reg_next=n_hit)
        self.rows[row] = seq
        self.cache_lookup_blocks += min(n_hit + 1, len(digests))
        self.cache_hit_blocks += n_hit
        self.cache_hit_tokens += seq.prefilled
        self.cache_cow_blocks += int(cow)
        return seq

    def advance_prefill(self, seq: Sequence, width: int) -> None:
        """Record `width` more prompt tokens written to the pool, and
        register each newly completed full prompt block into the content
        index (first writer wins; blocks this row itself mapped from the
        cache are skipped via `reg_next`). The engine calls this exactly
        when it dispatches the row's prefill chunk — device-stream order
        then guarantees any later admission reading the block runs after
        the write."""
        seq.prefilled += width
        if not self.prefix_cache:
            return
        bs = self.pool.block_size
        n_full = min(len(seq.digests), seq.prompt_len // bs)
        while (seq.reg_next < n_full
               and (seq.reg_next + 1) * bs <= seq.prefilled):
            self.pool.register(seq.block_ids[seq.reg_next],
                               seq.digests[seq.reg_next])
            seq.reg_next += 1

    def release_cow(self, seq: Sequence) -> None:
        """Drop the copy-on-write source pin once the engine has
        dispatched the device copy into `seq.cow_dst`."""
        if seq.cow_src is not None:
            self.pool.free([seq.cow_src])
            seq.cow_src = None

    # ---------------------------------------------------------- schedule --
    def schedule(self, token_budget: int, spec_k: int = 0) -> ScheduleOutput:
        """Plan one unified step: admit FCFS, then split `token_budget`
        tokens across the active rows. Decode rows (prompt fully in the
        pool, request unfinished) always advance — one token each, even
        when prefill chunks run in the same step — then the remaining
        budget is dealt to prefilling rows as prompt chunks of at most
        ceil(budget / #prefilling) tokens each, oldest-first. The
        balanced cap matters because the forward pass is a rectangular
        (rows, max_span) batch: one row hogging the budget widens every
        other row's padding, while even chunks keep the span — and the
        step's compute — near the useful-token count. Budget a
        short-remaining row leaves unused simply idles this step; the
        next step re-budgets from scratch.

        spec_k > 0 offers each greedy decode row up to spec_k speculative
        draft tokens out of whatever budget prefill chunks left over, so
        speculation ramps up when the batch turns decode-bound. Per-row
        grants are clamped by `reserve_speculation` (never past the
        request's final token, never past the block pool)."""
        if token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        admitted = []
        while (seq := self.try_admit()) is not None:
            admitted.append(seq)
        preempted_rows: list[int] = []
        if (self.preempt_under_pressure and not admitted and self.waiting
                and self._free_row() is not None):
            preempted_rows = self._preempt_for_head()
            if preempted_rows:
                while (seq := self.try_admit()) is not None:
                    admitted.append(seq)
        live = [s for s in self.rows if s is not None]
        decoding = [s for s in live if s.prefill_done and not s.done]
        decode = [s.row for s in decoding]
        budget = max(0, token_budget - len(decode))
        prefill: dict[int, int] = {}
        filling = sorted((s for s in live if not s.prefill_done),
                         key=lambda s: (s.req.rid is None, s.req.rid, s.row))
        if filling and budget > 0:
            cap = -(-budget // len(filling))
            for seq in filling:
                chunk = min(seq.prompt_len - seq.prefilled, cap, budget)
                if chunk > 0:
                    prefill[seq.row] = chunk
                    budget -= chunk
        spec: dict[int, int] = {}
        if spec_k > 0:
            for seq in decoding:
                if budget <= 0:
                    break
                if seq.sampled:
                    continue
                kr = self.reserve_speculation(seq, min(spec_k, budget))
                if kr > 0:
                    spec[seq.row] = kr
                    budget -= kr
        return ScheduleOutput(admitted=admitted, prefill=prefill,
                              decode=decode, spec=spec,
                              preempted=preempted_rows)

    # --------------------------------------------------------- preemption --
    def _preempt_for_head(self) -> list[int]:
        """Preempt the fewest newest zero-output sequences whose freed
        blocks provably let the head request admit; [] (and no side
        effects) when no victim set suffices. Victim policy lives in
        runtime.elastic; freeing victims only grows the cache, so the
        head's block need computed here can only shrink by admission
        time — the fit check is conservative."""
        req = self.waiting[0]
        need = blocks_needed(req.tokens.size, req.max_tokens,
                             self.pool.block_size)
        _, n_hit, cow = self._match_prefix(req)
        need_new = need - (n_hit - 1 if cow else n_hit)
        if self.pool.can_alloc(need_new):
            return []                # head admissible; nothing to preempt
        gain = 0
        chosen = []
        for victim in elastic.preemption_victims(self.rows):
            gain += elastic.reclaimable_blocks(self.pool, victim)
            chosen.append(victim)
            if self.pool.available + gain >= need_new:
                break
        else:
            return []          # even preempting every candidate won't fit
        rows = []
        for victim in chosen:
            self.preempt(victim)
            rows.append(victim.row)
        return rows

    def preempt(self, seq: Sequence) -> None:
        """Evict a zero-output sequence mid-prefill: free its blocks (and
        COW pin), clear its row, and requeue its request just behind the
        current queue head (the request it yields to). Its registered
        prompt blocks stay in the content index as idle cached blocks, so
        re-admission typically resumes from the last registered block
        rather than from scratch."""
        if seq.n_emitted:
            raise ValueError(
                f"cannot preempt rid={seq.req.rid}: it has emitted "
                f"{seq.n_emitted} tokens (only zero-output rows preempt)")
        if seq.cow_src is not None:
            self.pool.free([seq.cow_src])
            seq.cow_src = None
        self.pool.free(seq.block_ids)
        seq.block_ids = []
        self.rows[seq.row] = None
        seq.req.requeued = True
        self.waiting.insert(min(1, len(self.waiting)), seq.req)
        self.max_queue_depth = max(self.max_queue_depth, len(self.waiting))
        self.preemptions += 1

    # ------------------------------------------------------- speculation --
    def reserve_speculation(self, seq: Sequence, k: int) -> int:
        """Clamp a draft offer to what the row can legally speculate and
        provisionally allocate the KV blocks the draft span needs beyond
        the row's holdings. `k <= remaining - 1` keeps the (k+1)-wide
        verify span inside the admission-time reservation and the block
        table's width. Returns the granted k (shrunk to what the pool can
        back); new blocks go to `seq.draft_blocks`, the rollback mark of
        `commit_speculation`."""
        k = max(0, min(int(k), seq.max_tokens - seq.n_emitted - 1))
        while k > 0:
            # last pool position the verify span writes: it covers
            # [C, C + k] and caches all but its newest token
            end = seq.prompt_len + seq.n_emitted - 1 + k
            need = (blocks_for_positions(end + 1, self.pool.block_size)
                    - len(seq.block_ids))
            if need <= 0:
                return k
            if self.pool.can_alloc(need):
                got = self.pool.alloc(need)
                seq.block_ids.extend(got)
                seq.draft_blocks.extend(got)
                return k
            k -= 1          # shrink the draft until the pool can back it
        return 0

    def commit_speculation(self, seq: Sequence) -> list[int]:
        """Rollback after a verify, with `seq.n_emitted` already advanced
        by the accepted tokens: free every provisional draft block the
        committed context does not reach (never below the row's pre-draft
        holdings, never the trash block 0). Returns the released ids.
        Rejected positions need no data rewind: reads mask to
        `slot <= position`, and the next span overwrites them."""
        if not seq.draft_blocks:
            return []
        base = len(seq.block_ids) - len(seq.draft_blocks)
        committed = max(seq.prompt_len + seq.n_emitted - 1, 0)
        keep = max(blocks_for_positions(committed, self.pool.block_size),
                   base)
        released = seq.block_ids[keep:]
        seq.block_ids = seq.block_ids[:keep]
        seq.draft_blocks = []
        self.pool.free(released)
        return released

    # ---------------------------------------------------------- eviction --
    def finish(self, seq: Sequence) -> None:
        """Retire a sequence: release its blocks (refcount decrement —
        shared prefix blocks stay resident for their other holders, and
        this row's registered blocks go idle-cached) and free its row."""
        if seq.cow_src is not None:        # finished before the COW copy
            self.pool.free([seq.cow_src])  # was dispatched (engine bug
            seq.cow_src = None             # guard; normally released)
        self.pool.free(seq.block_ids)
        seq.block_ids = []
        self.rows[seq.row] = None

    # ------------------------------------------------------------- state --
    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.rows)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0
