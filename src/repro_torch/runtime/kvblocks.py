"""Blocked (paged) KV-cache pool (port of `repro.runtime.kvblocks`).

Host half, copied from the reference: the refcounting `BlockPool`
allocator (block 0 is the reserved trash block that inactive rows write
and nothing reads), chained prefix digests for prefix caching, and the
block-count helpers. Device half, in torch: the per-layer pool tensors
`(L, num_blocks, block_size, Hk, Dh)` (plus per-(token, head) fp32 scale
planes for int8 KV), the copy-on-write block copy, and the index math
that maps a batch of token spans to physical (block, offset) slots.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch


def check_paged_support(cfg) -> None:
    """Raise when `cfg` cannot decode through the blocked KV pool."""
    if cfg.layout not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged KV decode supports dense/moe layouts, not {cfg.layout!r}"
            " (SSM/hybrid decode state is O(1) per row and is not paged)")
    if cfg.local_global_period or cfg.attn_window:
        raise NotImplementedError(
            "paged KV decode does not support windowed or local/global "
            "attention yet — their rolling caches are already O(window)")


def blocks_needed(prompt_len: int, max_tokens: int, block_size: int) -> int:
    """Blocks a request occupies at peak. Chunked prefill writes every
    prompt position into the pool, and decode caches every generated
    token except the last (which is returned, never attended), so the
    footprint is prompt_len + max_tokens - 1 positions."""
    return -(-(prompt_len + max(max_tokens, 1) - 1) // block_size)


def blocks_for_positions(n_positions: int, block_size: int) -> int:
    """Block-table entries covering the first `n_positions` pool slots."""
    return -(-max(n_positions, 0) // block_size)


class BlockPool:
    """Host-side refcounting allocator over `num_blocks` KV blocks.

    Block 0 is reserved (the trash block for inactive rows) and is never
    handed out, so `capacity == num_blocks - 1`. Freeing a block nobody
    holds is a hard error — the scheduler tests lean on this to prove
    admit/evict sequences never leak.

    Prefix caching layers three states on top of the plain free list:

      free      — on `_free`, content unknown, refcount 0;
      live      — refcount >= 1 holder (one owner, or owner + sharers);
      idle      — refcount 0 but *registered* under a content digest.
                  Idle blocks sit in an LRU (`_idle`), still answer
                  `lookup`/`share`, still count as `available`, and are
                  evicted oldest-first only when `alloc` drains the free
                  list.

    With no `register` calls the pool degenerates to a plain free-list
    allocator: every alloc returns refcount-1 blocks and every free
    returns them straight to the free list.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is reserved), got "
                             f"{num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}          # block -> refcount >= 1
        self._index: dict[bytes, int] = {}      # digest -> block
        self._digest: dict[int, bytes] = {}     # block -> digest
        self._idle: OrderedDict[int, None] = OrderedDict()  # LRU, old first
        self.evictions = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        """Blocks an alloc can claim right now: free + evictable idle."""
        return len(self._free) + len(self._idle)

    @property
    def cached_blocks(self) -> int:
        """Blocks currently indexed by digest (live sharers + idle)."""
        return len(self._index)

    @property
    def idle_cached_blocks(self) -> int:
        return len(self._idle)

    def can_alloc(self, n: int) -> bool:
        return n <= self.available

    def alloc(self, n: int) -> list[int]:
        if not self.can_alloc(n):
            raise RuntimeError(
                f"block pool exhausted: want {n}, have {self.available} "
                f"(callers must check can_alloc and queue instead)")
        ids = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:  # evict the least-recently-idle cached block
                b, _ = self._idle.popitem(last=False)
                del self._index[self._digest.pop(b)]
                self.evictions += 1
            self._ref[b] = 1
            ids.append(b)
        return ids

    def free(self, ids) -> None:
        """Drop one reference per listed block. The last holder's free
        parks registered blocks in the idle LRU (newest end) and returns
        unregistered ones to the free list."""
        for b in ids:
            if self._ref.get(b, 0) < 1:
                raise RuntimeError(f"double free / foreign block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._digest:
                    self._idle[b] = None
                else:
                    self._free.append(b)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    def register(self, block_id: int, digest: bytes) -> bool:
        """Index a fully-written, currently-held block under its content
        digest. First writer wins: if the digest is already indexed (or
        the block already registered) this is a no-op returning False —
        the duplicate block simply stays private. Trash block 0 can never
        get here because it is never handed out by `alloc`."""
        if self._ref.get(block_id, 0) < 1:
            raise RuntimeError(
                f"register of unheld block {block_id} (only live blocks "
                f"can be indexed)")
        if digest in self._index or block_id in self._digest:
            return False
        self._index[digest] = block_id
        self._digest[block_id] = digest
        return True

    def lookup(self, digest: bytes):
        """Block currently indexed under `digest`, or None. Does not take
        a reference — pair with `share` before relying on the block."""
        return self._index.get(digest)

    def share(self, digest: bytes):
        """Take one reference on the block cached under `digest`,
        reviving it from the idle LRU if nobody holds it. None on miss."""
        b = self._index.get(digest)
        if b is None:
            return None
        if b in self._idle:
            del self._idle[b]
        self._ref[b] = self._ref.get(b, 0) + 1
        return b


def prefix_digests(tokens, block_size: int, fingerprint: bytes = b"") \
        -> list[bytes]:
    """Chained content digests for every FULL block of a token prefix.

    digest[i] commits to (fingerprint, block_size, tokens[0 : (i+1)*bs]):
    the chain folds each block's token ids into the previous digest, so
    equal digests mean equal position-aligned prefixes under the same
    model/plan fingerprint. Partial tail blocks get no digest — they are
    never shared. Host-side only (SHA-256 over int64 token bytes)."""
    toks = np.asarray(tokens, dtype=np.int64)
    if toks.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {toks.shape}")
    prev = hashlib.sha256(
        b"kvprefix:%d:" % block_size + fingerprint).digest()
    out = []
    for i in range(toks.size // block_size):
        blk = toks[i * block_size:(i + 1) * block_size]
        prev = hashlib.sha256(prev + blk.astype("<i8").tobytes()).digest()
        out.append(prev)
    return out


def copy_block(pool, src: int, dst: int) -> None:
    """Copy-on-write primitive: duplicate physical block `src` into `dst`
    across every pool leaf, in place (the pool is updated in place
    throughout the port; stream order keeps earlier readers safe)."""
    for leaf in pool.values():
        leaf[:, dst] = leaf[:, src]


def init_paged_cache(cfg, num_blocks: int, block_size: int, device,
                     dtype=None):
    """Physical pool tensors for every layer: {"k","v"} of shape
    (L, num_blocks, block_size, Hk, Dh) in the model's dtype (bfloat16
    for a bfloat16 model) at kv_cache_bits 16, or int8 codes plus
    {"ks","vs"} fp32 scale planes (L, num_blocks, block_size, Hk, 1) when
    cfg.kv_cache_bits == 8 (scales initialised to 1 as in the
    reference)."""
    from repro_torch.models.layers import dtype_of

    check_paged_support(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    L, hk, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shape = (L, num_blocks, block_size, hk, hd)
    if cfg.kv_cache_bits == 8:
        sshape = (L, num_blocks, block_size, hk, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.ones(sshape, dtype=torch.float32, device=device),
                "vs": torch.ones(sshape, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def shard_pool(pool, tp: int, shard: int) -> dict:
    """The head slice of `pool` that rank `shard` of `tp` holds: every
    leaf -- the (L, NB, bs, Hk, Dh) codes and the int8 (L, NB, bs, Hk, 1)
    scale planes -- sliced on its KV-head axis 3. Pure slicing, what the
    tests hold a rank's pool to: a rank allocates its own slice directly
    (`init_paged_cache` with the per-rank config), and int8 KV
    quantization is per (token, head), so rank r's codes and scales equal
    heads [r*Hk/tp, (r+1)*Hk/tp) of the single-device pool. Block tables,
    step buffers and the scheduler's state are the same on every rank."""
    if not 0 <= shard < tp:
        raise ValueError(f"shard {shard} out of range for tp={tp}")
    out = {}
    for key, leaf in pool.items():
        hk = leaf.shape[3]
        if hk % tp:
            raise ValueError(
                f"pool leaf {key!r} has {hk} KV heads, not divisible by "
                f"tp={tp}")
        n = hk // tp
        out[key] = leaf[:, :, :, shard * n:(shard + 1) * n]
    return out


def valid_block_counts(ctx_lens, q_lens, block_size: int, max_blocks: int):
    """Per-row count of block-table entries holding valid context this
    step, ceil((ctx + q) / block_size), 0 for idle rows (q_lens == 0),
    clamped to the table width: the blocks the paged-attention kernel
    walks (it computes the same count itself)."""
    nb = (ctx_lens + q_lens + block_size - 1) // block_size
    nb = torch.where(q_lens > 0, nb, torch.zeros_like(nb))
    return torch.clamp(nb, 0, max_blocks).to(torch.int32)


def span_slots(block_table, ctx_lens, q_lens, width: int, block_size: int):
    """Physical scatter targets (blk, off), each (B, width) int64, for a
    batch of per-row token spans: span slot (r, i) is position
    ctx_lens[r] + i. Slots past a row's q_lens, and idle rows, go to the
    trash block 0, so the full (B, width) rectangle scatters with no
    control flow."""
    ar = torch.arange(width, device=block_table.device)
    pos = ctx_lens.long()[:, None] + ar[None, :]
    valid = ar[None, :] < q_lens.long()[:, None]
    mb = block_table.shape[1]
    bidx = torch.clamp(pos // block_size, max=mb - 1)
    blk = torch.where(valid, torch.gather(block_table.long(), 1, bidx),
                      torch.zeros_like(bidx))
    off = torch.where(valid, pos % block_size, torch.zeros_like(pos))
    return blk, off
