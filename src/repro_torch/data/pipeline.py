"""Deterministic synthetic token streams and a prefetcher (port of
`repro.data.pipeline`, less the mesh placement, which comes with data
parallelism).

`hash_batch` draws uniform tokens from jax's threefry, bit for bit
(`runtime.prng`), deterministic in (seed, step). `MarkovTask` draws
tokens from a seeded sparse Markov chain, a task a model can learn (its
best loss is `entropy_floor`, far below uniform), and `LatentMarkovTask`
one whose transitions factor through a few latent classes, so the optimal
predictor has low rank. Both are numpy on the host, copied so that their
tokens equal the reference's element for element. Batches are dicts of
`torch.int32` tensors {"tokens", "labels"} (B, S), on the CPU unless a
device is given. `lift_to_embeddings` is the frontend stub, and
`Prefetcher` makes batches ahead on a thread.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.runtime import prng


def hash_batch(seed: int, step: int, batch: int, seq: int, vocab: int, *,
               device=None) -> dict:
    """Deterministic uniform tokens for (seed, step): jax.random.randint
    under fold_in(fold_in(PRNGKey(seed), step), 0xDA7A)."""
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), step), 0xDA7A)
    toks = prng.randint(key, (batch, seq + 1), 0, vocab)
    return {"tokens": toks[:, :-1].contiguous().to(device),
            "labels": toks[:, 1:].contiguous().to(device)}


class MarkovTask:
    """Seeded sparse Markov chain over `vocab` states (numpy, host-side)."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        logits = rng.standard_normal((vocab, branching))
        e = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs = e / e.sum(-1, keepdims=True)

    def batch(self, step: int, batch: int, seq: int, *, device=None) -> dict:
        """{"tokens", "labels"}: (batch, seq) int32 each on `device` (the
        CPU by default), the labels the tokens shifted by one. The same
        (step, batch, seq) gives the same batch in every process: Python
        hashes a tuple of ints the same way whatever PYTHONHASHSEED is."""
        rng = np.random.default_rng((hash((step, 0xC0FFEE)) & 0x7FFFFFFF))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cur = toks[:, t]
            choice = (rng.random(batch)[:, None] >
                      np.cumsum(self.probs[cur], -1)).sum(-1)
            choice = np.minimum(choice, self.probs.shape[1] - 1)
            toks[:, t + 1] = self.succ[cur, choice]
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}

    def entropy_floor(self) -> float:
        """Mean conditional entropy (nats): the best achievable loss."""
        p = self.probs
        return float(-(p * np.log(p)).sum(-1).mean())


class LatentMarkovTask(MarkovTask):
    """Markov chain whose successor distribution depends only on the
    token's class, one of `classes` latent classes: the optimal predictor
    has rank about `classes`, as trained language models have decaying
    weight spectra."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4,
                 classes: int = 16):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.classes = classes
        cls_succ = rng.integers(0, classes, size=(classes, branching))
        logits = rng.standard_normal((classes, branching))
        e = np.exp(logits - logits.max(-1, keepdims=True))
        cls_probs = e / e.sum(-1, keepdims=True)
        # per-token successor: a fixed representative of the target class
        reps = rng.integers(0, vocab // classes, size=(classes, branching))
        tok_cls = np.arange(vocab) % classes
        self.succ = np.empty((vocab, branching), np.int64)
        self.probs = np.empty((vocab, branching))
        for t in range(vocab):
            c = tok_cls[t]
            self.succ[t] = cls_succ[c] + classes * reps[c]
            self.probs[t] = cls_probs[c]
        self.succ = np.clip(self.succ, 0, vocab - 1)


def lift_to_embeddings(batch: dict, table: torch.Tensor) -> dict:
    """Frontend stub: replace int tokens with rows of `table` (V, D)."""
    return {"inputs_embeds": table[batch["tokens"].long()],
            "labels": batch["labels"]}


class Prefetcher:
    """Background-thread prefetch of `make(step)` batches, from
    `start_step` on, at most `depth` ahead. Iterating yields (step,
    batch); `close` stops the thread."""

    def __init__(self, make, start_step: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            s = start_step
            while not self._stop.is_set():
                try:
                    self._q.put((s, make(s)), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration

    def close(self):
        self._stop.set()
