"""Deterministic synthetic token streams (port of the host half of
`repro.data.pipeline`).

`MarkovTask` draws tokens from a seeded sparse Markov chain, a task a
model can learn (its best loss is `entropy_floor`, far below uniform), and
`LatentMarkovTask` one whose transitions factor through a few latent
classes, so the optimal predictor has low rank. Both are numpy on the
host, copied so that their tokens equal the reference's element for
element; batches come back as CPU `torch.int32` tensors.
"""
from __future__ import annotations

import numpy as np
import torch


class MarkovTask:
    """Seeded sparse Markov chain over `vocab` states (numpy, host-side)."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        logits = rng.standard_normal((vocab, branching))
        e = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs = e / e.sum(-1, keepdims=True)

    def batch(self, step: int, batch: int, seq: int) -> dict:
        """{"tokens", "labels"}: (batch, seq) int32 each, the labels the
        tokens shifted by one. The same (step, batch, seq) gives the same
        batch in every process: Python hashes a tuple of ints the same way
        whatever PYTHONHASHSEED is."""
        rng = np.random.default_rng((hash((step, 0xC0FFEE)) & 0x7FFFFFFF))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cur = toks[:, t]
            choice = (rng.random(batch)[:, None] >
                      np.cumsum(self.probs[cur], -1)).sum(-1)
            choice = np.minimum(choice, self.probs.shape[1] - 1)
            toks[:, t + 1] = self.succ[cur, choice]
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}

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
