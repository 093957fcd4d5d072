"""Sensitivity-based Rank Allocation (paper §IV), a copy of
`repro.core.sra`.

Generic over the model: the caller supplies `eval_fn(ranks) -> accuracy`
(higher is better) and the per-layer maximum ranks. The algorithm:

  1. split the budget equally,
  2. estimate per-layer sensitivity S_i = ∂A/∂r_i by central finite
     differences with step δ (eq. 8),
  3. move δ ranks from the least- to the most-sensitive layer (eqs. 9–10),
  4. decay δ_n = round(δ0 / (1 + α·n)) (eq. 11),
  5. stop on convergence or max iterations.

Evaluations are memoized: the finite-difference probes revisit nearby
allocations and each probe is a full calibration pass. Pure Python, its
arithmetic token for token the reference's, so both packages allocate
the same ranks from the same evaluations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence


@dataclasses.dataclass
class SRAResult:
    ranks: list[int]
    accuracy: float
    history: list[tuple[list[int], float]]  # (allocation, accuracy) per iter
    evals: int


def _clip_alloc(ranks, max_ranks, min_rank):
    return [min(max(r, min_rank), mx) for r, mx in zip(ranks, max_ranks)]


def sra_allocate(
    eval_fn: Callable[[Sequence[int]], float],
    num_layers: int,
    total_budget: int,
    max_ranks: Sequence[int],
    *,
    min_rank: int = 1,
    delta0: int | None = None,
    alpha: float = 0.15,
    max_iters: int = 40,
    patience: int = 6,
) -> SRAResult:
    """Run SRA. Returns the best allocation seen (not merely the last)."""
    if len(max_ranks) != num_layers:
        raise ValueError("max_ranks must have one entry per layer")
    if total_budget > sum(max_ranks):
        raise ValueError("budget exceeds sum of max ranks")

    # 1) equal split (remainder spread over the first layers), clipped and
    #    re-balanced if clipping changed the total
    base, rem = divmod(total_budget, num_layers)
    ranks = [base + (1 if i < rem else 0) for i in range(num_layers)]
    ranks = _clip_alloc(ranks, max_ranks, min_rank)
    ranks = _rebalance(ranks, total_budget, max_ranks, min_rank)

    if delta0 is None:
        delta0 = max(1, base // 4)

    cache: dict[tuple, float] = {}

    def ev(alloc) -> float:
        key = tuple(alloc)
        if key not in cache:
            cache[key] = float(eval_fn(list(key)))
        return cache[key]

    best_alloc, best_acc = list(ranks), ev(ranks)
    history = [(list(ranks), best_acc)]
    stall = 0

    for n in range(max_iters):
        delta = max(1, round(delta0 / (1.0 + alpha * n)))
        # 2) central finite-difference sensitivities (eq. 8)
        sens = []
        for i in range(num_layers):
            up = list(ranks)
            dn = list(ranks)
            up[i] = min(up[i] + delta, max_ranks[i])
            dn[i] = max(dn[i] - delta, min_rank)
            span = up[i] - dn[i]
            if span == 0:
                sens.append(0.0)
                continue
            sens.append((ev(up) - ev(dn)) / span)

        # 3) move delta ranks from argmin to argmax sensitivity (eqs. 9–10)
        #    within the per-layer bounds
        order_hi = sorted(range(num_layers), key=lambda i: -sens[i])
        order_lo = sorted(range(num_layers), key=lambda i: sens[i])
        i_hi = next((i for i in order_hi if ranks[i] + delta <= max_ranks[i]),
                    None)
        i_lo = next(
            (j for j in order_lo if ranks[j] - delta >= min_rank and j != i_hi),
            None,
        )
        if i_hi is None or i_lo is None:
            break
        ranks[i_hi] += delta
        ranks[i_lo] -= delta

        acc = ev(ranks)
        history.append((list(ranks), acc))
        if acc > best_acc:
            best_acc, best_alloc, stall = acc, list(ranks), 0
        else:
            stall += 1
        # 5) converged: no improvement for `patience` iterations
        if stall >= patience:
            break

    return SRAResult(best_alloc, best_acc, history, evals=len(cache))


def _rebalance(ranks, budget, max_ranks, min_rank):
    """Adjust an allocation so it sums exactly to the budget within bounds."""
    ranks = list(ranks)
    diff = budget - sum(ranks)
    i = 0
    guard = 0
    while diff != 0 and guard < 10_000:
        j = i % len(ranks)
        if diff > 0 and ranks[j] < max_ranks[j]:
            ranks[j] += 1
            diff -= 1
        elif diff < 0 and ranks[j] > min_rank:
            ranks[j] -= 1
            diff += 1
        i += 1
        guard += 1
    return ranks


def uniform_allocation(num_layers: int, total_budget: int,
                       max_ranks: Sequence[int], min_rank: int = 1) -> list[int]:
    """The paper's SVD-baseline allocation: equal rank everywhere."""
    base, rem = divmod(total_budget, num_layers)
    ranks = [base + (1 if i < rem else 0) for i in range(num_layers)]
    return _rebalance(
        _clip_alloc(ranks, max_ranks, min_rank), total_budget, max_ranks, min_rank
    )
