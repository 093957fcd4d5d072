"""The port's Sensitivity-based Rank Allocation (`repro_torch.core.sra`)
against the reference's on the evaluation functions of
`tests/test_sra.py`: the same allocation, accuracy, history and number of
evaluations, exactly (both are the same pure-Python arithmetic)."""
import numpy as np
import pytest

from repro.core import sra as jsra
from repro_torch.core import sra as tsra


def _quadratic(opt, weights=None):
    opt = np.asarray(opt)
    wts = np.ones(len(opt)) if weights is None else np.asarray(weights)

    def ev(r):
        return -float(np.sum(wts * (np.array(r) - opt) ** 2))

    return ev


def _budget_case(layers, budget, seed):
    rng = np.random.default_rng(seed)
    opt = rng.integers(1, 32, size=layers)
    max_ranks = [64] * layers
    return (_quadratic(opt), layers, min(budget, sum(max_ranks)), max_ranks,
            dict(max_iters=10))


CASES = {
    # test_budget_conserved, at fixed draws of its hypothesis strategy
    "budget_2_10_0": _budget_case(2, 10, 0),
    "budget_5_37_7": _budget_case(5, 37, 7),
    "budget_8_60_100": _budget_case(8, 60, 100),
    "budget_3_60_42": _budget_case(3, 60, 42),
    # test_beats_uniform_on_heterogeneous
    "heterogeneous": (_quadratic([40, 8, 2, 30], [10.0, 1.0, 0.1, 5.0]), 4,
                      80, [64] * 4, dict(delta0=8, max_iters=60)),
    # test_respects_max_ranks: monotone, wants all rank everywhere
    "max_ranks": (lambda r: float(sum(r)), 3, 20, [8, 8, 8],
                  dict(max_iters=10)),
    # test_delta_decay_converges
    "delta_decay": (_quadratic([30, 10]), 2, 40, [64, 64],
                    dict(delta0=16, alpha=0.3, max_iters=50)),
    # test_memoization_bounds_evals: a flat objective
    "memoization": (lambda r: 0.0, 4, 16, [16] * 4, dict(max_iters=8)),
    # bounds that clip the equal split, a floor above 1, early patience
    "clipped": (_quadratic([3, 50, 20], [1.0, 2.0, 0.5]), 3, 70, [4, 64, 64],
                dict(min_rank=2, patience=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sra_allocate_equals_reference(case):
    ev, layers, budget, max_ranks, kw = CASES[case]
    calls = {"j": [], "t": []}

    def counted(tag):
        def f(r):
            calls[tag].append(tuple(r))
            return ev(r)
        return f

    rj = jsra.sra_allocate(counted("j"), layers, budget, max_ranks, **kw)
    rt = tsra.sra_allocate(counted("t"), layers, budget, max_ranks, **kw)
    assert rt.ranks == rj.ranks
    assert rt.accuracy == rj.accuracy
    assert rt.history == rj.history
    assert rt.evals == rj.evals == len(set(calls["t"]))
    assert calls["t"] == calls["j"]          # the same probes, in order
    assert sum(rt.ranks) == budget


@pytest.mark.parametrize("layers,budget,max_ranks,min_rank", [
    (4, 80, [64] * 4, 1),
    (3, 20, [8, 8, 8], 1),
    (5, 37, [4, 64, 64, 2, 64], 1),
    (3, 70, [4, 64, 64], 2),
])
def test_uniform_allocation_equals_reference(layers, budget, max_ranks,
                                             min_rank):
    got = tsra.uniform_allocation(layers, budget, max_ranks, min_rank)
    assert got == jsra.uniform_allocation(layers, budget, max_ranks,
                                          min_rank)
    assert sum(got) == budget


def test_sra_refuses_what_the_reference_refuses():
    for mod in (jsra, tsra):
        with pytest.raises(ValueError, match="budget"):
            mod.sra_allocate(lambda r: 0.0, 2, 100, [8, 8])
        with pytest.raises(ValueError, match="one entry per layer"):
            mod.sra_allocate(lambda r: 0.0, 3, 10, [8, 8])
