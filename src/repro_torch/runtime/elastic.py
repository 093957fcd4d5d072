"""Pool-pressure preemption policy, copied from `repro.runtime.elastic`
(the victim selection the scheduler uses; the mesh half of that module
comes with the port's multi-device work).

  * newest request first (max rid): least sunk prefill work;
  * only sequences that have emitted nothing, so no user-visible output
    is lost and the engine's count-based pipeline stays exact, and that
    hold no speculative draft blocks;
  * each request yields at most once (`Request.requeued`).
"""
from __future__ import annotations


def preemption_victims(live_seqs):
    """Live sequences eligible for pool-pressure preemption, in eviction
    order (newest request first). Eligibility: zero emitted tokens, no
    in-flight speculative draft, not already requeued once."""
    eligible = [s for s in live_seqs
                if s is not None and s.n_emitted == 0
                and not s.draft_blocks
                and not getattr(s.req, "requeued", False)]
    return sorted(
        eligible,
        key=lambda s: -1 if s.req.rid is None else s.req.rid,
        reverse=True)


def reclaimable_blocks(pool, seq) -> int:
    """Blocks the pool gets back if `seq` is preempted now: holdings (and
    any copy-on-write pin) no other sequence shares. Shared prefix blocks
    with refcount > 1 stay resident for their other holders, so they do
    not count."""
    held = set(seq.block_ids)
    n = sum(1 for b in held if pool.refcount(b) == 1)
    cow = getattr(seq, "cow_src", None)
    if cow is not None and cow not in held and pool.refcount(cow) == 1:
        n += 1
    return n
