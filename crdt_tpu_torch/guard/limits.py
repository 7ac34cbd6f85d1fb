"""Shared bounded-stash eviction policy (the port's copy of
``crdt_tpu_torch.guard.limits``).

One implementation of the pending-stash eviction ranking, used by both
backends (:class:`crdt_tpu_torch.core.engine.Engine` and
:class:`crdt_tpu_torch.models.incremental.IncrementalReplay`) so the
fairness rule and the recovery bookkeeping cannot drift apart.
"""

from typing import Dict, Iterable, List, Tuple


def evict_deepest(
    keys: Iterable[Tuple[int, int]], limit: int
) -> Tuple[List[Tuple[int, int]], Dict[int, Tuple[int, int]]]:
    """Pick which ``(client, clock)`` ids to evict to shrink a pending
    stash to ``limit``: the ids DEEPEST in their own client's queue.
    Per-client clocks are contiguous, so an id's rank within its
    client (0 = the next to integrate once the gap heals) measures
    distance from its missing dependency — ranking per client, not by
    absolute clock, keeps one flooding fresh client (low clocks) from
    starving a long-lived client's nearly-ready records.

    Returns ``(evicted_keys, ranges)``; ``ranges`` maps client ->
    ``(lo, hi)`` evicted clock range for the replica layer's targeted
    re-probe. Safe by the sync protocol's own math: evicted records
    never advanced the state vector, so any ready-probe answer
    re-ships them.
    """
    keys = sorted(keys)
    n_evict = len(keys) - limit
    if n_evict <= 0:
        return [], {}
    ranked = []
    prev_client, rank = None, 0
    for key in keys:
        rank = rank + 1 if key[0] == prev_client else 0
        prev_client = key[0]
        ranked.append((rank, key[1], key))
    ranked.sort(reverse=True)  # deepest-in-queue first
    evicted = [key for _, _, key in ranked[:n_evict]]
    ranges: Dict[int, Tuple[int, int]] = {}
    for c, k in evicted:
        lo, hi = ranges.get(c, (k, k))
        ranges[c] = (min(lo, k), max(hi, k))
    return evicted, ranges
