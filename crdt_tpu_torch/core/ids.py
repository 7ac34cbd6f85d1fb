"""Identifier, state-vector, and delete-set primitives.

The reference delegates these concepts to Yjs (used via
``Y.encodeStateVector`` / delete sets inside updates, crdt.js:59,239,258).
Here they are first-class host types with exact semantics:

- ``ID``: (client, clock). ``clock`` is the per-client item counter —
  the n-th item created by a client has clock n (unit-length items).
- ``StateVector``: client -> next expected clock (== number of clocks
  seen from that client). Yjs semantics: a state vector of {c: k} means
  clocks [0, k) from client c are known.
- ``DeleteSet``: client -> sorted, merged list of [clock, clock+len)
  ranges of deleted items.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

NULL_ID = (-1, -1)


@dataclass(frozen=True, order=True)
class ID:
    client: int
    clock: int

    def as_tuple(self) -> Tuple[int, int]:
        return (self.client, self.clock)


class StateVector:
    """client -> next clock. Missing client == 0 clocks known."""

    __slots__ = ("clocks",)

    def __init__(self, clocks: Dict[int, int] | None = None):
        self.clocks: Dict[int, int] = dict(clocks or {})

    def get(self, client: int) -> int:
        return self.clocks.get(client, 0)

    def observe(self, client: int, clock: int, length: int = 1) -> None:
        """Record that clocks [clock, clock+length) from `client` are known."""
        end = clock + length
        if end > self.clocks.get(client, 0):
            self.clocks[client] = end

    def covers(self, client: int, clock: int) -> bool:
        return clock < self.clocks.get(client, 0)

    def merge(self, other: "StateVector") -> "StateVector":
        out = StateVector(self.clocks)
        for c, k in other.clocks.items():
            if k > out.clocks.get(c, 0):
                out.clocks[c] = k
        return out

    def diff_dominates(self, other: "StateVector") -> bool:
        """True if self >= other componentwise."""
        return all(self.get(c) >= k for c, k in other.clocks.items())

    def copy(self) -> "StateVector":
        return StateVector(self.clocks)

    def __eq__(self, other) -> bool:
        if not isinstance(other, StateVector):
            return NotImplemented
        a = {c: k for c, k in self.clocks.items() if k > 0}
        b = {c: k for c, k in other.clocks.items() if k > 0}
        return a == b

    def __repr__(self) -> str:
        return f"StateVector({self.clocks!r})"


def _merge_ranges(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sort and coalesce half-open [start, end) ranges."""
    if not ranges:
        return []
    ranges = sorted(ranges)
    out = [ranges[0]]
    for s, e in ranges[1:]:
        ls, le = out[-1]
        if s <= le:
            out[-1] = (ls, max(le, e))
        else:
            out.append((s, e))
    return out


@dataclass
class DeleteSet:
    """client -> sorted half-open [start, end) deleted-clock ranges.

    Ranges are coalesced lazily: ``add`` marks the set dirty and every
    reader normalizes first, so the sorted-disjoint invariant queries
    rely on always holds.
    """

    ranges: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)
    _dirty: bool = False

    def add(self, client: int, clock: int, length: int = 1) -> None:
        self.ranges.setdefault(client, []).append((clock, clock + length))
        self._dirty = True

    def normalize(self) -> None:
        if not self._dirty:
            # still drop empty clients inserted externally
            for c in [c for c, r in self.ranges.items() if not r]:
                del self.ranges[c]
            return
        for c in list(self.ranges):
            merged = _merge_ranges(self.ranges[c])
            if merged:
                self.ranges[c] = merged
            else:
                del self.ranges[c]
        self._dirty = False

    def covers(self, client: int, clock: int, length: int = 1) -> bool:
        """True when [clock, clock+length) lies inside ONE recorded
        range (ranges are normalized disjoint, so full coverage
        requires a single containing range)."""
        if self._dirty:
            self.normalize()
        rs = self.ranges.get(client)
        if not rs:
            return False
        end = clock + length
        lo, hi = 0, len(rs)
        while lo < hi:
            mid = (lo + hi) // 2
            s, e = rs[mid]
            if clock < s:
                hi = mid
            elif clock >= e:
                lo = mid + 1
            else:
                return end <= e
        return False

    def contains(self, client: int, clock: int) -> bool:
        return self.covers(client, clock, 1)

    def merge(self, other: "DeleteSet") -> "DeleteSet":
        out = DeleteSet({c: list(r) for c, r in self.ranges.items()})
        for c, rs in other.ranges.items():
            out.ranges.setdefault(c, []).extend(rs)
        out._dirty = True
        out.normalize()
        return out

    def iter_all(self) -> Iterator[Tuple[int, int, int]]:
        """Yield (client, clock, length) for every range, clients sorted."""
        if self._dirty:
            self.normalize()
        for c in sorted(self.ranges):
            for s, e in self.ranges[c]:
                yield (c, s, e - s)

    def copy(self) -> "DeleteSet":
        out = DeleteSet({c: list(r) for c, r in self.ranges.items()})
        out._dirty = self._dirty
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, DeleteSet):
            return NotImplemented
        a, b = self.copy(), other.copy()
        a.normalize()
        b.normalize()
        return a.ranges == b.ranges
