"""Deterministic doc placement + epoch-fenced ownership leases.

The port's copy of ``crdt_tpu.fleet.placement``: the same owner for
every doc name, and a lease blob byte-equal to the reference's, so a
process restarts from a store either package wrote.

The cross-process half of ROADMAP item 2 starts here: N
``MultiDocServer`` processes agree on which one OWNS each doc without
talking to each other, and every ownership transfer is fenced by a
monotonically increasing epoch so a partitioned ex-owner can never
fork a doc.

Two pieces:

- :class:`HashRing` — a consistent-hash ring over the member set.
  Hashing is sha1-based (``stable_hash``), NOT Python ``hash()``:
  the mapping must be identical across processes and interpreter
  runs (PYTHONHASHSEED randomizes ``hash``). Virtual nodes smooth
  the distribution; member join/leave moves only the docs whose
  arc changed (the minimal-movement property
  ``tests/test_placement.py`` pins).

- :class:`LeaseTable` — per-doc ``(epoch, owner)`` fencing state.
  Epoch 1 is seeded deterministically from the ring (every process
  derives the same initial owner with zero communication); every
  migration commits ``epoch + 1``. :meth:`LeaseTable.admit` is the
  single fencing gate every inter-server frame, serve, and
  WAL/snapshot write passes through: a stale epoch is refused and
  counted (``fleet.fence_rejects{op=...}``), an equal epoch from a
  different claimant is a FORK and refused
  (``fleet.fork_refused``), a newer epoch is adopted (higher epoch
  always wins — that is what makes the fence safe across a
  partition heal). Grants persist through an attached snapshot
  store blob so a crashed process restarts with the epochs it held,
  never the ring defaults.
"""

from __future__ import annotations

import bisect
import hashlib
import json
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

from crdt_tpu_torch.obs import get_tracer

LEASE_BLOB = "fleet.leases"


def stable_hash(key: str) -> int:
    """64-bit process-stable hash (sha1 prefix) — the ring metric."""
    h = hashlib.sha1(key.encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big")


class FencingToken(NamedTuple):
    """The ``(epoch, proc)`` stamp every fenced operation carries."""

    epoch: int
    proc: str


class HashRing:
    """Consistent-hash ring: doc -> owner process, deterministic."""

    def __init__(self, members: Sequence[str], *, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._members: List[str] = []
        self._points: List[Tuple[int, str]] = []
        self._keys: List[int] = []
        for m in members:
            self.add(m)

    @property
    def members(self) -> List[str]:
        return sorted(self._members)

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.append(member)
        for v in range(self.vnodes):
            self._points.append(
                (stable_hash("%s#%d" % (member, v)), member))
        self._points.sort()
        self._keys = [p[0] for p in self._points]

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.remove(member)
        self._points = [p for p in self._points if p[1] != member]
        self._keys = [p[0] for p in self._points]

    def owner(self, doc) -> str:
        """The member owning ``doc``'s arc (epoch-1 ownership)."""
        if not self._points:
            raise ValueError("ring has no members")
        i = bisect.bisect_right(self._keys, stable_hash(str(doc)))
        return self._points[i % len(self._points)][1]

    def successors(self, doc, k: int) -> List[str]:
        """First ``k`` DISTINCT members clockwise of ``doc`` (the
        owner first) — the candidate destinations for rebalance."""
        if not self._points:
            return []
        out: List[str] = []
        i = bisect.bisect_right(self._keys, stable_hash(str(doc)))
        n = len(self._points)
        for j in range(n):
            m = self._points[(i + j) % n][1]
            if m not in out:
                out.append(m)
                if len(out) >= k:
                    break
        return out

    def least_loaded_successor(
        self, doc, *, exclude: Sequence[str] = (),
        loads: Optional[Dict[str, float]] = None,
    ) -> Optional[str]:
        """Advised migration destination: among the doc's ring
        successors minus ``exclude`` (the breaching owner), the one
        with the smallest ``loads`` value; ring order breaks ties,
        so every process computes the same hint."""
        cands = [m for m in self.successors(doc, len(self._members))
                 if m not in set(exclude)]
        if not cands:
            return None
        if not loads:
            return cands[0]
        return min(cands, key=lambda m: (float(loads.get(m, 0.0)), m))


class LeaseTable:
    """Per-doc ``(epoch, owner)`` state + the fencing gate.

    Deterministic counters (``fence_rejects`` / ``fork_refused``)
    mirror the tracer rows so the chaos harness can assert on them
    with tracing disabled, like ``snap_fallback_count`` does.
    """

    def __init__(self, proc: str, ring: HashRing, *, store=None):
        self.proc = str(proc)
        self.ring = ring
        self.store = store
        self._leases: Dict[str, Tuple[int, str]] = {}
        self.fence_rejects = 0
        self.fork_refused = 0
        if store is not None:
            self._load()

    # -- persistence (the crash-safety half of fencing) ----------------

    def _load(self) -> None:
        raw = self.store.get_blob(LEASE_BLOB)
        if raw is None:
            return
        try:
            data = json.loads(raw)
        except ValueError:
            return
        for d, v in data.items():
            try:
                self._leases[d] = (int(v[0]), str(v[1]))
            except (TypeError, ValueError, IndexError):
                continue

    def _save(self) -> None:
        if self.store is None:
            return
        self.store.put_blob(
            LEASE_BLOB,
            json.dumps({d: list(v) for d, v in
                        sorted(self._leases.items())},
                       sort_keys=True).encode())

    # -- reads ---------------------------------------------------------

    def lease(self, doc) -> Tuple[int, str]:
        """Current ``(epoch, owner)`` — ring-seeded at epoch 1 when
        no grant has ever been recorded for the doc."""
        d = str(doc)
        got = self._leases.get(d)
        if got is not None:
            return got
        return (1, self.ring.owner(d))

    def epoch_of(self, doc) -> int:
        return self.lease(doc)[0]

    def owner_of(self, doc) -> str:
        return self.lease(doc)[1]

    def holds(self, doc) -> bool:
        """Does THIS process own ``doc`` right now?"""
        return self.owner_of(doc) == self.proc

    def token(self, doc) -> FencingToken:
        """The stamp this process puts on fenced operations for
        ``doc`` (callers check :meth:`holds` first)."""
        return FencingToken(self.epoch_of(doc), self.proc)

    def owned_docs(self, docs) -> List[str]:
        return [str(d) for d in docs if self.holds(d)]

    def epochs_of(self, docs) -> Dict[str, int]:
        return {str(d): self.epoch_of(d) for d in docs}

    def recorded(self) -> Dict[str, Tuple[int, str]]:
        """Every EXPLICITLY granted lease (ring-default docs are
        absent) — the restart path walks this to find docs this
        process owns but whose state needs re-seeding."""
        return dict(self._leases)

    # -- writes --------------------------------------------------------

    def grant(self, doc, epoch: int, owner: str) -> bool:
        """Record a lease transfer. Refuses to move BACKWARD: a
        grant below the recorded epoch is a stale claim (returns
        False, counted); an equal-epoch grant to a DIFFERENT owner
        is a fork attempt and refused. Persisted when a store is
        attached, so the fence survives a crash+restart."""
        d = str(doc)
        cur_e, cur_o = self.lease(d)
        epoch = int(epoch)
        if epoch < cur_e:
            self.reject(d, "grant")
            return False
        if epoch == cur_e and owner != cur_o:
            self.fork_refused += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("fleet.fork_refused")
            return False
        self._leases[d] = (epoch, str(owner))
        self._save()
        return True

    def admit(self, doc, token: FencingToken, *, op: str) -> bool:
        """THE fencing gate. A frame/write/serve stamped ``token``
        is admitted iff it is not behind the recorded lease:

        - ``token.epoch < held`` -> refused + counted (stale owner);
        - ``token.epoch == held`` but a different proc than the
          recorded owner -> refused + ``fleet.fork_refused`` (two
          claimants at one epoch can only mean a fork attempt);
        - ``token.epoch > held`` -> ADOPTED (the sender holds a
          newer lease this process missed) and admitted.
        """
        d = str(doc)
        cur_e, cur_o = self.lease(d)
        if token.epoch < cur_e:
            self.reject(d, op)
            return False
        if token.epoch == cur_e:
            if token.proc != cur_o:
                self.fork_refused += 1
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.count("fleet.fork_refused")
                return False
            return True
        self._leases[d] = (int(token.epoch), str(token.proc))
        self._save()
        return True

    def reject(self, doc: str, op: str) -> None:
        self.fence_rejects += 1
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("fleet.fence_rejects", labels={"op": op})
