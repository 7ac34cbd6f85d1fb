"""The placement loop: federated advice in, migrations out.

The port's copy of ``crdt_tpu.fleet.loop``.

Closes ROADMAP item 2's last arc: the controllers already emit
``rebalance_away`` advice per squeezed tenant, the
``FleetCollector`` already federates those rows proc-tagged at
``/fleet`` — this loop CONSUMES them and actuates live migrations,
with the same discipline as the in-process controller:

- **idempotent**: rows dedup on ``(proc, tenant)`` + the round-24
  monotonic ``seq`` — a duplicated or reordered advice row (the
  chaos schedule injects both) can never double-start a handoff;
- **hysteresis**: advice must persist ``hysteresis`` consecutive
  polls before actuating (a one-poll burn spike is not a reason to
  move a doc);
- **budgeted**: at most ``budget_per_tick`` migrations start per
  poll, docs already mid-handoff are skipped;
- **auditable**: every decision (and every skip reason) appends to
  a replayable :class:`crdt_tpu_torch.obs.control.ControlLedger`, same
  JSONL schema as the in-process controller's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from crdt_tpu_torch.obs import get_tracer
from crdt_tpu_torch.obs.control import ControlLedger

from .placement import HashRing


class PlacementLoop:
    """``observe(tick, rows)`` per poll; ``resolve(proc)`` maps a
    proc name to its actuator (an object with ``migrate(doc, dst)``
    and ``lease`` — a :class:`FleetNode` or an RPC stub)."""

    def __init__(self, ring: HashRing,
                 resolve: Callable[[str], Any], *,
                 hysteresis: int = 2,
                 budget_per_tick: int = 1,
                 ledger: Optional[ControlLedger] = None):
        self.ring = ring
        self.resolve = resolve
        self.hysteresis = max(1, int(hysteresis))
        self.budget_per_tick = max(1, int(budget_per_tick))
        self.ledger = ledger if ledger is not None else ControlLedger()
        self._seen_seq: Dict[tuple, int] = {}
        self._streak: Dict[tuple, int] = {}
        # deterministic odometers
        self.migrations = 0
        self.dup_drops = 0

    def _log(self, tick: int, row: Dict[str, Any]) -> None:
        self.ledger.append(dict(row, tick=int(tick),
                                rule="migrate"))

    def observe(self, tick: int, rows: List[Dict[str, Any]], *,
                loads: Optional[Dict[str, float]] = None
                ) -> List[Dict[str, Any]]:
        """One poll over collector-shaped advice rows (each row:
        ``action``/``tenant``/``proc`` + the round-24 ``seq`` /
        ``target``). Returns the started migrations."""
        tracer = get_tracer()
        # fold this poll's rows: max-seq row per (proc, tenant),
        # counting the duplicates the fold removed
        fresh: Dict[tuple, Dict[str, Any]] = {}
        for row in rows:
            if row.get("action") != "rebalance_away":
                continue
            key = (str(row.get("proc", "")),
                   str(row.get("tenant", "")))
            seq = int(row.get("seq", 0) or 0)
            prev = fresh.get(key)
            if prev is not None:
                self.dup_drops += 1
                if tracer.enabled:
                    tracer.count("fleet.advice_dups")
                if seq <= int(prev.get("seq", 0) or 0):
                    continue
            fresh[key] = row
        # stale replays: a seq at or below the last ACTUATED one
        # for the key is the same advice coming around again
        for key in sorted(fresh):
            if int(fresh[key].get("seq", 0) or 0) <= \
                    self._seen_seq.get(key, -1):
                self.dup_drops += 1
                if tracer.enabled:
                    tracer.count("fleet.advice_dups")
                del fresh[key]
        # hysteresis streaks
        for key in list(self._streak):
            if key not in fresh:
                del self._streak[key]
        started: List[Dict[str, Any]] = []
        for key in sorted(fresh):
            self._streak[key] = self._streak.get(key, 0) + 1
        for key in sorted(fresh):
            if len(started) >= self.budget_per_tick:
                break
            if self._streak[key] < self.hysteresis:
                continue
            src, tenant = key
            row = fresh[key]
            node = self.resolve(src)
            if node is None:
                continue
            dst = row.get("target") or \
                self.ring.least_loaded_successor(
                    tenant, exclude=[src], loads=loads)
            if not dst or dst == src:
                continue
            if node.migrator.migrating(tenant):
                self._log(tick, {"tenant": tenant, "src": src,
                                 "dst": dst, "action": "skip",
                                 "why": "in_flight"})
                continue
            if not node.migrate(tenant, dst):
                self._log(tick, {"tenant": tenant, "src": src,
                                 "dst": dst, "action": "skip",
                                 "why": "refused"})
                continue
            self._seen_seq[key] = int(row.get("seq", 0) or 0)
            self._streak[key] = 0
            self.migrations += 1
            if tracer.enabled:
                tracer.count("fleet.migrations_started")
            dec = {"tenant": tenant, "src": src, "dst": dst,
                   "seq": int(row.get("seq", 0) or 0),
                   "burn": row.get("burn"), "action": "migrate"}
            self._log(tick, dec)
            started.append(dec)
        return started
