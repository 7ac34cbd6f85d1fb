"""SLO-driven control plane: deterministic tick-synchronous rules.

Rounds 16-21 built the sensor half of a feedback loop — per-tenant
burn rates (:mod:`crdt_tpu_torch.obs.slo`), admission-queue pressure,
pool/resident occupancy, snapshot fallback counts — and every one of
those signals was write-only: nothing read them back, so a flooding
tenant kept its static :class:`crdt_tpu_torch.guard.tenant.TenantBudget`
until an operator intervened. This module (round 22, ROADMAP item 2
"CLOSE THE LOOP") is the actuator half: a :class:`Controller` that
:class:`crdt_tpu_torch.models.multidoc.MultiDocServer` consults exactly
once per tick, reading a plain-dict **sensor snapshot** and answering
an :class:`Actuation` — per-tenant budget overrides, an LRU
protection set, a ``max_rows_per_dispatch`` setpoint, and a
checkpoint-cadence trigger.

**Determinism is the contract.** No rule reads a wall clock; every
window, cooldown, and hysteresis counter is indexed by the server's
tick number, and tenants are visited in sorted order. An identical
sensor trace therefore replays to a byte-identical decision ledger
(:meth:`Controller.replay`, pinned in ``tests/test_control.py``),
which is what turns "the budget dropped" from magic into
observability: ``tools/obsq.py control`` answers *why did tenant T's
budget drop at tick 412* offline from the JSONL dump alone.

**Rules** (each with a tick-indexed cooldown so an oscillating sensor
cannot flap a setpoint faster than ``cooldown_ticks``):

- ``budget_squeeze`` — a tenant whose burn rate breaches ``burn_hi``
  gets its admission budget divided by ``squeeze_div`` (floor 1) and
  its docs join the LRU protection set.
- ``budget_restore`` — a squeezed tenant that stays at or below
  ``burn_lo`` for ``restore_after`` consecutive observed ticks gets
  its static budget back (hysteresis: one clean tick is not enough).
- ``rows_squeeze`` / ``rows_restore`` — total pending bytes above
  ``pace_pending_bytes`` halves ``max_rows_per_dispatch`` (floor
  ``rows_floor``); sustained calm restores the base value.
- ``checkpoint_cadence`` — every ``checkpoint_every_ticks`` ticks or
  ``checkpoint_every_bytes`` settled bytes, ask the server for a
  background checkpoint so a restart never replays more than one
  cadence of WAL tail (ROADMAP item 4 remainder c).

Every decision lands in the bounded :class:`ControlLedger` (tick,
rule, sensors, old -> new setpoint, cooldown state), served live at
the ``/control`` HTTP endpoint, annotated into the Perfetto tick
timeline as instant events, and federated by the fleet collector as
placement *advice* rows.

Tracer emission (README "Control plane" registry; gated on
``tracer.enabled``): counters ``control.decisions`` (+
``control.decisions{rule=}``), ``control.cooldown_skips``,
``control.ledger_dropped``; gauges ``control.setpoint{knob=}``.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import (Any, Callable, Dict, FrozenSet, List, NamedTuple,
                    Optional, Tuple)

from crdt_tpu_torch.obs.tracer import get_tracer

DEFAULT_BURN_HI = 0.5
DEFAULT_BURN_LO = 0.25
DEFAULT_SQUEEZE_DIV = 4
DEFAULT_RESTORE_AFTER = 3
DEFAULT_COOLDOWN_TICKS = 8
DEFAULT_LEDGER_CAPACITY = 1024
DEFAULT_TRACE_CAPACITY = 4096
DEFAULT_ROWS_FLOOR = 1024

RULES = (
    "budget_squeeze", "budget_restore",
    "rows_squeeze", "rows_restore",
    "checkpoint_cadence",
)


class ControlLedger:
    """Bounded decision log: every rule firing, oldest-first.

    Rows are plain JSON-ready dicts; :meth:`to_jsonl` renders them
    with sorted keys so a replayed controller's ledger compares
    byte-for-byte. When the ring is full the oldest row is dropped
    and counted (``control.ledger_dropped`` — gated lower-is-better
    in ``tools/metrics_diff.py``: a hot control loop that churns its
    own audit trail is a finding, not a feature).
    """

    def __init__(self, capacity: int = DEFAULT_LEDGER_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._rows: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total = 0
        self.dropped = 0

    def append(self, row: Dict[str, Any]) -> None:
        tracer = get_tracer()
        with self._lock:
            if len(self._rows) == self.capacity:
                self.dropped += 1
                if tracer.enabled:
                    tracer.count("control.ledger_dropped", 1)
            self._rows.append(row)
            self.total += 1

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._rows)

    def tail(self, n: int) -> List[Dict[str, Any]]:
        with self._lock:
            if n <= 0:
                return []
            return list(self._rows)[-n:]

    def to_jsonl(self) -> str:
        return "".join(
            json.dumps(r, sort_keys=True) + "\n" for r in self.rows()
        )

    def dump_jsonl(self, path: str) -> int:
        """Write the ledger as JSONL; returns the row count."""
        rows = self.rows()
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        return len(rows)


class Actuation(NamedTuple):
    """One tick's actuator outputs, applied by the server.

    ``tenant_limits`` maps tenant -> ``(max_bytes, max_updates)``
    overrides (the full current override set, not a delta — the
    server reconciles). ``max_rows`` is ``None`` when the pacing
    setpoint is unchanged. ``rows`` carries the ledger rows appended
    THIS tick so the server can annotate its timeline without
    re-scanning the ledger.
    """

    tenant_limits: Dict[Any, Tuple[int, int]]
    protect: FrozenSet
    max_rows: Optional[int]
    checkpoint: bool
    rows: List[Dict[str, Any]]


class Controller:
    """Deterministic per-tick rule engine (see module doc).

    ``observe(sensors)`` is the whole read-side API: the server
    builds one JSON-ready sensor snapshot per tick and the controller
    answers an :class:`Actuation`. The snapshot is also recorded in a
    bounded trace ring so :meth:`replay` can re-run the exact
    decision sequence offline.
    """

    def __init__(self, *,
                 burn_hi: float = DEFAULT_BURN_HI,
                 burn_lo: float = DEFAULT_BURN_LO,
                 squeeze_div: int = DEFAULT_SQUEEZE_DIV,
                 restore_after: int = DEFAULT_RESTORE_AFTER,
                 cooldown_ticks: int = DEFAULT_COOLDOWN_TICKS,
                 ledger_capacity: int = DEFAULT_LEDGER_CAPACITY,
                 trace_capacity: int = DEFAULT_TRACE_CAPACITY,
                 pace_pending_bytes: Optional[int] = None,
                 rows_floor: int = DEFAULT_ROWS_FLOOR,
                 checkpoint_every_ticks: Optional[int] = None,
                 checkpoint_every_bytes: Optional[int] = None):
        self.burn_hi = float(burn_hi)
        self.burn_lo = float(burn_lo)
        self.squeeze_div = max(2, int(squeeze_div))
        self.restore_after = max(1, int(restore_after))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.pace_pending_bytes = (
            int(pace_pending_bytes) if pace_pending_bytes else None
        )
        self.rows_floor = max(1, int(rows_floor))
        self.checkpoint_every_ticks = (
            int(checkpoint_every_ticks) if checkpoint_every_ticks
            else None
        )
        self.checkpoint_every_bytes = (
            int(checkpoint_every_bytes) if checkpoint_every_bytes
            else None
        )
        self.ledger = ControlLedger(ledger_capacity)
        # bounded sensor trace: the replay/audit input
        self.trace: deque = deque(maxlen=max(1, int(trace_capacity)))
        self.decisions = 0
        self.cooldown_skips = 0
        # rule state — ALL tick-indexed, never wall-clock
        self._overrides: Dict[Any, Tuple[int, int]] = {}
        self._squeezed_at: Dict[Any, int] = {}
        # round 24: monotonic advice sequencing — every squeeze
        # stamps its advice row with a fresh seq, so the fleet
        # placement loop consuming federated rows can drop
        # duplicated/reordered advice idempotently
        self._advice_seq = 0
        self._squeezed_seq: Dict[Any, int] = {}
        # round 24: optional destination hint — the fleet layer
        # wires this to ``HashRing.least_loaded_successor`` so
        # advice rows name WHERE to move the tenant, not just away
        # from here. Not part of config(): replay without the hook
        # reproduces every decision (target is advisory, never an
        # input to the rules).
        self.placement_hint: Optional[Callable[[Any],
                                               Optional[str]]] = None
        self._clean: Dict[Any, int] = {}
        self._last_burn: Dict[Any, float] = {}
        self._cooldown_until: Dict[Any, int] = {}
        self._base_rows: Optional[int] = None
        self._rows_setpoint: Optional[int] = None
        self._rows_calm = 0
        self._last_ckpt_tick = 0
        self._ckpt_bytes_mark = 0

    # -- config / reporting --------------------------------------------

    def config(self) -> Dict[str, Any]:
        return {
            "burn_hi": self.burn_hi,
            "burn_lo": self.burn_lo,
            "squeeze_div": self.squeeze_div,
            "restore_after": self.restore_after,
            "cooldown_ticks": self.cooldown_ticks,
            "pace_pending_bytes": self.pace_pending_bytes,
            "rows_floor": self.rows_floor,
            "checkpoint_every_ticks": self.checkpoint_every_ticks,
            "checkpoint_every_bytes": self.checkpoint_every_bytes,
            "ledger_capacity": self.ledger.capacity,
        }

    def overrides(self) -> Dict[Any, Tuple[int, int]]:
        return dict(self._overrides)

    def advice(self) -> List[Dict[str, Any]]:
        """Placement advice for the fleet layer: one row per tenant
        the controller is actively squeezing — ROADMAP item 2's
        rebalance hint, consumed cross-process by
        ``fleet.loop.PlacementLoop`` (round 24). ``seq`` is
        monotonic per squeeze (duplicate/reordered rows dedup at
        the consumer); ``target`` is the advised destination (the
        least-loaded ring successor when the fleet layer wires
        :attr:`placement_hint`, ``None`` in-process)."""
        rows = []
        for t in sorted(self._overrides, key=str):
            target = None
            if self.placement_hint is not None:
                target = self.placement_hint(t)
            rows.append({
                "action": "rebalance_away",
                "tenant": str(t),
                "since_tick": self._squeezed_at.get(t, 0),
                "burn": round(self._last_burn.get(t, 0.0), 4),
                "seq": self._squeezed_seq.get(t, 0),
                "target": target,
            })
        return rows

    def report(self, limit: int = 128) -> Dict[str, Any]:
        """JSON-ready state: the ``/control`` endpoint payload."""
        return {
            "config": self.config(),
            "decisions": self.decisions,
            "cooldown_skips": self.cooldown_skips,
            "ledger_total": self.ledger.total,
            "ledger_dropped": self.ledger.dropped,
            "setpoints": {
                "max_rows": self._rows_setpoint,
                "tenants": {
                    str(t): list(v)
                    for t, v in sorted(
                        self._overrides.items(),
                        key=lambda kv: str(kv[0]),
                    )
                },
            },
            "advice": self.advice(),
            "rows": self.ledger.tail(max(0, int(limit))),
        }

    # -- the rule engine -----------------------------------------------

    def _cooled(self, key, tick: int) -> bool:
        """True when ``key``'s cooldown has expired at ``tick``;
        counts the skip otherwise."""
        until = self._cooldown_until.get(key, 0)
        if tick < until:
            self.cooldown_skips += 1
            tracer = get_tracer()
            if tracer.enabled:
                tracer.count("control.cooldown_skips", 1)
            return False
        return True

    def _decide(self, tick: int, rule: str, tenant, knob: str,
                old, new, sensors: Dict[str, Any],
                cooldown_key=None) -> Dict[str, Any]:
        if cooldown_key is not None:
            self._cooldown_until[cooldown_key] = (
                tick + self.cooldown_ticks
            )
        row = {
            "tick": tick,
            "rule": rule,
            "tenant": None if tenant is None else str(tenant),
            "knob": knob,
            "old": old,
            "new": new,
            "sensors": sensors,
            "cooldown_until": (
                self._cooldown_until.get(cooldown_key, 0)
                if cooldown_key is not None else 0
            ),
        }
        self.ledger.append(row)
        self.decisions += 1
        tracer = get_tracer()
        if tracer.enabled:
            tracer.count("control.decisions", 1)
            tracer.count("control.decisions", 1,
                         labels={"rule": rule})
        return row

    def _gauge_setpoint(self, knob: str, value) -> None:
        tracer = get_tracer()
        if tracer.enabled and value is not None:
            tracer.gauge("control.setpoint", float(value),
                         labels={"knob": knob})

    def observe(self, sensors: Dict[str, Any]) -> Actuation:
        """Run every rule against one tick's sensor snapshot.

        ``sensors`` must be JSON-ready (the trace IS the replay
        input) with at least ``tick``; recognized keys: ``max_rows``,
        ``pending_bytes``, ``settled_bytes``,
        ``budget {max_bytes,max_updates}``, and per-tenant
        ``tenants {t: {burn, shed, pending_bytes}}``.
        """
        self.trace.append(sensors)
        tick = int(sensors.get("tick", 0))
        rows: List[Dict[str, Any]] = []
        budget = sensors.get("budget") or {}
        base_bytes = int(budget.get("max_bytes", 1) or 1)
        base_updates = int(budget.get("max_updates", 1) or 1)
        tenants = sensors.get("tenants") or {}
        checkpoint = False

        # -- per-tenant budget squeeze / restore (sorted: determinism)
        for t in sorted(tenants, key=str):
            s = tenants[t] or {}
            burn = float(s.get("burn", 0.0))
            self._last_burn[t] = burn
            key = ("budget", t)
            if t not in self._overrides:
                if burn >= self.burn_hi and self._cooled(key, tick):
                    new = (max(1, base_bytes // self.squeeze_div),
                           max(1, base_updates // self.squeeze_div))
                    self._overrides[t] = new
                    self._squeezed_at[t] = tick
                    self._clean[t] = 0
                    self._advice_seq += 1
                    self._squeezed_seq[t] = self._advice_seq
                    rows.append(self._decide(
                        tick, "budget_squeeze", t, "tenant_budget",
                        [base_bytes, base_updates], list(new),
                        {"burn": round(burn, 4),
                         "shed": int(s.get("shed", 0)),
                         "pending_bytes":
                             int(s.get("pending_bytes", 0))},
                        cooldown_key=key,
                    ))
                    self._gauge_setpoint("tenant_budget_bytes",
                                         new[0])
                    self._gauge_setpoint("tenant_budget_updates",
                                         new[1])
            else:
                if burn <= self.burn_lo:
                    self._clean[t] = self._clean.get(t, 0) + 1
                else:
                    self._clean[t] = 0
                if (self._clean.get(t, 0) >= self.restore_after
                        and self._cooled(key, tick)):
                    old = self._overrides.pop(t)
                    self._squeezed_at.pop(t, None)
                    self._clean.pop(t, None)
                    rows.append(self._decide(
                        tick, "budget_restore", t, "tenant_budget",
                        list(old), [base_bytes, base_updates],
                        {"burn": round(burn, 4),
                         "clean_ticks": self.restore_after},
                        cooldown_key=key,
                    ))
                    self._gauge_setpoint("tenant_budget_bytes",
                                         base_bytes)
                    self._gauge_setpoint("tenant_budget_updates",
                                         base_updates)

        # -- dispatch pacing: max_rows_per_dispatch ---------------------
        max_rows: Optional[int] = None
        if self.pace_pending_bytes:
            if self._base_rows is None:
                self._base_rows = int(sensors.get("max_rows", 0) or 0)
            pending = int(sensors.get("pending_bytes", 0))
            cur = (self._rows_setpoint if self._rows_setpoint
                   is not None else self._base_rows)
            if pending >= self.pace_pending_bytes:
                self._rows_calm = 0
                new_rows = max(self.rows_floor, cur // 2)
                if new_rows < cur and self._cooled("rows", tick):
                    self._rows_setpoint = max_rows = new_rows
                    rows.append(self._decide(
                        tick, "rows_squeeze", None, "max_rows",
                        cur, new_rows,
                        {"pending_bytes": pending},
                        cooldown_key="rows",
                    ))
                    self._gauge_setpoint("max_rows", new_rows)
            elif self._rows_setpoint is not None:
                if pending < self.pace_pending_bytes // 2:
                    self._rows_calm += 1
                else:
                    self._rows_calm = 0
                if (self._rows_calm >= self.restore_after
                        and self._cooled("rows", tick)):
                    old = self._rows_setpoint
                    self._rows_setpoint = None
                    self._rows_calm = 0
                    max_rows = self._base_rows
                    rows.append(self._decide(
                        tick, "rows_restore", None, "max_rows",
                        old, self._base_rows,
                        {"pending_bytes": pending,
                         "calm_ticks": self.restore_after},
                        cooldown_key="rows",
                    ))
                    self._gauge_setpoint("max_rows", self._base_rows)

        # -- background checkpoint cadence ------------------------------
        settled = int(sensors.get("settled_bytes", 0))
        due_ticks = (
            self.checkpoint_every_ticks is not None
            and tick - self._last_ckpt_tick
            >= self.checkpoint_every_ticks
        )
        due_bytes = (
            self.checkpoint_every_bytes is not None
            and settled - self._ckpt_bytes_mark
            >= self.checkpoint_every_bytes
        )
        if due_ticks or due_bytes:
            checkpoint = True
            rows.append(self._decide(
                tick, "checkpoint_cadence", None, "checkpoint",
                self._last_ckpt_tick, tick,
                {"settled_bytes": settled - self._ckpt_bytes_mark,
                 "by": "ticks" if due_ticks else "bytes"},
            ))
            self._last_ckpt_tick = tick
            self._ckpt_bytes_mark = settled
            self._gauge_setpoint("checkpoint_tick", tick)

        return Actuation(
            tenant_limits=dict(self._overrides),
            protect=frozenset(self._overrides),
            max_rows=max_rows,
            checkpoint=checkpoint,
            rows=rows,
        )

    # -- offline replay -------------------------------------------------

    @classmethod
    def replay(cls, trace, **config) -> "Controller":
        """Re-run a recorded sensor trace through a fresh controller.

        With the same config, ``replay(list(c.trace),
        **c.config_kwargs)`` produces a ledger whose
        :meth:`ControlLedger.to_jsonl` is byte-identical to the
        original — the determinism pin, and the offline audit path
        (``obsq control``)."""
        c = cls(**config)
        for sensors in trace:
            c.observe(sensors)
        return c
