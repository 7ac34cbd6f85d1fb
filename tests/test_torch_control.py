"""The port's SLO ledger and control plane against the reference's, on
the CPU.

``SLOLedger`` reports and ``Controller`` actuations must equal the
reference's on the same inputs (explicit latencies, the same sensor
sequences, ``Controller.replay``), and a ``control=True`` port server on
a flooding trace must write the same decision ledger, shed the same
updates and serve the same digests as the reference's server. The HTTP
scrape endpoint is not ported yet (ROADMAP queue A item 7b).
"""

import json

import numpy as np
import pytest

from crdt_tpu.models.multidoc import MultiDocServer as RefServer
from crdt_tpu.obs import SLOLedger as RefSLO
from crdt_tpu.obs.control import Controller as RefController
from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.obs import (SLOLedger, TickTimeline, Tracer,
                                set_timeline, set_tracer)
from crdt_tpu_torch.obs.control import Actuation, Controller
from crdt_tpu_torch.storage.snapshot import SnapshotStore
from tests.test_control import _sensors, chain_blob, flood_blob


@pytest.fixture(autouse=True)
def _quiet_obs():
    old_tracer = set_tracer(Tracer(enabled=False))
    old_tl = set_timeline(TickTimeline(enabled=False))
    yield
    set_tracer(old_tracer)
    set_timeline(old_tl)


# ---------------------------------------------------------------------------
# the SLO ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_ledger_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = RefSLO(40.0, burn_window=8), SLOLedger(40.0, burn_window=8)
    tenants = ["a", "b", 7]
    for _ in range(60):
        t = tenants[int(rng.integers(0, 3))]
        op = rng.random()
        lat = [float(x) for x in rng.exponential(0.03, int(rng.integers(1, 5)))]
        if op < 0.45:
            route = ["cold", "delta", "fallback"][int(rng.integers(0, 3))]
            ref.converged(t, lat, route)
            port.converged(t, lat, route)
        elif op < 0.85:
            ref.served(t, lat)
            port.served(t, lat)
        else:
            n = int(rng.integers(1, 4))
            ref.shed(t, n)
            port.shed(t, n)
        assert port.publish_worst() == ref.publish_worst()
    assert port.report() == ref.report()
    assert port.control_snapshot() == ref.control_snapshot()
    for t in tenants:
        assert port.breaches(t) == ref.breaches(t)
        assert port.route_counts(t) == ref.route_counts(t)


def test_slo_objective_from_env(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_SLO_MS", "75")
    assert SLOLedger().slo_ms == RefSLO().slo_ms == 75.0
    monkeypatch.setenv("CRDT_TPU_SLO_MS", "not a number")
    assert SLOLedger().slo_ms == RefSLO().slo_ms


# ---------------------------------------------------------------------------
# the rule engine
# ---------------------------------------------------------------------------


def _act(a) -> tuple:
    return (a.tenant_limits, a.protect, a.max_rows, a.checkpoint, a.rows)


CONFIGS = [
    dict(cooldown_ticks=0, restore_after=3),
    dict(cooldown_ticks=5, restore_after=1, ledger_capacity=2),
    dict(cooldown_ticks=0, restore_after=2, pace_pending_bytes=1000,
         rows_floor=4),
    dict(cooldown_ticks=3, restore_after=2, ledger_capacity=2,
         pace_pending_bytes=1000, rows_floor=2, checkpoint_every_ticks=5),
    dict(checkpoint_every_bytes=100),
]


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_controller_actuations_match_reference(cfg):
    rng = np.random.default_rng(cfg)
    ref, port = RefController(**CONFIGS[cfg]), Controller(**CONFIGS[cfg])
    for t in range(30):
        sensors = _sensors(
            t, float(rng.choice([0.0, 0.2, 0.9, 1.0])),
            tenant=["flood!", "b"][t % 2], shed=int(rng.integers(0, 9)),
            max_rows=16, pending_total=int(rng.integers(0, 6000)),
            settled=64 * t)
        a, b = ref.observe(dict(sensors)), port.observe(dict(sensors))
        assert isinstance(b, Actuation)
        assert _act(b) == _act(a)
    assert port.ledger.to_jsonl() == ref.ledger.to_jsonl()
    assert (port.decisions, port.cooldown_skips) == \
        (ref.decisions, ref.cooldown_skips)
    assert port.overrides() == ref.overrides()
    assert port.advice() == ref.advice()
    assert port.config() == ref.config()
    assert json.dumps(port.report(limit=3), sort_keys=True) == \
        json.dumps(ref.report(limit=3), sort_keys=True)
    again = Controller.replay(list(port.trace), **port.config())
    assert again.ledger.to_jsonl() == port.ledger.to_jsonl()
    assert RefController.replay(list(port.trace), **port.config()) \
        .ledger.to_jsonl() == port.ledger.to_jsonl()


# ---------------------------------------------------------------------------
# the server with its controller
# ---------------------------------------------------------------------------


def _flood_run(server_cls, ctrl_cls, slo_cls, *, flood_ticks=4,
               calm_ticks=16, neighbors=2, **kw):
    ctrl = ctrl_cls(cooldown_ticks=4, restore_after=2)
    srv = server_cls(tenant_max_pending_bytes=2048,
                     tenant_max_pending_updates=4, slo_ms=1e9,
                     control=ctrl, **kw)
    srv.slo = slo_cls(1e9, burn_window=16)
    docs = [f"n{i}" for i in range(neighbors)]
    clocks = dict.fromkeys(docs + ["flood!"], 0)
    nblob = 0
    for t in range(flood_ticks + calm_ticks):
        if t < flood_ticks:
            for _ in range(8):
                srv.submit("flood!", flood_blob(nblob))
                nblob += 1
        else:
            srv.submit("flood!", chain_blob(500, clocks["flood!"], 2))
            clocks["flood!"] += 2
        for i, d in enumerate(docs):
            srv.submit(d, chain_blob(600 + i, clocks[d], 3))
            clocks[d] += 3
        srv.tick()
    return srv, ctrl


def test_controlled_server_on_a_flood_matches_reference():
    ref, rctrl = _flood_run(RefServer, RefController, RefSLO)
    port, pctrl = _flood_run(MultiDocServer, Controller, SLOLedger,
                             device="cpu")
    rules = [r["rule"] for r in pctrl.ledger.rows()]
    assert "budget_squeeze" in rules and "budget_restore" in rules
    assert pctrl.ledger.to_jsonl() == rctrl.ledger.to_jsonl()
    assert port.shed_count == ref.shed_count > 0
    assert port.doc_digests() == ref.doc_digests()
    assert port.budget.overrides() == ref.budget.overrides()
    assert Controller.replay(list(pctrl.trace), **pctrl.config()) \
        .ledger.to_jsonl() == pctrl.ledger.to_jsonl()


def test_control_true_builds_the_default_controller():
    srv = MultiDocServer(control=True, device="cpu")
    assert isinstance(srv.control, Controller)
    assert MultiDocServer(device="cpu").control is None


def test_cadence_checkpoints_and_restore(tmp_path):
    cadence, total = 3, 10
    srv = MultiDocServer(snap_store=SnapshotStore(str(tmp_path)),
                         checkpoint_every_ticks=cadence, device="cpu")
    assert srv.control is not None
    blobs = [chain_blob(42, 4 * k) for k in range(total)]
    for b in blobs:
        srv.submit("w", b)
        srv.tick()
    assert srv.cadence_checkpoints >= total // cadence
    store = SnapshotStore(str(tmp_path))
    seq = json.loads(store.get_blob("checkpoint.manifest"))["w"]["seq"]
    assert total - cadence <= seq <= total
    srv2 = MultiDocServer(snap_store=store, device="cpu")
    assert srv2.restore() == 1
    for b in blobs[seq:]:
        srv2.submit("w", b)
    srv2.tick()
    oracle = RefServer(snap_store=None)
    for b in blobs:
        oracle.submit("w", b)
    oracle.tick()
    assert srv2.digest("w") == oracle.digest("w")
