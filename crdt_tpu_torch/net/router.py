"""Loopback transport implementing the reference's router contract.

The port's copy of ``crdt_tpu.net.router``. The contract is duck-typed,
so port and reference replicas can share one :class:`LoopbackNetwork`.

The reference consumes `@ypear/router` (Hyperswarm: DHT discovery +
encrypted streams) through a narrow surface (crdt.js:172-317):
``is_ypear_router`` validation, an ``options`` bag shared across ypear
modules, ``update_options`` / ``update_options_cache``, ``start`` /
``started`` / ``peers``, and ``alow(topic, handler)`` returning the
four transport verbs ``(propagate, broadcast, for_peers, to_peer)``
(crdt.js:315-317).

This module provides that exact contract over an in-process fabric so
N replicas run in one process with deterministic, adversarially
schedulable delivery — the testing and protocol seam. A real
multi-process shim can implement this same contract over sockets.

Delivery is queue-based: verbs enqueue onto the shared
:class:`LoopbackNetwork`; nothing is handled until ``run()`` drains
the queue, optionally shuffling / duplicating / dropping messages
under a seeded RNG to emulate the reference's unordered, redundant
gossip fabric (Hyperswarm gives no ordering guarantee across peers;
Yjs idempotence absorbs duplicates).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple


class LoopbackNetwork:
    """Shared fabric: topic registry + deterministic delivery queue."""

    def __init__(
        self,
        seed: int = 0,
        *,
        reorder: bool = False,
        duplicate: float = 0.0,
        drop: float = 0.0,
    ):
        self.rng = random.Random(seed)
        self.reorder = reorder
        self.duplicate = duplicate
        self.drop = drop
        # topic -> [(router, handler)]
        self.topics: Dict[str, List[Tuple["LoopbackRouter", Callable]]] = {}
        self.queue: List[Tuple[Callable, dict, str]] = []
        self.delivered = 0
        self.dropped = 0

    def subscribe(self, topic: str, router: "LoopbackRouter", handler: Callable):
        self.topics.setdefault(topic, []).append((router, handler))
        # a joining peer triggers everyone's (re)sync entry point, the
        # way the router drives the injected cache contract
        # (crdt.js:237: `sync(forPeers, topic)`)
        for r, _ in self.topics[topic]:
            r._on_topology_change(topic)

    def unsubscribe(self, topic: str, router: "LoopbackRouter"):
        subs = self.topics.get(topic, [])
        self.topics[topic] = [(r, h) for r, h in subs if r is not router]
        for r, _ in self.topics[topic]:
            r._on_topology_change(topic)

    def subscribers(self, topic: str) -> List["LoopbackRouter"]:
        return [r for r, _ in self.topics.get(topic, [])]

    def enqueue(self, topic: str, to_router: "LoopbackRouter", msg: dict, frm: str):
        for _, handler in [
            (r, h) for r, h in self.topics.get(topic, []) if r is to_router
        ]:
            self.queue.append((handler, dict(msg), frm))

    def run(self, max_rounds: int = 10_000) -> int:
        """Drain the queue (handlers may enqueue more). Returns the
        number of messages delivered."""
        n0 = self.delivered
        rounds = 0
        while self.queue and rounds < max_rounds:
            rounds += 1
            batch, self.queue = self.queue, []
            if self.reorder:
                self.rng.shuffle(batch)
            for handler, msg, frm in batch:
                if self.drop and self.rng.random() < self.drop:
                    self.dropped += 1
                    continue
                copies = 1
                if self.duplicate and self.rng.random() < self.duplicate:
                    copies = 2
                for _ in range(copies):
                    handler(msg, frm)
                    self.delivered += 1
            # end of delivery round: replicas buffering inbound updates
            # (batch_incoming) merge the round's worth in one txn,
            # then get their timer tick (probe retry / anti-entropy —
            # mostly a no-op on this reliable fabric, but the contract
            # matches the UDP router so protocol tests can drive the
            # retry machinery through either transport)
            for topic, subs in list(self.topics.items()):
                for r, _ in subs:
                    contract = r.options.get("cache", {}).get(topic, {})
                    flush = contract.get("flush")
                    if flush is not None:
                        flush()
                    tick = contract.get("tick")
                    if tick is not None:
                        tick()
        if self.queue:
            raise RuntimeError(f"network did not quiesce in {max_rounds} rounds")
        return self.delivered - n0


class LoopbackRouter:
    """One peer's router — the contract surface of `@ypear/router`."""

    is_ypear_router = True  # crdt.js:172's validation flag

    def __init__(
        self,
        network: LoopbackNetwork,
        public_key: str,
        *,
        username: Optional[str] = None,
    ):
        self.network = network
        self.options: Dict[str, Any] = {
            "public_key": public_key,
            "username": username or public_key,
            "cache": {},
        }
        self.started = False
        self._subscribed: List[str] = []

    # -- options bag shared across ypear modules (crdt.js:175-180) -----
    def update_options(self, opts: Dict[str, Any]) -> None:
        self.options.update(opts)

    def update_options_cache(self, per_topic: Dict[str, dict]) -> None:
        # crdt.js:234: inject the per-topic sync contract
        for topic, contract in per_topic.items():
            self.options["cache"].setdefault(topic, {}).update(contract)

    # -- lifecycle (crdt.js:231) ---------------------------------------
    def start(self, network_name: Optional[str] = None) -> None:
        self.options.setdefault("network_name", network_name)
        self.started = True

    @property
    def public_key(self) -> str:
        return self.options["public_key"]

    def peers_on(self, topic: str) -> List[str]:
        return [
            r.public_key
            for r in self.network.subscribers(topic)
            if r is not self
        ]

    @property
    def peers(self) -> List[str]:
        # union over subscribed topics (the reference exposes swarm
        # peers, crdt.js:236)
        out: List[str] = []
        for t in self._subscribed:
            for pk in self.peers_on(t):
                if pk not in out:
                    out.append(pk)
        return out

    # -- the four verbs (crdt.js:315-317) -------------------------------
    def alow(self, topic: str, handler: Callable) -> Tuple[
        Callable, Callable, Callable, Callable
    ]:
        """Subscribe; returns (propagate, broadcast, for_peers, to_peer)."""
        self.network.subscribe(topic, self, handler)
        self._subscribed.append(topic)

        def propagate(msg: dict) -> None:
            for r in self.network.subscribers(topic):
                if r is not self:
                    self.network.enqueue(topic, r, msg, self.public_key)

        broadcast = propagate  # the reference uses them interchangeably

        def for_peers(fn: Callable[[str], None]) -> None:
            for pk in self.peers_on(topic):
                fn(pk)

        def to_peer(public_key: str, msg: dict) -> None:
            for r in self.network.subscribers(topic):
                if r.public_key == public_key:
                    self.network.enqueue(topic, r, msg, self.public_key)
                    return

        return propagate, broadcast, for_peers, to_peer

    def unsubscribe(self, topic: str) -> None:
        self.network.unsubscribe(topic, self)
        if topic in self._subscribed:
            self._subscribed.remove(topic)

    # -- topology hook driving the injected sync contract ---------------
    def _on_topology_change(self, topic: str) -> None:
        contract = self.options["cache"].get(topic)
        if contract and not contract.get("synced") and "sync" in contract:
            contract["sync"]()
