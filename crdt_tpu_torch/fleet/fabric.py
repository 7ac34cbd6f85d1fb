"""In-process fleet fabrics: deterministic message plumbing.

The port's copy of ``crdt_tpu.fleet.fabric``; :class:`UdpFabric` runs
over the port's build of the sealed transport
(:mod:`crdt_tpu_torch.net.transport`).

Two transports sit behind ``FleetNode.fabric``:

- :class:`MemFabric` — the chaos harness's loopback: per-process
  FIFO queues, scripted partitions, process kill/revive, and a
  seeded fault hook (``net/faults.py`` schedules) deciding
  drop/duplicate per frame. Fully deterministic: frame order is
  send order, faults key on per-link frame counts, never randomness
  at call time.

- :class:`UdpFabric` — the same interface over the round-7 sealed
  ``UdpEndpoint`` streams for the subprocess smoke leg: every frame
  is SecureBox-sealed to the peer (the header never travels in the
  clear), and the reliable-message layer handles fragmentation and
  retry.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple


class MemFabric:
    """Loopback fabric with scripted chaos."""

    def __init__(self, *, faults=None):
        # faults: an object with decide(src, dst, kind, n) ->
        # {"drop": bool, "dup": int} (see
        # net.faults.HandoffFaultSchedule); None = perfect links
        self.faults = faults
        self._queues: Dict[str, deque] = {}
        self._nodes: Dict[str, object] = {}
        self._link_n: Dict[Tuple[str, str], int] = {}
        self._partitions: List[Tuple[frozenset, frozenset]] = []
        self.dead: set = set()
        self.sent = 0
        self.dropped = 0
        self.duplicated = 0

    def register(self, proc: str, node) -> None:
        self._nodes[proc] = node
        self._queues.setdefault(proc, deque())

    def node(self, proc: str):
        return self._nodes.get(proc)

    # -- chaos levers --------------------------------------------------

    def partition(self, group_a, group_b) -> None:
        self._partitions.append(
            (frozenset(group_a), frozenset(group_b)))

    def heal(self) -> None:
        self._partitions = []

    def kill(self, proc: str) -> None:
        """Process death: its queue is torn down (in-flight frames
        die with it) and frames to/from it drop until revive."""
        self.dead.add(proc)
        self._queues[proc] = deque()

    def revive(self, proc: str, node=None) -> None:
        self.dead.discard(proc)
        if node is not None:
            self._nodes[proc] = node
        self._queues.setdefault(proc, deque())

    def _blocked(self, src: str, dst: str) -> bool:
        for a, b in self._partitions:
            if (src in a and dst in b) or (src in b and dst in a):
                return True
        return False

    # -- the wire ------------------------------------------------------

    def send(self, src: str, dst: str, data: bytes) -> None:
        self.sent += 1
        if src in self.dead or dst in self.dead or \
                self._blocked(src, dst):
            self.dropped += 1
            return
        n = self._link_n.get((src, dst), 0) + 1
        self._link_n[(src, dst)] = n
        copies = 1
        if self.faults is not None:
            # kind peeks past the header for fault targeting; a
            # failed peek still delivers (fault layer, not codec)
            from . import wire

            dec = wire.decode_frame(data)
            kind = dec[0].get("kind", "") if dec else ""
            verdict = self.faults.decide(src, dst, kind, n) or {}
            if verdict.get("drop"):
                self.dropped += 1
                return
            copies += int(verdict.get("dup", 0))
            self.duplicated += copies - 1
        q = self._queues.setdefault(dst, deque())
        for _ in range(copies):
            q.append((src, data))

    def deliver(self, proc: str) -> List[Tuple[str, bytes]]:
        if proc in self.dead:
            return []
        q = self._queues.setdefault(proc, deque())
        out = list(q)
        q.clear()
        return out


class UdpFabric:
    """``MemFabric``'s interface over sealed UDP — one endpoint per
    process, a static peer book mapping proc name -> (addr, port,
    SecureBox). Frames ride the reliable-message layer."""

    def __init__(self, proc: str, endpoint, peers: Dict[str, tuple]):
        self.proc = proc
        self.endpoint = endpoint
        # peers: name -> (ip, port, SecureBox)
        self.peers = dict(peers)
        self._port_of = {name: p[1] for name, p in self.peers.items()}
        self._by_port = {p[1]: name for name, p in self.peers.items()}

    def register(self, proc: str, node) -> None:
        pass  # the peer book is static; nothing to wire

    def send(self, src: str, dst: str, data: bytes) -> None:
        peer = self.peers.get(dst)
        if peer is None:
            return
        ip, port, box = peer
        self.endpoint.send(ip, port, box.encrypt(data))

    def deliver(self, proc: str) -> List[Tuple[str, bytes]]:
        self.endpoint.poll()
        out: List[Tuple[str, bytes]] = []
        for _ip, port, sealed in self.endpoint.recv_all():
            src = self._by_port.get(port, "")
            box = self.peers.get(src, (None, None, None))[2]
            if box is None:
                continue
            try:
                out.append((src, box.decrypt(sealed)))
            except ValueError:
                continue
        return out
