"""Replica sync over the loopback router: the port's ``Replica`` /
``ypear_crdt`` and ``MemoryPersistence``. The UDP router, its pump and
the fault/NAT layer are ROADMAP queue A item 7b."""

from crdt_tpu_torch.net.router import LoopbackNetwork, LoopbackRouter
from crdt_tpu_torch.net.replica import MemoryPersistence, Replica, ypear_crdt

__all__ = [
    "LoopbackNetwork",
    "LoopbackRouter",
    "MemoryPersistence",
    "Replica",
    "ypear_crdt",
]
