"""Replica sync: the port's ``Replica`` / ``ypear_crdt`` and
``MemoryPersistence``, over the loopback router or over real, encrypted
UDP (``UdpRouter`` on the native transport), with the seeded fault and
simulated-NAT layer that puts a swarm under the reference's chaos
schedules."""

from crdt_tpu_torch.net.router import LoopbackNetwork, LoopbackRouter
from crdt_tpu_torch.net.replica import MemoryPersistence, Replica, ypear_crdt
from crdt_tpu_torch.net.udp_router import UdpRouter, pump
from crdt_tpu_torch.net.faults import (
    ConeNat,
    FaultSchedule,
    FaultyEndpoint,
    ForkFault,
    NatFabric,
    Partition,
    SymmetricNat,
    install_faults,
    install_nat,
    pump_until,
)

__all__ = [
    "ConeNat",
    "FaultSchedule",
    "FaultyEndpoint",
    "ForkFault",
    "LoopbackNetwork",
    "LoopbackRouter",
    "MemoryPersistence",
    "NatFabric",
    "Partition",
    "Replica",
    "SymmetricNat",
    "UdpRouter",
    "install_faults",
    "install_nat",
    "pump",
    "pump_until",
    "ypear_crdt",
]
