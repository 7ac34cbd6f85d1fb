"""Failure and resource policy: the guarded device dispatch ladder, the
shared pending-stash eviction rule, the multi-tenant server's admission
budgets, fairness order and dispatch bin-packing, and the seeded
adversaries that drive them (disk, snapshot fs, device and
dependency-withholding network schedules, migration crash points)."""

from crdt_tpu_torch.guard.device import dispatch_guarded
from crdt_tpu_torch.guard.limits import evict_deepest
from crdt_tpu_torch.guard.tenant import (
    ResidentBudget,
    TenantBudget,
    fair_order,
    pack_batches,
)
from crdt_tpu_torch.guard.faults import (
    DeviceFaultPlan,
    DiskFaultSchedule,
    FaultyKv,
    SimulatedCrash,
    WithholdDeps,
)

__all__ = [
    "DeviceFaultPlan",
    "DiskFaultSchedule",
    "FaultyKv",
    "ResidentBudget",
    "SimulatedCrash",
    "TenantBudget",
    "WithholdDeps",
    "dispatch_guarded",
    "evict_deepest",
    "fair_order",
    "pack_batches",
]
