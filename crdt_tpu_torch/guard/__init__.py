"""Failure and resource policy: the guarded device dispatch ladder and
the multi-tenant server's admission budgets, fairness order and
dispatch bin-packing."""

from crdt_tpu_torch.guard.device import dispatch_guarded
from crdt_tpu_torch.guard.tenant import (
    ResidentBudget,
    TenantBudget,
    fair_order,
    pack_batches,
)

__all__ = [
    "ResidentBudget",
    "TenantBudget",
    "dispatch_guarded",
    "fair_order",
    "pack_batches",
]
