"""Identifier, delete-set and record primitives (host-side)."""

from crdt_tpu_torch.core.ids import DeleteSet, StateVector
from crdt_tpu_torch.core.records import ItemRecord

__all__ = ["DeleteSet", "ItemRecord", "StateVector"]
