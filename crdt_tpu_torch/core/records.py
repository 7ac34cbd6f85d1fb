"""Interchange records between the codec, engine, and kernels.

An ``ItemRecord`` is one unit-length CRDT item in symbolic form (string
parent/key names, explicit ID tuples) — the currency of the v1 update
codec and of ``Engine.apply_records``. Inside an :class:`ItemStore` the
same item is a row of interned integer columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from crdt_tpu_torch.core.store import K_ANY, NULL


@dataclass
class ItemRecord:
    client: int
    clock: int
    # exactly one of parent_root / parent_item is set; both None only for
    # GC filler records whose position information was collected away
    parent_root: Optional[str] = None
    parent_item: Optional[Tuple[int, int]] = None
    key: Optional[str] = None  # map key; None for sequence items
    origin: Optional[Tuple[int, int]] = None  # YATA left origin
    right: Optional[Tuple[int, int]] = None  # YATA right origin
    kind: int = K_ANY
    type_ref: int = NULL
    content: Any = None

    @property
    def id(self) -> Tuple[int, int]:
        return (self.client, self.clock)

    def dep_ids(self):
        """IDs this record cannot integrate without (origins + item parent)."""
        deps = []
        if self.origin is not None:
            deps.append(self.origin)
        if self.right is not None:
            deps.append(self.right)
        if self.parent_item is not None:
            deps.append(self.parent_item)
        return deps
