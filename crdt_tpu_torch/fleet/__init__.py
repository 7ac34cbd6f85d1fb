"""Cross-process fleet serving: the port's counterpart of
``crdt_tpu.fleet``, with every node's ``MultiDocServer`` on ``device``
(the card unless the caller asks for the CPU).

Doc-sharded serving across N ``MultiDocServer`` processes:
deterministic consistent-hash placement with epoch-fenced ownership
leases (``placement``), crash-safe live migration over the sealed
transport (``migration``), the node glue (``node``), deterministic
chaos fabrics (``fabric``), and the placement loop consuming the
federated ``rebalance_away`` advice (``loop``). Frames, lease blobs
and intent blobs are byte-equal to the reference's, so port and
reference nodes share one fabric and one snapshot store. The layer is
host code: its device work is what each node's server already does.
"""

from .fabric import MemFabric, UdpFabric
from .loop import PlacementLoop
from .migration import MIGRATION_STEPS, Migrator, adopt_doc, remove_doc
from .node import FleetNode
from .placement import FencingToken, HashRing, LeaseTable, stable_hash

__all__ = [
    "FencingToken", "FleetNode", "HashRing", "LeaseTable",
    "MemFabric", "MIGRATION_STEPS", "Migrator", "PlacementLoop",
    "UdpFabric", "adopt_doc", "remove_doc", "stable_hash",
]
