"""Item-store constants shared by the codec, the records and the replay.

The port's copy of the constants in ``crdt_tpu.core.store`` (the
columnar ``ItemStore`` itself belongs to the engine, which a later
slice ports). Numbering is identical, so decoded columns mean the
same thing in both packages.
"""

from __future__ import annotations

# content kinds (host-side; NOT the same numbering as wire content refs)
K_GC = 0
K_DELETED = 1
K_JSON = 2
K_BINARY = 3
K_STRING = 4
K_ANY = 5
K_TYPE = 6
# YText/subdoc payloads: carried for codec fidelity, not materialized
K_EMBED = 7
K_FORMAT = 8
K_DOC = 9

# Yjs type ref of a Y.Map in ContentType (Y.Array is 0)
TYPE_MAP = 1

NULL = -1
