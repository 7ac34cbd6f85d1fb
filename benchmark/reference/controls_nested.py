"""The controls of the cells added with the nested-array workspace: the
plain reference put in the program's place with one guarantee broken,
which the check must find. Each is a ``program`` factory of its driver,
as in :mod:`benchmark.reference.controls`.

- ``edits``: a replay that integrates every item as if it had no right
  origin (the exact Yjs state is a guarantee of ``nested_64``); its
  snapshot is the true union's, so only the document can give it away;
- ``server_uniform``: the server control of
  :mod:`benchmark.reference.controls` (reads miss the last write
  acknowledged to their record).
"""

from __future__ import annotations

import numpy as np

from benchmark.gen import nested
from benchmark.reference import controls, yata


def edits(drv):
    t = drv.table
    blind = dict(t, rc=np.full(len(t["client"]), -1, np.int64),
                 rk=np.full(len(t["client"]), -1, np.int64))
    out = controls.Replayed(yata.converge(blind, drv.ds),
                            nested.encode_union(t, *drv.ds),
                            len(t["client"]))
    return lambda blobs: out


CONTROLS = {"edits": edits, "server_uniform": controls.StaleReadServer}
