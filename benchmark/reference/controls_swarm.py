"""The control of the swarm's anti-entropy cell: the plain reference put
in the program's place with one guarantee of ``swarm_1k`` broken, which
the check must find. It is a ``program`` factory of
:mod:`benchmark.drivers.swarm`, as in :mod:`benchmark.reference.controls`.

- ``swarm``: a round whose document and snapshot are the union's, exact,
  but whose plan reads each peer's state vector from the swarm vector,
  so every deficit is 0: a plan that sends nothing (the exact plan is a
  guarantee of ``swarm_1k``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.gen import wire
from benchmark.reference import swarm as ref_swarm
from benchmark.reference import yjs


class Round(NamedTuple):
    cache: dict
    snapshot: bytes
    n_ops: int
    plan: ref_swarm.Plan


def swarm(drv):
    t = drv.table
    cache = yjs.converge(t, drv.ds)
    snap = wire.encode_union(t, *drv.ds)
    want = ref_swarm.plan(t, drv.views, drv.peers)
    told = np.tile(want.swarm_sv, (drv.peers, 1))
    plan = ref_swarm.Plan(want.clients, told, want.swarm_sv,
                          ref_swarm.deficit(torch.from_numpy(told)).numpy())
    return lambda blobs: Round(cache, snap, drv.n_ops, plan)


CONTROLS = {"swarm": swarm}
