"""The plain reference of a swarm's anti-entropy plan, in plain PyTorch
on the CPU.

It reads the generator's record tables (:mod:`benchmark.gen.swarm`: the
table of every op and the rows each peer holds), never the program's
decode, and works out the state-vector handshake (crdt.js:237-291) the
way Yjs defines it:

- a peer's state vector: for each client, the clock after the last op
  of that client the peer holds (Yjs's ``getStateVector``: the next
  clock it expects), 0 for a client it holds nothing of;
- the swarm vector: the elementwise max over the peers;
- the deficit matrix: ``deficit[i, j] = sum_c max(0, sv_i[c] - sv_j[c])``,
  the clocks peer i holds that peer j lacks (what i sends j).

Departures from Yjs: a Yjs state vector is a map that leaves out the
clients a peer holds nothing of; here it is a dense row over every
client of the union, ascending, with 0 there. Yjs takes the clock
after a client's last struct; the views here hold each writer's ops
as a prefix of its clocks with no gaps, so that is the count held.
Yjs itself computes no deficit matrix: a peer answers each
``encodeStateAsUpdate(doc, sv)`` alone, and entry (i, j) is the length
of the ops that answer from i to j carries.

The converged document and snapshot of the round are the union's,
from :func:`benchmark.reference.yjs.converge` and
:func:`benchmark.gen.wire.encode_union`. Everything is int64; no
floating point is used, and TF32 is off all the same.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class Plan(NamedTuple):
    clients: np.ndarray   # [C] client ids, ascending
    peer_sv: np.ndarray   # [R, C]
    swarm_sv: np.ndarray  # [C]
    deficit: np.ndarray   # [R, R]


def plan(table: Dict, views: Dict, peers: int, chunk: int = 16) -> Plan:
    """The plan of a round over ``peers`` peers whose held rows are
    ``views["peer"]``/``views["row"]`` of ``table``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    client = torch.as_tensor(np.asarray(table["client"]), dtype=torch.int64)
    clock = torch.as_tensor(np.asarray(table["clock"]), dtype=torch.int64)
    clients = torch.unique(client)
    row = torch.as_tensor(np.asarray(views["row"]), dtype=torch.int64)
    peer = torch.as_tensor(np.asarray(views["peer"]), dtype=torch.int64)
    col = torch.searchsorted(clients, client[row])
    C = len(clients)
    sv = torch.zeros(peers * C, dtype=torch.int64)
    sv.scatter_reduce_(0, peer * C + col, clock[row] + 1, reduce="amax")
    sv = sv.reshape(peers, C)
    swarm = sv.max(dim=0).values if peers else torch.zeros(C, dtype=torch.int64)
    return Plan(clients.numpy(), sv.numpy(), swarm.numpy(),
                deficit(sv, chunk).numpy())


def deficit(sv: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """[R, C] int64 state vectors -> [R, R] ``sum_c max(0, sv_i[c] -
    sv_j[c])``, ``chunk`` rows of i at a time."""
    R = sv.shape[0]
    out = torch.empty((R, R), dtype=torch.int64)
    for a in range(0, R, chunk):
        diff = sv[a:a + chunk, None, :] - sv[None, :, :]
        out[a:a + chunk] = diff.clamp_(min=0).sum(dim=2)
    return out


def plan_diff(got, want: Plan) -> int:
    """Entries of ``want``'s vectors and matrix that ``got`` (a plan with
    the same fields, or None) does not hold exactly: all of them where
    ``got`` is missing, keys other clients or has another shape."""
    total = want.peer_sv.size + want.swarm_sv.size + want.deficit.size
    if got is None:
        return total
    try:
        fields = [np.asarray(getattr(got, f)) for f in Plan._fields]
    except AttributeError:
        return total
    if not np.array_equal(fields[0], want.clients):
        return total
    bad = 0
    for g, w in zip(fields[1:], want[1:]):
        bad += int((g != w).sum()) if g.shape == w.shape else w.size
    return bad
