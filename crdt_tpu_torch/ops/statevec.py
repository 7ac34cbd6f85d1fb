"""State-vector kernels.

The port's counterpart of ``crdt_tpu.ops.statevec``. State vectors are
dense ``[num_clients]`` next-clock tensors and the whole replica set is
processed at once:

- ``build``     items -> state vector (scatter-max of clock+1), for one
  replica's [N] items or, batched, for [R, N] replicas
- ``diff_mask`` which items a peer above `sv` still needs
- ``merge``     [R, C] vectors -> componentwise max (anti-entropy join)
- ``missing``   pairwise [R, R] deficit "what does i have that j lacks"
  (the ``sv_deficit`` kernel on the card, its plain version on the CPU)
- ``exact_missing`` the row scan, exact in int64
"""

from __future__ import annotations

import torch

from crdt_tpu_torch.ops.kernels import deficit_rows, sv_deficit


def build(client: torch.Tensor, clock: torch.Tensor, valid: torch.Tensor,
          num_clients: int) -> torch.Tensor:
    """Next-clock per client: [..., N] items -> [..., num_clients]
    int64, one vector per leading index (the reference maps its [N]
    form over replicas with ``vmap``). Each entry is the max clock+1 of
    the valid items of that client, 0 where there are none. Clients
    outside [0, num_clients) are dropped, as the reference's
    sort-and-read-the-run-tail form drops them."""
    lead = client.shape[:-1]
    n = client.shape[-1]
    r = 1
    for s in lead:
        r *= s
    cl = client.reshape(r, n).to(torch.int64)
    nxt = clock.reshape(r, n).to(torch.int64) + 1
    keep = valid.reshape(r, n) & (cl >= 0) & (cl < num_clients)
    rows = torch.arange(r, dtype=torch.int64, device=client.device)
    slot = rows[:, None] * num_clients + cl
    out = torch.zeros(r * num_clients, dtype=torch.int64,
                      device=client.device)
    out.scatter_reduce_(0, slot[keep], nxt[keep], reduce="amax",
                        include_self=False)
    return out.reshape(*lead, num_clients)


def diff_mask(client: torch.Tensor, clock: torch.Tensor, valid: torch.Tensor,
              sv: torch.Tensor) -> torch.Tensor:
    """True for items NOT covered by `sv` — the delta a peer needs
    (the syncer path, crdt.js:288). A client outside the vector's
    width is one the peer has never seen: watermark 0. The gather
    clamps the client as the reference's does. ``sv`` is one [C]
    vector for every item, or one vector a row: [R, C] for [R, N]
    items (the reference maps the [C] form over rows with ``vmap``)."""
    c = sv.shape[-1]
    known = client < c
    idx = client.long().clamp(0, c - 1)
    seen = sv[idx] if sv.dim() == 1 else torch.gather(sv, -1, idx)
    watermark = torch.where(known, seen, torch.zeros_like(seen))
    return valid & (clock >= watermark)


def merge(svs: torch.Tensor) -> torch.Tensor:
    """[R, C] -> [C] componentwise max."""
    return svs.max(dim=0).values


def exact_missing_rows(rows: torch.Tensor, svs: torch.Tensor) -> torch.Tensor:
    """[B, C] x [R, C] -> [B, R] deficit rows: what each of ``rows``'s
    replicas holds that every replica in ``svs`` lacks."""
    return deficit_rows(rows, svs)


def exact_missing(svs: torch.Tensor) -> torch.Tensor:
    """Exact [R, R] deficit matrix, O(chunk·R·C) live memory."""
    return exact_missing_rows(svs, svs)


def missing(svs: torch.Tensor) -> torch.Tensor:
    """[R, C] -> [R, R] total clocks replica i has that j lacks: entry
    (i, j) > 0 means i should send a delta to j. On the card this is
    the ``sv_deficit`` kernel; the reference's column centring and its
    2**31 envelope were TPU workarounds, and int64 needs neither."""
    return sv_deficit(svs.to(torch.int64))
