"""Trace replay — BASELINE config #5 as a product API, on the card.

The port's counterpart of ``crdt_tpu.models.replay`` (its
``route="device"`` path). ``replay_trace(blobs, device=...)`` ingests a
batch of v1 update blobs (a captured swarm trace, a persistence log, a
sync backlog) end to end:

  1. decode: one native-codec pass -> columnar union + contents
     (:mod:`crdt_tpu_torch.codec.native`, Python fallback included);
  2. stage: the packed section layout on the host, in numpy
     (:mod:`crdt_tpu_torch.ops.staging`);
  3. converge: one upload, one launch sequence (both hand-written
     kernels), one fetch (:mod:`crdt_tpu_torch.ops.packed`);
  4. gather + materialize: winner rows and document orders -> the
     plain-JSON ``crdt.c`` cache, tombstones applied;
  5. compact: one snapshot blob (the log squashed).

``replay_trace(blobs, route="fleet", device=...)`` converges the same
blobs as ONE replica-fleet gossip + merge round instead
(:mod:`crdt_tpu_torch.models.fleet`), with steps 4 and 5 shared.

Cache and snapshot are byte-identical to the reference's on the same
blobs (tests/test_torch_replay.py, tests/test_torch_fleet.py). Some
inputs need the reference's scalar host machinery (``ops/yata.py``,
``core/engine.py``), which a later slice ports; until then each raises
``NotImplementedError`` naming its ROADMAP.md item instead of giving a
wrong answer: a union the packed stager cannot express, a plan with
hard rows, map rows that carry right origins, and (on the fleet route)
sequence rows that carry right origins.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from crdt_tpu_torch.codec import native
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.store import K_TYPE, TYPE_MAP
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed, staging
from crdt_tpu_torch.ops.device import resolve_device, xfer_put

# where the missing host fallbacks are queued
_FALLBACK_ITEM = "ROADMAP.md queue A item 3a (replay host fallbacks)"


class ReplayResult(NamedTuple):
    cache: dict        # converged plain-JSON state (crdt.c)
    snapshot: bytes    # compacted single-blob log
    n_ops: int         # unit items replayed
    path: str = "device"  # which engine converged


def decode(blobs: Sequence[bytes]) -> Dict:
    """Wire -> canonical columnar union (native C codec when built;
    duplicate ids from redelivered blobs are dropped, first wins)."""
    with get_tracer().span("decode"):
        return native.dedup_columns(
            native.decode_updates_columns_any(blobs)
        )


def stage(dec: Dict) -> Tuple[Dict[str, np.ndarray], DeleteSet]:
    """Kernel-facing columns + merged delete set."""
    return native.kernel_columns(dec), native.ds_from_triples(dec["ds"])


def converge(cols: Dict[str, np.ndarray], *, device="cuda"):
    """One union convergence on ``device``. Returns an opaque handle
    for :func:`gather`.

    The packed pipeline: stage on the host, one upload, one launch
    sequence, one fetch. Above ``EAGER_PUT_MIN_ROWS`` rows each staged
    section group starts its asynchronous upload as soon as its layout
    pass completes (``stage(put=...)``), hiding the transfer behind the
    remaining staging work."""
    dev = resolve_device(device)
    put = None
    if len(cols["client"]) >= staging.EAGER_PUT_MIN_ROWS:
        put = partial(xfer_put, device=dev)
    plan = staging.stage(cols, put=put)
    if plan is None:
        raise NotImplementedError(
            "union exceeds the packed stager's bounds; the resident "
            f"fallback is not ported yet ({_FALLBACK_ITEM})"
        )
    if plan.hard_rows:
        raise NotImplementedError(
            f"{len(plan.hard_rows)} sequence segment(s) need the scalar "
            f"YATA fallback, which is not ported yet ({_FALLBACK_ITEM})"
        )
    return ("packed", packed.converge(plan, device=dev))


def parent_spec(dec: Dict, row: int) -> Tuple:
    """("root", name) or ("item", client, clock) of a row's parent."""
    pr = dec["parent_root"][row]
    if pr >= 0:
        return ("root", dec["roots"][pr])
    return (
        "item",
        int(dec["parent_client"][row]),
        int(dec["parent_clock"][row]),
    )


def gather(dec: Dict, ds: DeleteSet, handle):
    """Winner rows + visibility + per-sequence document orders (keyed
    by parent spec — root name or item id) from a :func:`converge`
    handle. Right origins of sequence rows were ordered at staging
    (their exact conflict-scan ranks ride the client column)."""
    with get_tracer().span("gather"):
        win_rows, seq_orders = _assemble_packed(dec, handle[1])
        return finish_assembly(dec, ds, win_rows, seq_orders,
                               blanket_rights=False)


def finish_assembly(dec: Dict, ds: DeleteSet, win_rows, seq_orders,
                    *, blanket_rights: bool = True):
    """Shared assembly tail of every convergence engine (packed,
    fleet): the blanket right-origin detour, then the crafted-map-chain
    check and winner visibility.

    ``blanket_rights`` is for producers that ignore right origins
    entirely (the fleet round): the reference re-orders every parent
    with a right-bearing sequence row through its scalar host YATA,
    which is not ported yet, so such rows raise. The packed converge
    ordered its expressible rights at staging and passes False."""
    if blanket_rights:
        rc_col, kid_col = dec["right_client"], dec["key_id"]
        right_seq_rows = np.flatnonzero((rc_col >= 0) & (kid_col < 0))
        if len(right_seq_rows):
            raise NotImplementedError(
                f"{len(right_seq_rows)} sequence row(s) carry right "
                "origins, which this engine leaves to the scalar YATA "
                f"host detour, not ported yet ({_FALLBACK_ITEM})"
            )
    win_rows = _fix_map_chains_with_rights(dec, win_rows)
    win_vis = visible_mask(dec, win_rows, ds)
    return win_rows, win_vis, seq_orders


def segment_key(pa: np.ndarray, kid: np.ndarray) -> np.ndarray:
    """ONE packed (parent, key) segment identity: parents shifted past
    the 2^20 key space; the no-key sentinel occupies its own slot per
    parent."""
    pa = np.asarray(pa, np.int64)
    kid = np.asarray(kid, np.int64)
    return (pa << 21) | np.where(kid >= 0, kid, 1 << 20)


def segment_bound(cols: Dict[str, np.ndarray]) -> int:
    """Tight distinct-segment count for the convergence kernels:
    distinct (map parent, key) pairs + sequence parents."""
    if not len(np.asarray(cols["parent_a"])):
        return 1
    return len(np.unique(segment_key(cols["parent_a"], cols["key_id"])))


def _assemble_packed(dec: Dict, res):
    """Vectorized host assembly of the packed converge's one fetch:
    winner rows, and each sequence's rows in document order keyed by
    parent spec."""
    win_rows = res.win_rows[res.win_rows >= 0].tolist()
    m = res.stream_row >= 0
    rows, segs = res.stream_row[m], res.stream_seg[m]
    seq_orders: dict = {}
    if len(rows):
        cuts = np.r_[0, np.flatnonzero(segs[1:] != segs[:-1]) + 1, len(segs)]
        for a, b in zip(cuts[:-1], cuts[1:]):
            chunk = rows[a:b].tolist()
            # extend on recurrence, exactly as the reference assembles
            seq_orders.setdefault(parent_spec(dec, chunk[0]), []).extend(
                chunk
            )
    return win_rows, seq_orders


def _fix_map_chains_with_rights(dec: Dict, win_rows):
    """Crafted rights on MAP rows shift chain tails in ways the argmax
    kernel cannot express; the reference recomputes those chains'
    tails through the scalar chain order, which is not ported yet."""
    rc_col, kid_col = dec["right_client"], dec["key_id"]
    bad = np.flatnonzero((rc_col >= 0) & (kid_col >= 0))
    if len(bad):
        raise NotImplementedError(
            f"{len(bad)} map row(s) carry right origins; their chain "
            f"repair is not ported yet ({_FALLBACK_ITEM})"
        )
    return win_rows


def rows_visible(
    row_client: np.ndarray,
    row_clock: np.ndarray,
    del_c: np.ndarray,
    del_s: np.ndarray,
    del_e: np.ndarray,
) -> np.ndarray:
    """Vectorized tombstone test against delete RANGES — never
    expanded ids: a few delete-set bytes can legitimately declare
    ranges covering a whole GC'd history, so membership is an interval
    search. Ranges
    must be DISJOINT and sorted per client (DeleteSet.normalize's
    invariant). Clients remap densely before packing; the 41-bit clock
    field keeps the exclusive range end (up to the 1<<40 wire bound)
    out of the client bits."""
    if not len(del_c):
        return np.ones(len(row_client), bool)
    row_client = np.asarray(row_client, np.int64)
    del_c = np.asarray(del_c, np.int64)
    uniq = np.unique(np.concatenate([row_client, del_c]))
    qk = (
        np.searchsorted(uniq, row_client).astype(np.int64) << 41
    ) | np.asarray(row_clock, np.int64)
    dc = np.searchsorted(uniq, del_c).astype(np.int64) << 41
    starts = dc | np.asarray(del_s, np.int64)
    ends = dc | np.asarray(del_e, np.int64)
    order = np.argsort(starts)
    starts, ends = starts[order], ends[order]
    pos = np.searchsorted(starts, qk, side="right") - 1
    posc = np.clip(pos, 0, len(starts) - 1)
    return ~((pos >= 0) & (qk < ends[posc]))


def visible_mask(dec: Dict, rows: List[int], ds: DeleteSet) -> List[bool]:
    """Tombstone visibility for specific rows (vectorized)."""
    if not rows:
        return []
    idx = np.asarray(rows)
    trip = list(ds.iter_all())  # normalized: disjoint, client-sorted
    del_c = np.asarray([c for c, _, _ in trip], np.int64)
    del_s = np.asarray([s for _, s, _ in trip], np.int64)
    del_e = np.asarray([s + n for _, s, n in trip], np.int64)
    return list(rows_visible(
        dec["client"][idx], dec["clock"][idx], del_c, del_s, del_e
    ))


def materialize(dec: Dict, ds: DeleteSet, win_rows, win_vis,
                seq_orders) -> dict:
    """Winner rows + sequence orders -> the plain-JSON cache, with
    tombstoned sequence members dropped (the engine's visible walk).
    Nested collections (a Y.Array/Y.Map stored under a map key or a
    sequence slot) materialize recursively through their type items."""
    cache, ix_group = assemble_cache(
        dec, ds, win_rows, win_vis, seq_orders
    )
    finish_cache(cache, dec, ix_group)
    return cache


def assemble_cache(dec: Dict, ds: DeleteSet, win_rows, win_vis,
                   seq_orders) -> Tuple[dict, Dict[str, int]]:
    """The per-subset half of :func:`materialize`: builds the cache
    entries for exactly the root specs present in ``win_rows`` /
    ``seq_orders``; the returned ``ix_group`` is the subset's slice of
    the reserved ``ix`` index root, consumed by :func:`finish_cache`."""
    with get_tracer().span("materialize"):
        return _assemble_cache(dec, ds, win_rows, win_vis, seq_orders)


def _assemble_cache(dec: Dict, ds: DeleteSet, win_rows, win_vis,
                    seq_orders) -> Tuple[dict, Dict[str, int]]:
    keys = dec["keys"]
    kid = dec["key_id"]
    client, clock = dec["client"], dec["clock"]
    kind_col, tref = dec["kind"], dec["type_ref"]
    contents = dec["contents"]

    # vectorized tombstone test for every sequence row at once (the
    # per-row ds.contains walk was ~half of materialize at 100k ops)
    all_seq_rows = sorted(
        {int(r) for rows in seq_orders.values() for r in rows}
    )
    seq_vis = dict(
        zip(all_seq_rows, visible_mask(dec, all_seq_rows, ds))
    )

    # visible map winners grouped by their parent spec
    map_groups: Dict[Tuple, Dict[str, int]] = {}
    for row, vis in zip(win_rows, win_vis):
        if not vis:
            continue
        map_groups.setdefault(parent_spec(dec, row), {})[
            keys[kid[row]]
        ] = row

    def value_of(row: int, depth: int):
        if kind_col[row] == K_TYPE:
            spec = ("item", int(client[row]), int(clock[row]))
            is_map = tref[row] == TYPE_MAP
            return collection(spec, is_map, depth + 1)
        return contents[row]

    def collection(spec: Tuple, is_map: bool, depth: int):
        if depth > 64:
            return None  # malformed cyclic nesting: cut, don't recurse
        if is_map:
            return {
                k: value_of(r, depth)
                for k, r in map_groups.get(spec, {}).items()
            }
        return [
            value_of(r, depth)
            for r in seq_orders.get(spec, ())
            if seq_vis[int(r)]
        ]

    cache: dict = {}
    for spec in map_groups:
        # the reserved collection-kind index stays internal, exactly
        # as the document API's `c` hides it
        if spec[0] == "root" and spec[1] != "ix":
            cache[spec[1]] = collection(spec, True, 0)
    for spec in seq_orders:
        if spec[0] == "root" and spec[1] not in cache:
            cache[spec[1]] = collection(spec, False, 0)
    return cache, map_groups.get(("root", "ix"), {})


def finish_cache(cache: dict, dec: Dict,
                 ix_group: Dict[str, int]) -> dict:
    """The cross-subset tail of :func:`materialize`: roots registered
    in the ix index but with no visible content (e.g. a map whose
    every key was tombstoned) still materialize — empty — exactly
    like the document cache. Runs once, after every subset's
    :func:`assemble_cache` part has merged into ``cache``."""
    contents = dec["contents"]
    for name, row in ix_group.items():
        if name not in cache and name != "ix":
            cache[name] = [] if contents[row] == "array" else {}
    return cache


def compact(dec: Dict, ds: DeleteSet) -> bytes:
    """Snapshot compaction: the whole replayed union as one blob."""
    with get_tracer().span("compact"):
        return native.encode_from_columns_any(dec, ds)


# the reference's other routes and the ROADMAP.md items that port them
_UNPORTED_ROUTES = {
    "host": "queue A item 3a (replay host fallbacks)",
    "auto": "queue A item 5 (incremental engine)",
    "replica": "queue A item 5 (incremental engine)",
    "stream": "queue A item 4 (streaming executor)",
}


def replay_trace(blobs: Sequence[bytes], *, route: str = "device",
                 device="cuda") -> ReplayResult:
    """One-shot: blobs in, converged cache + compacted snapshot out,
    converged on ``device`` (the card unless the caller asks for the
    CPU; with no card present a CUDA request raises).

    ``route`` picks the convergence engine: ``"device"`` (default) the
    packed one-dispatch converge of the whole union; ``"fleet"`` treats
    each blob as one replica's pending broadcast and converges the set
    as ONE gossip + merge round
    (:func:`crdt_tpu_torch.models.fleet.fleet_replay`). The reference's
    other routes raise ``NotImplementedError`` naming their ROADMAP.md
    item."""
    if route in _UNPORTED_ROUTES:
        raise NotImplementedError(
            f"route={route!r} is not ported yet "
            f"(ROADMAP.md {_UNPORTED_ROUTES[route]})"
        )
    if route == "fleet":
        from crdt_tpu_torch.models.fleet import fleet_replay

        return fleet_replay(blobs, device=device)
    if route != "device":
        raise ValueError(f"unknown route {route!r}")
    dev = resolve_device(device)
    dec = decode(blobs)
    cols, ds = stage(dec)
    handle = converge(cols, device=dev)
    win_rows, win_vis, seq_orders = gather(dec, ds, handle)
    cache = materialize(dec, ds, win_rows, win_vis, seq_orders)
    return ReplayResult(
        cache=cache, snapshot=compact(dec, ds), n_ops=len(dec["client"]),
        path="device",
    )
