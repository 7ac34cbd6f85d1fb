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
(:mod:`crdt_tpu_torch.models.fleet`), with steps 4 and 5 shared;
``route="stream"`` runs the same computation as a chunked,
double-buffered pipeline (:mod:`crdt_tpu_torch.models.streaming`);
``route="host"`` runs the device route's converge on the CPU;
``route="replica"`` ingests the union through the live replica's engine
(:mod:`crdt_tpu_torch.models.incremental`) on its host path; and
``route="auto"`` picks the host or the device route by the live
replica's crossover.

Shapes the packed kernels cannot express take the scalar host
machinery (:mod:`crdt_tpu_torch.ops.yata`, through
:class:`crdt_tpu_torch.core.engine.Engine`) at gather time: segments
the stager marks hard, map rows that carry right origins, and (on the
fleet route, whose kernels ignore right origins) every parent with a
right-bearing sequence row.

Cache and snapshot are byte-identical to the reference's on the same
blobs (tests/test_torch_replay.py, tests/test_torch_fleet.py,
tests/test_torch_streaming.py). A union the packed stager cannot
express raises ``NotImplementedError`` naming its ROADMAP.md item
instead of giving a wrong answer.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from crdt_tpu_torch.codec import native
from crdt_tpu_torch.core.ids import DeleteSet
from crdt_tpu_torch.core.records import ItemRecord
from crdt_tpu_torch.core.store import K_GC, K_TYPE, TYPE_MAP
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops import packed, staging
from crdt_tpu_torch.ops.device import resolve_device, xfer_put
from crdt_tpu_torch.ops.yata import order_hard_segment, order_sequences

# where the missing fallback for unstageable unions is queued
_UNSTAGEABLE_ITEM = "ROADMAP.md queue A item 7 (ResidentColumns)"


def unstageable_union() -> NotImplementedError:
    """The error every route raises for a union past the packed
    stager's bounds (the reference's resident fallback)."""
    return NotImplementedError(
        "union exceeds the packed stager's bounds; the resident "
        f"fallback is not ported yet ({_UNSTAGEABLE_ITEM})"
    )


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
        raise unstageable_union()
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


def gather(dec: Dict, ds: DeleteSet, handle, *, device):
    """Winner rows + visibility + per-sequence document orders (keyed
    by parent spec — root name or item id) from a :func:`converge`
    handle.

    Right origins: the packed path orders attachment groups at staging
    (the exact conflict-scan ranks ride the client column), so only
    segments carrying shapes the sibling-rank model cannot express (the
    plan's ``hard_rows``) re-order on the host, ranking on ``device``."""
    with get_tracer().span("gather"):
        win_rows, seq_orders = _assemble_packed(dec, handle[1])
        hard = handle[1].hard_rows
        if hard:
            affected = {parent_spec(dec, int(r)) for r in hard}
            seq_orders.update(_host_seq_orders(dec, affected, device=device))
        return finish_assembly(dec, ds, win_rows, seq_orders,
                               device=device, blanket_rights=False)


def finish_assembly(dec: Dict, ds: DeleteSet, win_rows, seq_orders, *,
                    device, blanket_rights: bool = True):
    """Shared assembly tail of every convergence engine (packed,
    fleet): the blanket right-origin host detour — applied when the
    producing kernels ignore rights entirely (the fleet round), skipped
    when the producer already ordered its expressible rights at
    staging — then crafted-map-chain repair and winner visibility. One
    implementation, so a right-origin fix reaches every route."""
    if blanket_rights:
        rc_col, kid_col = dec["right_client"], dec["key_id"]
        right_seq_rows = np.flatnonzero((rc_col >= 0) & (kid_col < 0))
        if len(right_seq_rows):
            affected = {parent_spec(dec, int(r)) for r in right_seq_rows}
            seq_orders.update(_host_seq_orders(dec, affected, device=device))
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


def _assemble_packed(dec: Dict, res, row_map=None):
    """Vectorized host assembly of the packed kernel's one fetch.
    ``row_map`` translates the result's row space into ``dec``'s (the
    streaming executor stages each chunk's rows separately, so its
    results come back chunk-local); None means they already agree."""
    win = res.win_rows[res.win_rows >= 0]
    m = res.stream_row >= 0
    rows, segs = res.stream_row[m], res.stream_seg[m]
    if row_map is not None:
        win = row_map[win]
        rows = row_map[rows]
    win_rows = win.tolist()
    seq_orders: dict = {}
    if len(rows):
        cuts = np.r_[0, np.flatnonzero(segs[1:] != segs[:-1]) + 1, len(segs)]
        for a, b in zip(cuts[:-1], cuts[1:]):
            chunk = rows[a:b].tolist()
            spec = parent_spec(dec, chunk[0])
            # extend on recurrence: a split list's pieces come back
            # as separate runs in exact piece order, so appending
            # reproduces the unsplit stream bit-for-bit
            if spec in seq_orders:
                seq_orders[spec].extend(chunk)
            else:
                seq_orders[spec] = chunk
    return win_rows, seq_orders


def _host_seq_orders(dec: Dict, specs_needed: set, *, device):
    """Exact sequence orders for the given parent specs via the host
    machinery (right origins, attachment groups, hostile shapes).

    The subset keeps full-union semantics: every id referenced from the
    subset but living OUTSIDE it (GC fillers, foreign parents' rows)
    joins as a GC stub — the ordering machinery then drops/hardens
    those references exactly as it would with the whole union in hand,
    while truly dangling references stay absent (members pend). The
    ranking runs on ``device``."""
    kid_col, kind_col = dec["key_id"], dec["kind"]
    n = len(kid_col)
    rows = [
        i for i in range(n)
        if kid_col[i] < 0 and kind_col[i] != K_GC
        and parent_spec(dec, i) in specs_needed
    ]
    records, _ = native.decoded_to_records(dec, rows)
    sub_ids = {r.id for r in records}
    id_row = {
        (int(dec["client"][i]), int(dec["clock"][i])): i for i in range(n)
    }
    stubs = {
        ref
        for r in records
        for ref in (r.origin, r.right)
        if ref is not None and ref not in sub_ids and ref in id_row
    }
    records += [
        ItemRecord(client=c, clock=k, kind=K_GC) for c, k in stubs
    ]
    return {
        spec: [id_row[i] for i in ids]
        for spec, ids in order_sequences(records, device=device).items()
        if spec in specs_needed
    }


def _fix_map_chains_with_rights(dec: Dict, win_rows, bad_rows=None,
                                chain_rows=None, union_ids=None):
    """Crafted rights on MAP rows shift chain tails in ways the argmax
    kernel cannot express; recompute exactly those chains' tails via
    the scalar chain order. The optional subsets are the streaming
    executor's seams: ``bad_rows`` restricts the repair to a chunk's
    right-bearing map rows (so one chunk never emits another chunk's
    tails), ``chain_rows`` restricts the chain-membership scan to the
    chunk's rows (sound because segments never split across chunks),
    and ``union_ids`` shares one precomputed whole-union id set across
    chunks instead of rebuilding it per call. Defaults scan the whole
    union."""
    rc_col, kid_col = dec["right_client"], dec["key_id"]
    if bad_rows is None:
        bad = np.flatnonzero((rc_col >= 0) & (kid_col >= 0))
    else:
        bad = np.asarray(bad_rows, np.int64)
    if not len(bad):
        return win_rows
    affected = {(parent_spec(dec, int(r)), int(kid_col[r])) for r in bad}
    chains: Dict[Tuple, List[int]] = {}
    for i in (range(len(kid_col)) if chain_rows is None else chain_rows):
        i = int(i)
        if kid_col[i] >= 0:
            key = (parent_spec(dec, i), int(kid_col[i]))
            if key in affected:
                chains.setdefault(key, []).append(i)
    id_row = {
        (int(dec["client"][i]), int(dec["clock"][i])): i
        for rows in chains.values()
        for i in rows
    }
    if union_ids is None:
        union_ids = {
            (int(dec["client"][i]), int(dec["clock"][i]))
            for i in range(len(kid_col))
        }
    patched = dict.fromkeys(affected)
    for key, rows in chains.items():
        recs = [
            ItemRecord(
                client=int(dec["client"][i]), clock=int(dec["clock"][i]),
                origin=(
                    (int(dec["origin_client"][i]),
                     int(dec["origin_clock"][i]))
                    if dec["origin_client"][i] >= 0 else None
                ),
                right=(
                    (int(dec["right_client"][i]),
                     int(dec["right_clock"][i]))
                    if dec["right_client"][i] >= 0 else None
                ),
                parent_root="x",  # chain order ignores parent identity
            )
            for i in rows
        ]
        ordered = order_hard_segment(
            recs, ref_exists=lambda ref: ref in union_ids
        )
        patched[key] = id_row[ordered[-1]] if ordered else None
    out = []
    for row in win_rows:
        key = (parent_spec(dec, row), int(kid_col[row]))
        if key in affected:
            continue  # replaced by the exact tail below
        out.append(row)
    out.extend(r for r in patched.values() if r is not None)
    return out


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


def replay_trace(blobs: Sequence[bytes], *, route: str = "device",
                 device="cuda") -> ReplayResult:
    """One-shot: blobs in, converged cache + compacted snapshot out,
    converged on ``device`` (the card unless the caller asks for the
    CPU; with no card present a CUDA request raises).

    ``route`` picks the convergence engine:

    - ``"device"`` (default): the packed one-dispatch converge of the
      whole union;
    - ``"stream"``: the same converge as a chunked, double-buffered
      pipeline, one converge per shard of whole root subtrees
      (:func:`crdt_tpu_torch.models.streaming.stream_replay`);
    - ``"fleet"``: each blob is one replica's pending broadcast and the
      set converges as ONE gossip + merge round
      (:func:`crdt_tpu_torch.models.fleet.fleet_replay`);
    - ``"host"``: the device route's converge with wide staging, run on
      the CPU whatever ``device`` says (naming the route is how the
      caller asks for the host); it launches nothing on the card and
      its ``path`` is ``"host"``. A union the packed stager cannot
      express goes to the live replica's engine instead (``path``
      ``"replica"``);
    - ``"auto"``: the live replica's host/device crossover
      (:meth:`IncrementalReplay.crossover_use_host` on ``device``):
      below it the ``"host"`` route, above it the ``"device"`` route;
    - ``"replica"``: ingest through
      :class:`crdt_tpu_torch.models.incremental.IncrementalReplay`
      pinned to its host path — the code a live replica runs on this
      backlog, with zero device work."""
    if route == "fleet":
        from crdt_tpu_torch.models.fleet import fleet_replay

        return fleet_replay(blobs, device=device)
    if route == "stream":
        from crdt_tpu_torch.models.streaming import stream_replay

        return stream_replay(blobs, device=device)
    if route not in ("device", "host", "auto", "replica"):
        raise ValueError(f"unknown route {route!r}")
    if route == "host":
        return _replay_host(decode(blobs))
    dev = resolve_device(device)
    dec = decode(blobs)
    if route == "replica":
        return _replay_replica(dec, dev)
    if route == "auto":
        from crdt_tpu_torch.models.incremental import IncrementalReplay

        # the live replica's exact rule (one shared implementation:
        # static floor first, the probe of this device beyond it)
        route = ("host" if IncrementalReplay.crossover_use_host(
            len(dec["client"]), dev) else "device")
    if route == "host":
        return _replay_host(dec)
    cols, ds = stage(dec)
    return _finish(dec, ds, converge(cols, device=dev), dev, "device")


def _replay_host(dec: Dict) -> ReplayResult:
    """``route="host"``: the packed converge on the CPU. Wide staging:
    nothing crosses a link, so the narrow encode and its widening
    prelude would be pure overhead. A plan the stager cannot express
    goes to the replica engine."""
    cpu = resolve_device("cpu")
    cols, ds = stage(dec)
    plan = staging.stage(cols, wide=True)
    if plan is None:
        return _replay_replica(dec, cpu)
    handle = ("packed", packed.converge(plan, device=cpu))
    return _finish(dec, ds, handle, cpu, "host")


def _replay_replica(dec: Dict, device) -> ReplayResult:
    """``route="replica"``: the decoded union through a live replica's
    engine pinned to its host path. Minimal capacity: the resident
    device matrix is never allocated on this route."""
    from crdt_tpu_torch.models.incremental import IncrementalReplay

    inc = IncrementalReplay(capacity=1 << 10, device_min_rows=1 << 62,
                            device=device)
    inc.apply_decoded(dec)  # decoded once, never twice
    ds = native.ds_from_triples(dec["ds"])
    return ReplayResult(
        cache=dict(inc.cache), snapshot=compact(dec, ds),
        n_ops=len(dec["client"]), path="replica",
    )


def _finish(dec: Dict, ds: DeleteSet, handle, device,
            path: str) -> ReplayResult:
    """Gather, materialize and compact one converged union."""
    win_rows, win_vis, seq_orders = gather(dec, ds, handle, device=device)
    cache = materialize(dec, ds, win_rows, win_vis, seq_orders)
    return ReplayResult(
        cache=cache, snapshot=compact(dec, ds), n_ops=len(dec["client"]),
        path=path,
    )
