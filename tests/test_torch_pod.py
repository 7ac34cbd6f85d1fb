"""The port's multi-process pod, on the CPU.

Each mesh route of the port runs SPMD across the processes of a
``torch.distributed`` ``gloo`` group: ``make_mesh``'s global rank-major
entries and ``local_entries``, ``make_mesh2d``'s one-process-a-row rule,
the collectives, the sharded converge, ``replay_trace``'s sharded branch,
the stream route's sharded shards, ``fleet_replay(shard="sharded" |
"segments")``, ``ReplicaFleet`` on a 1D and a 2 x 2 pod mesh, the ring
delta and ``MultiDocServer(shards=4)`` tick by tick.

One 4-process group and one 2-process group are spawned once for the
module (``file://`` init under a temp directory, every join under a
deadline). Every rank runs each case once, in the same order, and
writes its results; each test reads them. Every rank must equal every
other and the single-controller port on a ``cpu`` mesh of the same
size (the same case run in this process, which has no group), and on
the small trace the reference on the tests' eight virtual devices.
Everything is integer: equality is exact.

The ranks import only ``torch``, ``numpy`` and ``crdt_tpu_torch`` (this
module's top level); the reference is imported inside the tests.
"""

import datetime
import multiprocessing
import os
import pickle
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed

from crdt_tpu_torch.models import fleet, streaming, traces
from crdt_tpu_torch.models import replay as rp
from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.obs import Tracer, set_tracer
from crdt_tpu_torch.ops import deleteset, packed, shard, statevec
from crdt_tpu_torch.parallel import delta, gossip
from crdt_tpu_torch.parallel import mesh as mesh_mod

# a group's deadline from spawn to the last rank's exit, and the
# group's own collective timeout: a rank that dies fails its group in
# seconds, not at the tier-1 clock
JOIN_S = 240
GROUP_TIMEOUT_S = 60
CPU = torch.device("cpu")


@contextmanager
def _env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextmanager
def _calls(counts: dict, *sites):
    """Count the calls of each (module, wrapper) in ``sites``."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]

    def counting(name, fn):
        def call(*args):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextmanager
def _traced():
    tracer = set_tracer(Tracer(enabled=True))
    try:
        yield tracer
    finally:
        set_tracer(Tracer(enabled=False))


def _np(t):
    return None if t is None else t.cpu().numpy()


def _result(res) -> tuple:
    return res.cache, res.snapshot, res.path, res.n_ops


PK_SITES = ((packed, "seg_argmax_scan"), (packed, "stream_scatter"))
FL_SITES = ((deleteset, "ds_mask"), (statevec, "sv_deficit"))


# ---------------------------------------------------------------------------
# the cases: SPMD programs every rank runs alike (and this process runs
# with no group, as the single-controller port)
# ---------------------------------------------------------------------------


def case_layout(inp, world):
    out = {}
    m8 = mesh_mod.make_mesh(8, device="cpu")
    m2d = mesh_mod.make_mesh2d(world, 4 // world, device="cpu")
    for name, m in (("m8", m8), ("m2d", m2d)):
        out[name] = ([str(e) for e in mesh_mod.entries(m)], m.devices.shape,
                     m.axis_names,
                     [(k, str(d)) for k, d in mesh_mod.local_entries(m)],
                     mesh_mod.is_pod(m))
    out["pod"] = m8.pod
    out["default"] = mesh_mod.make_mesh(device="cpu").devices.size
    out["shard_count"] = shard.shard_count(device="cpu")
    errors = {}
    for name, make in (("make_mesh(6)", lambda: mesh_mod.make_mesh(
            6, device="cpu")),
            ("make_mesh2d(1, 4)", lambda: mesh_mod.make_mesh2d(
                1, 4, device="cpu")),
            ("make_mesh2d(2W, 1)", lambda: mesh_mod.make_mesh2d(
                2 * world, 1, device="cpu"))):
        try:
            make()
            errors[name] = None
        except ValueError as exc:
            errors[name] = str(exc)
    out["errors"] = errors
    return out


def _local_parts(m, make):
    local = dict(mesh_mod.local_entries(m))
    return [make(k).to(local[k]) if k in local else None
            for k in range(m.devices.size)]


def case_collectives(inp, world):
    rank = torch.distributed.get_rank() if world > 1 and \
        torch.distributed.is_initialized() else 0
    m8 = mesh_mod.make_mesh(8, device="cpu")
    m2d = mesh_mod.make_mesh2d(world, 8 // world, device="cpu")
    home = mesh_mod.home(m8)
    out = {}
    for dtype in (torch.int64, torch.int16, torch.bool):
        def make(k):
            return (torch.arange(6).reshape(2, 3) * 10 + k).to(dtype)
        parts = _local_parts(m8, make)
        out[f"all_gather {dtype}"] = _np(mesh_mod.all_gather(parts, home,
                                                             m8))
        out[f"all_gather2 {dtype}"] = _np(mesh_mod.all_gather2(
            _local_parts(m2d, make), m2d))
        for pname, perm in (("ring", [(i, (i + 1) % 8) for i in range(8)]),
                            ("back", [(i, (i - 1) % 8) for i in range(8)]),
                            ("one pair", [(0, 1)]),
                            ("mixed", [(0, 7), (3, 2), (5, 5), (6, 1)]),
                            ("none", [])):
            got = mesh_mod.ppermute(parts, perm, m8)
            out[f"ppermute {pname} {dtype}"] = [_np(g) for g in got]
        # every rank passes its own tensor; the first entry's rank's wins
        got = mesh_mod.broadcast((torch.arange(5) + 100 * rank).to(dtype),
                                 m8)
        out[f"broadcast {dtype}"] = [_np(g) for g in got]
    return out


def case_shard(inp, world):
    out = {}
    for name in ("small", "few"):
        dec = rp.decode(inp[name])
        cols, _ = rp.stage(dec)
        for K in (4, 8):
            counts: dict = {}
            with _traced() as tr, _calls(counts, *PK_SITES):
                splan = shard.stage(cols, n_shards=K, device="cpu")
                res = shard.converge(splan, device="cpu")
            c = tr.counters()
            out[(name, K)] = {
                "result": res._asdict(),
                "calls": counts,
                "mat_bytes": c.get("xfer.h2d_bytes_by{path=\"shard.mat\"}",
                                   0),
                "wire_bytes": c.get(
                    "xfer.h2d_bytes_by{path=\"shard.wire\"}", 0),
                "row_bytes": int(splan.block[0].nbytes),
                "wire_row_bytes": int(splan.wire[0].nbytes),
                "dispatches": c.get("shard.dispatches", 0),
                "empty_shards": sum(not len(r) for r in splan.row_maps),
            }
    return out


def case_replay(inp, world):
    with _env(CRDT_TPU_SHARDS=4, CRDT_TPU_SHARD_MIN_ROWS=1), \
            _traced() as tr:
        res = rp.replay_trace(inp["small"], device="cpu")
    return _result(res), tr.counters().get("shard.dispatches", 0)


def case_stream(inp, world):
    with _env(CRDT_TPU_SHARDS=2, CRDT_TPU_SHARD_MIN_ROWS=1), \
            _traced() as tr:
        res = streaming.stream_replay(inp["small"], device="cpu",
                                      chunk_blobs=7, max_shards=3,
                                      min_shard_rows=1)
    return _result(res), tr.counters().get("shard.dispatches", 0)


def case_fleet_replay(inp, world):
    out = {}
    for mode in ("sharded", "segments"):
        counts: dict = {}
        with _calls(counts, *FL_SITES):
            res = fleet.fleet_replay(
                inp["small"], mesh=gossip.make_mesh(4, device="cpu"),
                shard=mode)
        out[mode] = _result(res), counts
    return out


def case_replica_fleet(inp, world):
    cols, dels = inp["fleet_cols"]
    out = {}
    for name, m in (("1d", mesh_mod.make_mesh(4, device="cpu")),
                    ("2d", mesh_mod.make_mesh2d(world, 4 // world,
                                                device="cpu"))):
        counts: dict = {}
        fl = fleet.ReplicaFleet(16, 24, mesh=m, num_segments=256)
        with _calls(counts, *FL_SITES):
            step = fl.step(cols, dels)
        out[name] = step._asdict(), counts
    return out


def case_ring(inp, world):
    rcols = delta.synth_resident_columns(8, 96, 8, seed=0)
    m = mesh_mod.make_mesh(8, device="cpu")
    out = {}
    for budget in (4, 16):
        parts = [_local_parts(m, lambda k, c=c: torch.from_numpy(
            np.ascontiguousarray(rcols[c][k:k + 1])))
            for c in delta.COL_NAMES]
        got = delta.make_ring_delta_step(m, 10, budget)(*parts)
        out[budget] = [_np(g) for g in got]
    return out


def case_multidoc(inp, world):
    ticks = []
    with _env(CRDT_TPU_DEVICE_MIN=1, CRDT_TPU_SHARD_MIN_ROWS=1):
        srv = MultiDocServer(delta_ticks=True, pool=True, shards=4,
                             device="cpu")
        for blobs_of in inp["mt_rounds"]:
            for d, blobs in blobs_of.items():
                srv.submit_many(d, blobs)
            with _traced() as tr:
                rep = srv.tick()
            ticks.append((tuple(rep),
                          {d: srv.digest(d) for d in blobs_of},
                          tr.counters().get("shard.dispatches", 0)))
    return ticks


def case_divergence(inp, world):
    """Rank 1 calls a gather of another size, then stages another
    plan: every rank raises, and the group stays usable."""
    rank = torch.distributed.get_rank()
    m = mesh_mod.make_mesh(world, device="cpu")
    out = {}
    parts = _local_parts(m, lambda k: torch.zeros(3 if rank == 1 else 2))
    try:
        mesh_mod.all_gather(parts, CPU, m)
        out["order"] = None
    except RuntimeError as exc:
        out["order"] = str(exc)
    dec = rp.decode(inp["small"])
    cols, _ = rp.stage(dec)
    if rank == 1:
        cols = dict(cols)
        cols["valid"] = np.asarray(cols["valid"]).copy()
        cols["valid"][0] = False
    splan = shard.stage(cols, n_shards=world, device="cpu")
    try:
        shard.converge(splan, device="cpu")
        out["plan"] = None
    except RuntimeError as exc:
        out["plan"] = str(exc)
    # the group still gathers after both refusals
    out["after"] = _np(mesh_mod.all_gather(
        _local_parts(m, lambda k: torch.full((1,), k)), CPU, m))
    return out


CASES = {f.__name__[5:]: f for f in (
    case_layout, case_collectives, case_shard, case_replay, case_stream,
    case_fleet_replay, case_replica_fleet, case_ring, case_multidoc,
    case_divergence)}
GROUPS = {
    4: ("layout", "collectives", "shard", "replay", "fleet_replay",
        "replica_fleet", "ring", "multidoc", "divergence"),
    2: ("layout", "collectives", "shard", "stream", "replica_fleet",
        "ring"),
}


def _rank_main(rank: int, world: int, workdir: str) -> None:
    """One rank of a group: join it, run the group's cases in order,
    write every result (or the first error) to ``rank<r>.pkl``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    work = Path(workdir)
    results: dict = {"times": {}}
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{work / 'init'}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        inputs = pickle.loads((work / "inputs.pkl").read_bytes())
        for name in GROUPS[world]:
            t0 = time.perf_counter()
            results[name] = CASES[name](inputs, world)
            results["times"][name] = time.perf_counter() - t0
        dist.destroy_process_group()
    except Exception:  # the result file carries it to the test
        results["error"] = traceback.format_exc()
    tmp = work / f"rank{rank}.tmp"
    tmp.write_bytes(pickle.dumps(results))
    tmp.rename(work / f"rank{rank}.pkl")


def _spawn_group(world: int, workdir: Path, inputs: dict) -> list:
    (workdir / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(workdir)),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    out = []
    for r, p in enumerate(procs):
        path = workdir / f"rank{r}.pkl"
        if path.exists():
            out.append(pickle.loads(path.read_bytes()))
        else:
            out.append({"error": f"rank {r} wrote no result (exit code "
                                 f"{p.exitcode}; deadline {JOIN_S} s)"})
    return out


def _inputs() -> dict:
    from crdt_tpu.parallel import gossip as ref_gossip
    from tests.test_multidoc import doc_blobs
    from tests.test_pooled import delta_blobs
    from tests.test_torch_shard import _few_segments_blobs

    R, N = 16, 24
    cols, dels = ref_gossip.synth_columns(R, N, num_maps=2, keys_per_map=8,
                                          num_lists=2, seed=21)
    rng = np.random.default_rng(21)
    cols["valid"] &= rng.random((R, N)) < 0.9
    dels = (np.r_[[2, 3, 5], dels[0][3:]].astype(np.int32),
            np.r_[[0, 4, 10], dels[1][3:]].astype(np.int64),
            np.r_[[5, 9, 30], dels[2][3:]].astype(np.int64))
    doc_sets = {i: doc_blobs(i, K=16, rights=(i % 2 == 1), deletes=True)
                for i in range(5)}
    return {
        "small": traces.build_trace(40, 60, seed=0),
        "few": _few_segments_blobs(),
        "fleet_cols": (cols, dels),
        "mt_rounds": [doc_sets] + [
            {i: delta_blobs(i, 16 + 6 * r) for i in doc_sets}
            for r in range(2)],
    }


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def pods(inputs, tmp_path_factory):
    """Both groups' per-rank results, spawned once for the module."""
    return {w: _spawn_group(w, tmp_path_factory.mktemp(f"pod{w}"), inputs)
            for w in GROUPS}


@pytest.fixture(scope="module")
def single(inputs):
    """Each case on the single-controller port (this process has no
    group), for each group's size."""
    memo: dict = {}

    def get(name: str, world: int):
        if (name, world) not in memo:
            memo[name, world] = CASES[name](inputs, world)
        return memo[name, world]

    return get


def _ranks(pods, world: int, case: str) -> list:
    out = []
    for r, res in enumerate(pods[world]):
        if case not in res:
            pytest.fail(f"rank {r} of the {world}-process group did not run "
                        f"{case!r}: {res.get('error')}")
        out.append(res[case])
    return out


def _eq(a, b, what="") -> None:
    """Exact, recursive equality of results (arrays by dtype, shape and
    value)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b), what
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _eq(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def _replicated(pods, single, world: int, case: str):
    """Every rank's result equals every other's and the single
    controller's; returns it."""
    got = _ranks(pods, world, case)
    want = single(case, world)
    for r, g in enumerate(got):
        _eq(g, want, f"{case}, rank {r} of {world}")
    return want


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_mesh_entries_and_local_entries(pods, world):
    for rank, lay in enumerate(_ranks(pods, world, "layout")):
        per = 8 // world
        ents, shape, axes, local, is_pod = lay["m8"]
        assert shape == (8,) and axes == ("replicas",) and is_pod
        assert ents == ["cpu" if k // per == rank else f"rank{k // per}:cpu"
                        for k in range(8)]
        assert local == [(k, "cpu") for k in range(rank * per,
                                                   (rank + 1) * per)]
        assert lay["pod"] == mesh_mod.Pod(rank, world, "gloo", per)
        ents, shape, axes, local, _ = lay["m2d"]
        assert shape == (world, 4 // world)
        assert axes == ("hosts", "replicas")
        row = 4 // world
        assert [k for k, _ in local] == list(range(rank * row,
                                                   (rank + 1) * row))
        # one entry a process: the counterpart of len(jax.devices())
        assert lay["default"] == lay["shard_count"] == world


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_mesh_rules(pods, world):
    for lay in _ranks(pods, world, "layout"):
        err = lay["errors"]
        if world == 4:
            assert "does not divide over 4 processes" in err["make_mesh(6)"]
        else:
            assert err["make_mesh(6)"] is None
        for name in ("make_mesh2d(1, 4)", "make_mesh2d(2W, 1)"):
            assert "must equal process_count()" in err[name]
            assert "one process's" in err[name]


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_collectives_match_single_controller(pods, single, world):
    want = single("collectives", world)
    got = _ranks(pods, world, "collectives")
    per = 8 // world
    for name, w in want.items():
        for rank, g in enumerate(got):
            if name.startswith("all_gather"):
                _eq(g[name], w, f"{name}, rank {rank}")
                continue
            # a per-entry result: each rank holds its own entries only
            for k, (x, y) in enumerate(zip(g[name], w)):
                if k // per == rank:
                    _eq(x, y, f"{name}, entry {k}, rank {rank}")
                else:
                    assert x is None, (name, k, rank)
    # an entry no pair sends to receives zeros, as jax's ppermute
    one = want["ppermute one pair torch.int64"]
    assert not any(one[k].any() for k in range(8) if k != 1)
    assert (want["broadcast torch.int64"][3] == np.arange(5)).all()


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_shard_result_matches_single_controller(pods, single, world):
    want = single("shard", world)
    got = _ranks(pods, world, "shard")
    for key, w in want.items():
        name, K = key
        for rank, g in enumerate(got):
            _eq(g[key]["result"], w["result"], f"{key}, rank {rank}")
            assert g[key]["dispatches"] == 1
        if (name, K) == ("few", 8):
            assert w["empty_shards"] > 0, "no rank had an empty shard"


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_each_rank_uploads_and_launches_its_own(pods, single, world):
    for key, w in single("shard", world).items():
        K = key[1]
        assert w["calls"] == {"seg_argmax_scan": K, "stream_scatter": K}
        assert w["mat_bytes"] == K * w["row_bytes"]
        for rank, g in enumerate(_ranks(pods, world, "shard")):
            g = g[key]
            assert g["calls"] == {"seg_argmax_scan": K // world,
                                  "stream_scatter": K // world}, (key, rank)
            assert g["mat_bytes"] == K // world * g["row_bytes"]
            assert g["wire_bytes"] == K // world * g["wire_row_bytes"]


def test_replay_trace_sharded_over_the_pod(pods, single):
    from crdt_tpu.models import replay as ref_rp

    (res, dispatches) = _replicated(pods, single, 4, "replay")
    want = ref_rp.replay_trace(traces.build_trace(40, 60, seed=0))
    cache, snapshot, path, _ = res
    assert dispatches == 1
    assert cache == want.cache and snapshot == want.snapshot


def test_stream_route_sharded_over_the_pod(pods, single):
    from crdt_tpu.models import replay as ref_rp

    (res, dispatches) = _replicated(pods, single, 2, "stream")
    cache, snapshot, path, _ = res
    want = ref_rp.replay_trace(traces.build_trace(40, 60, seed=0))
    assert path == "stream" and dispatches >= 2
    assert cache == want.cache and snapshot == want.snapshot


def test_fleet_replay_sharded_and_segments(pods, single):
    from crdt_tpu.models import fleet as ref_fleet
    from crdt_tpu.parallel import gossip as ref_gossip

    want = single("fleet_replay", 4)
    blobs = traces.build_trace(40, 60, seed=0)
    for mode in ("sharded", "segments"):
        ref = ref_fleet.fleet_replay(blobs, mesh=ref_gossip.make_mesh(4),
                                     shard=mode)
        (cache, snapshot, path, _), _ = want[mode]
        assert (cache, snapshot, path) == (ref.cache, ref.snapshot,
                                           ref.path)
    got = _ranks(pods, 4, "fleet_replay")
    for rank, g in enumerate(got):
        for mode in ("sharded", "segments"):
            _eq(g[mode][0], want[mode][0], f"{mode}, rank {rank}")
        # a segment entry's converge: one ds_mask an entry, in its rank
        assert g["segments"][1] == {"ds_mask": 1}
    assert want["segments"][1] == {"ds_mask": 4}


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_replica_fleet_on_pod_meshes(pods, single, inputs, world):
    from crdt_tpu.parallel import gossip as ref_gossip

    want = single("replica_fleet", world)
    got = _ranks(pods, world, "replica_fleet")
    for rank, g in enumerate(got):
        for name in ("1d", "2d"):
            _eq(g[name][0], want[name][0], f"{name}, rank {rank}")
            # every rank converges the union: the replicated compute
            assert g[name][1] == {"ds_mask": 1, "sv_deficit": 1}
    # ... the reference's two-tier step on the same columns
    cols, dels = inputs["fleet_cols"]
    ref = np.asarray(ref_gossip.make_hierarchical_gossip_step(
        ref_gossip.make_mesh2d(2, 4), num_segments=256, num_clients=18)(
        ref_gossip.pack_cols(cols), ref_gossip.pack_dels(dels)))
    vec = np.concatenate([np.asarray(v).reshape(-1)
                          for v in want["2d"][0].values()])
    assert np.array_equal(vec, ref)


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_ring_delta_over_the_pod(pods, single, world):
    want = _replicated(pods, single, world, "ring")
    for budget, out in want.items():
        sent, valid = out[0], out[-1]
        assert (sent == 8).all()
        assert (valid.sum(axis=1) == min(budget, 8)).all()


def test_multidoc_shards_4_tick_by_tick(pods, single, inputs):
    from crdt_tpu.models.multidoc import MultiDocServer as RefServer

    want = _replicated(pods, single, 4, "multidoc")
    assert sum(n for _, _, n in want) >= 1, "no cold batch went sharded"
    ref = RefServer(delta_ticks=True, pool=True, shards=4)
    with _env(CRDT_TPU_DEVICE_MIN=1, CRDT_TPU_SHARD_MIN_ROWS=1):
        for (rep, digests, _), blobs_of in zip(
                want, inputs["mt_rounds"]):
            for d, blobs in blobs_of.items():
                ref.submit_many(d, blobs)
            assert tuple(ref.tick()) == rep
            assert {d: ref.digest(d) for d in blobs_of} == digests


def test_divergent_ranks_fail_loudly(pods):
    for rank, g in enumerate(_ranks(pods, 4, "divergence")):
        assert "pod collectives diverged" in g["order"], rank
        assert "pod collectives diverged" in g["plan"], rank
        assert g["after"].tolist() == [[0], [1], [2], [3]]


def test_nccl_on_too_few_cards_is_refused():
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        mesh_mod.check_backend("nccl", "cuda", n_cards=1, local_world=2)
    # a group started without torchrun's LOCAL_WORLD_SIZE is taken to
    # be on one host, and the refusal says so
    with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE is unset"):
        mesh_mod.check_backend("nccl", "cuda", n_cards=1, local_world=4,
                               assumed=True)
    with pytest.raises(ValueError, match="gloo"):
        mesh_mod.check_backend("nccl", "cpu", n_cards=1, local_world=1)
    mesh_mod.check_backend("nccl", "cuda", n_cards=4, local_world=4)
    mesh_mod.check_backend("gloo", "cuda", n_cards=1, local_world=4)


@pytest.mark.parametrize("backend,cards,local_world,want", [
    # a card a rank: rank r's entries on its own card
    ("nccl", 4, None, ["rank0:cuda:0", "rank0:cuda:0", "rank1:cuda:1",
                       "rank1:cuda:1", "cuda:2", "cuda:2",
                       "rank3:cuda:3", "rank3:cuda:3"]),
    # two hosts of two cards: local rank 0 of the second host
    ("nccl", 2, 2, ["rank0:cuda:0", "rank0:cuda:0", "rank1:cuda:1",
                    "rank1:cuda:1", "cuda:0", "cuda:0", "rank3:cuda:1",
                    "rank3:cuda:1"]),
    # gloo: four ranks share the one card
    ("gloo", 1, None, ["rank0:cuda:0", "rank0:cuda:0", "rank1:cuda:0",
                       "rank1:cuda:0", "cuda:0", "cuda:0",
                       "rank3:cuda:0", "rank3:cuda:0"]),
])
def test_pod_places_entries_on_its_own_cards(monkeypatch, backend, cards,
                                             local_world, want):
    """Rank 2 of 4, no group needed: the pod's placement read from the
    group and the host's cards, and the nccl refusal raised by
    ``make_mesh`` itself, before any collective."""
    monkeypatch.setattr(mesh_mod, "_group", lambda: (2, 4, backend))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    m = mesh_mod.make_mesh(8, device="cuda")
    assert [str(e) for e in mesh_mod.entries(m)] == want
    assert mesh_mod.home(m) == torch.device(want[4])
    assert mesh_mod.default_size("cuda") == 4 * (
        1 if backend == "nccl" else cards)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if backend == "nccl" and local_world != 1:
        with pytest.raises(RuntimeError, match="backend='gloo'") as err:
            mesh_mod.make_mesh(8, device="cuda")
        assert ("LOCAL_WORLD_SIZE is unset" in str(err.value)) == (
            local_world is None)
        with pytest.raises(ValueError, match="gloo group"):
            mesh_mod.make_mesh(8, device="cpu")
