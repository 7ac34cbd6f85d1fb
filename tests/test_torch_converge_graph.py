"""The packed converge split around its two kernels, as the card's
graph route replays it (crdt_tpu_torch.ops.packed), on the CPU.

1. **The split.** ``_converge_pre`` -> the kernels' plain versions ->
   ``_converge_post`` gives the very int32 result of the reference's
   unsplit body (crdt_tpu.ops.packed, its kernels in interpret mode),
   on every plan fixture of tests/test_torch_packed.py and on the plans
   the ``tenants_1k`` load driver stages at the benchmark tests' size
   (one new doc a tick, and bursts of several).
2. **The replay plumbing.** :class:`ConvergeGraphs` with a stand-in
   capture (each "replay" reruns the half eagerly into the captured
   outputs) gives the body's result for every plan of one signature,
   and a result is never overwritten by a later run of its signature.
3. **The cache.** :func:`graph_key` tells signatures apart by buckets,
   rounds, encodings, staged dtype and shape, and device, and nothing
   else; :class:`GraphCache` never holds more than its size.
"""

import numpy as np
import pytest
import torch

from crdt_tpu.ops import packed as ref_packed
from crdt_tpu_torch.ops import kernels, packed, staging
from tests.test_torch_packed import CASES, _blob_cols
from tests.test_transfer_diet import boundary_blobs

ROOT = __file__.rsplit("/tests/", 1)[0]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_PALLAS", "interpret")
    monkeypatch.delenv("CRDT_TPU_WIDE_STAGING", raising=False)
    monkeypatch.delenv(ref_packed._CHAIN_SPLIT_ENV, raising=False)


def _tenant_plans():
    """Every plan the multi-tenant server hands ``packed.converge_async``
    while the ``tenants_1k.ycsb_d`` load driver sets up at the benchmark
    tests' size: the load tick, then warm ticks inserting 1, 2, 4, 8
    and 16 new docs."""
    from benchmark.drivers.server import Driver
    from benchmark.harness import cell
    from benchmark.tests.small import SMALL

    c = cell.load(ROOT, "tenants_1k.ycsb_d")
    small = SMALL["tenants_1k.ycsb_d"]
    plans = []
    real = packed.converge_async

    def seen(plan, **kw):
        plans.append(plan)
        return real(plan, **kw)

    packed.converge_async = seen
    try:
        Driver(dict(c.config, **small["config"]),
               dict(c.mix, **small["mix"]), 7, "cpu", 1.0)
    finally:
        packed.converge_async = real
    return plans


_TENANT_PLANS = []


def tenant_plans():
    if not _TENANT_PLANS:
        _TENANT_PLANS.extend(_tenant_plans())
    return _TENANT_PLANS


# (id, plan builder): every plan fixture of tests/test_torch_packed.py,
# staged narrow and wide, and the server's plans
FIXTURES = [(f"{name}-{'wide' if wide else 'narrow'}",
             lambda b=build, w=wide: staging.stage(b(), wide=w))
            for name, build in CASES for wide in (None, True)]
FIXTURES += [(f"tenants-{i}", lambda i=i: tenant_plans()[i])
             for i in range(6)]


def _split(plan):
    """pre -> the kernels' plain versions -> post."""
    secs = packed._device_sections(plan, CPU)
    args = packed._plan_args(plan)
    mcl, mflag, pos = packed._converge_pre(*secs, **args)
    arg = kernels.seg_argmax_scan_plain(mcl, mflag)
    perm = kernels.stream_scatter_plain(pos, plan.seq_bucket)
    return packed._converge_post(arg, perm, secs[6], secs[7],
                                 map_rounds=plan.map_rounds)


def _reference(plan):
    """The reference's unsplit body on the same staged plan."""
    ref_plan = ref_packed.PackedPlan(**plan._asdict())
    return np.asarray(ref_packed.converge_async(ref_plan)[1])


def test_the_server_stages_one_doc_and_bursts():
    plans = tenant_plans()
    # the load tick and the five warm ticks, each its own dispatch
    assert len(plans) == 6
    segs = [p.num_segments for p in plans]
    assert len(set(segs)) > 2, segs


@pytest.mark.parametrize("build", [f[1] for f in FIXTURES],
                         ids=[f[0] for f in FIXTURES])
def test_split_equals_the_unsplit_body(build):
    plan = build()
    got = _split(plan)
    assert got.dtype == torch.int32
    want = _reference(plan)
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    # the body is the composition, with the wrappers' own dispatch
    body = packed._converge_packed_body(*packed._device_sections(plan, CPU),
                                        **packed._plan_args(plan))
    assert torch.equal(body, got)


def test_eagerly_shipped_plan_splits_like_its_matrix_plan():
    cols = _blob_cols(boundary_blobs(0, R=8, K=30))
    eager = staging.stage(cols, put=lambda a: torch.from_numpy(a))
    assert eager.mat is None and len(eager.dev) == 3
    assert torch.equal(_split(eager), _split(staging.stage(cols)))


# ---------------------------------------------------------------------------
# the replay plumbing, with each half rerun eagerly in place of a graph
# ---------------------------------------------------------------------------


class _EagerGraph:
    def __init__(self, fn, outs):
        self.fn, self.outs = fn, outs

    def replay(self):
        for out, new in zip(self.outs, self.fn()):
            out.copy_(new)


def _eager_capture(fn):
    outs = fn()
    return _EagerGraph(fn, outs), outs


def _same_key_groups(plans):
    groups = {}
    for p in plans:
        groups.setdefault(packed.graph_key(p, CPU), []).append(p)
    return list(groups.values())


def _body(plan):
    return packed._converge_packed_body(*packed._device_sections(plan, CPU),
                                        **packed._plan_args(plan))


def _variants(plan, n):
    """``plan`` and ``n - 1`` plans of its signature with other staged
    values: its map keys permuted (each still a valid key, so the scan
    finds other runs and winners)."""
    sizes = staging._section_sizes(plan.num_segments, plan.seq_bucket,
                                   plan.map_bucket)
    widths = [2 * s if e == "hilo" else s for s, e in zip(sizes, plan.encs)]
    off, size = sum(widths[:5]), sizes[5]
    halves = 2 if plan.encs[5] == "hilo" else 1
    rng = np.random.default_rng(5)
    out = [plan]
    for _ in range(1, n):
        perm = rng.permutation(size)
        mat = plan.mat.copy()
        for h in range(halves):
            a = off + h * size
            mat[a:a + size] = plan.mat[a:a + size][perm]
        out.append(plan._replace(mat=mat))
    return out


@pytest.mark.parametrize("build", [f[1] for f in FIXTURES[::3]],
                         ids=[f[0] for f in FIXTURES[::3]])
def test_graphs_run_every_plan_of_their_signature(build):
    plan = build()
    plans = _variants(plan, 3)
    g = packed.ConvergeGraphs(plan, packed._staged_inputs(plan, CPU),
                              _eager_capture)
    for p in plans:
        assert torch.equal(g.run(p), _body(p))


@pytest.mark.parametrize("wide", [None, True])
def test_a_result_outlives_the_next_run_of_its_signature(wide):
    # its map rows hold runs of several members, so permuted keys give
    # other winners
    build = dict(CASES)["seq_heavy_map_bucket"]
    plans = _variants(staging.stage(build(), wide=wide), 2)
    g = packed.ConvergeGraphs(plans[0], packed._staged_inputs(plans[0], CPU),
                              _eager_capture)
    first = g.run(plans[0])
    kept = first.clone()
    second = g.run(plans[1])
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    assert torch.equal(second, _body(plans[1]))


def test_server_plans_fall_into_few_signatures():
    groups = _same_key_groups(tenant_plans())
    assert 1 <= len(groups) <= packed.GRAPH_CACHE_SIZE


# ---------------------------------------------------------------------------
# the key and the cache
# ---------------------------------------------------------------------------


def _base_plan():
    return staging.stage(CASES[2][1]())


CHANGES = {
    "num_segments": lambda p: p._replace(num_segments=p.num_segments + 1),
    "seq_bucket": lambda p: p._replace(seq_bucket=p.seq_bucket * 2),
    "map_bucket": lambda p: p._replace(map_bucket=p.map_bucket * 2),
    "rank_rounds": lambda p: p._replace(rank_rounds=p.rank_rounds + 1),
    "map_rounds": lambda p: p._replace(map_rounds=p.map_rounds + 1),
    "encs": lambda p: p._replace(encs=("hilo",) + tuple(p.encs[1:])),
    "staged_dtype": lambda p: p._replace(mat=p.mat.astype(np.int32)
                                         if p.mat.dtype == np.int16
                                         else p.mat.astype(np.int16)),
    "staged_shape": lambda p: p._replace(mat=np.concatenate([p.mat,
                                                             p.mat[:1]])),
    "shipped": lambda p: p._replace(mat=None, dev=tuple(
        torch.zeros(4, dtype=torch.int16) for _ in range(3))),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_key_differs_with_each_static_field(change):
    plan = _base_plan()
    assert packed.graph_key(CHANGES[change](plan), CPU) != \
        packed.graph_key(plan, CPU)


def test_key_differs_by_device():
    plan = _base_plan()
    assert packed.graph_key(plan, torch.device("cuda", 0)) != \
        packed.graph_key(plan, CPU)
    assert packed.graph_key(plan, torch.device("cuda", 0)) != \
        packed.graph_key(plan, torch.device("cuda", 1))


@pytest.mark.parametrize("field", ["values", "tables", "counts"])
def test_key_equal_when_only_data_differs(field):
    plan = _base_plan()
    other = {
        "values": lambda p: p._replace(mat=p.mat[::-1].copy()),
        "tables": lambda p: p._replace(map_back=p.map_back + 1,
                                       seq_back=p.seq_back + 1),
        "counts": lambda p: p._replace(seg_counts=p.seg_counts * 0,
                                       n=p.n + 1),
    }[field](plan)
    assert packed.graph_key(other, CPU) == packed.graph_key(plan, CPU)


class _Stub:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def retire(self):
        self.log.append(self.name)


def test_cache_never_holds_more_than_its_size():
    cache = packed.GraphCache()
    size = packed.GRAPH_CACHE_SIZE
    retired = []
    for i in range(3 * size):
        cache.put(i, _Stub(retired, i))
        assert len(cache) <= size
    assert len(cache) == size
    assert retired == list(range(2 * size))


def test_cache_drops_the_least_recently_used():
    cache = packed.GraphCache()
    size = packed.GRAPH_CACHE_SIZE
    retired = []
    for k in range(size):
        cache.put(k, _Stub(retired, k))
    assert cache.get(0).name == 0       # 0 is now the most recent
    cache.put(size, _Stub(retired, size))
    assert retired == [1]
    assert cache.get(1) is None
    assert [cache.get(k).name for k in (0, 2, size)] == [0, 2, size]
    cache.put(0, _Stub(retired, "again"))  # a new entry under a live key
    assert len(cache) == size and retired == [1]


def test_the_route_has_no_switch():
    # the CPU path is the eager body; the card's is the graph route, with
    # no option, environment variable or fallback between them
    import inspect

    params = inspect.signature(packed.converge_async).parameters
    assert list(params) == ["plan", "device"]
    src = inspect.getsource(packed._graph_dispatch)
    assert "environ" not in src and "except" not in src
