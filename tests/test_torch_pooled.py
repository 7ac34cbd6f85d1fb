"""The port's pooled resident matrix against the reference's, on the CPU.

- ``stage_pooled_delta`` field by field, and every ``_pool_*`` device
  function on the same seeded ``[8, cap]`` matrix, exactly: the splice's
  dropped padding at ``pool_cap``, dead slots, relocations, kills,
  relabels, growth and the compaction gather;
- a scripted ``ResidentPool`` life against the reference's (register,
  defer, grow, relocate, release, compact, a budget refusal and a doc
  that alone outgrows the pool), with equal extents, counters and
  matrices after every step, and every kill or move window of the
  reference in bounds (the port refuses a window JAX would clamp);
- pooled against unpooled servers, and against the reference's pooled
  server, on the shapes of tests/test_pooled.py;
- an injected device fault and an error inside a flush, both ending in
  ``_reset_all`` with every doc's state intact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from crdt_tpu.compat import enable_x64
from crdt_tpu.models.incremental import IncrementalReplay as RefReplay
from crdt_tpu.models.multidoc import MultiDocServer as RefServer
from crdt_tpu.ops import packed as ref_pk
from crdt_tpu.ops import resident as ref_resident
from crdt_tpu.ops import shard as ref_shard
from crdt_tpu_torch.models.incremental import IncrementalReplay, _Cols
from crdt_tpu_torch.models.multidoc import MultiDocServer
from crdt_tpu_torch.ops import device as dev_mod
from crdt_tpu_torch.ops import packed as pk
from crdt_tpu_torch.ops.resident import (_EXT_FLOOR, _LANES, ResidentPool,
                                         _octave8)
from tests.test_multidoc import doc_blobs
from tests.test_pooled import delta_blobs


@pytest.fixture(autouse=True)
def _no_ambient_sharding(monkeypatch):
    monkeypatch.delenv(ref_shard.SHARD_ENV, raising=False)
    monkeypatch.delenv(ref_shard.MIN_ROWS_ENV, raising=False)


@pytest.fixture
def force_device(monkeypatch):
    """Every delta above the crossover: the pooled defer/flush seam runs
    on small docs."""
    monkeypatch.setenv("CRDT_TPU_DEVICE_MIN", "1")


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _random_mat(rng, cap: int) -> np.ndarray:
    """A seeded pooled matrix: live extents of small dense ids, dead
    columns with slot -1."""
    m = np.zeros((8, cap), np.int64)
    m[0] = rng.integers(0, 6, cap)
    m[1] = rng.integers(0, 50, cap)
    m[2] = rng.integers(0, 4, cap)
    m[3] = np.where(rng.random(cap) < 0.5, rng.integers(0, 3, cap), -1)
    m[4] = np.where(rng.random(cap) < 0.6, rng.integers(0, 6, cap), -1)
    m[5] = np.where(m[4] >= 0, rng.integers(0, 50, cap), -1)
    m[6] = rng.random(cap) < 0.8
    m[7] = np.where(m[6] != 0, rng.integers(0, 3, cap), -1)
    return m


# ---------------------------------------------------------------------------
# the device functions, one by one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_pooled_delta_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k, kpad, cap = 37, 64, 4096
    cols = [rng.integers(0, 9, k), rng.integers(0, 90, k),
            rng.integers(-1, 5, k), rng.integers(-1, 3, k),
            rng.integers(-1, 9, k), rng.integers(-1, 90, k),
            rng.integers(0, 4, k)]
    pos = rng.choice(cap, k, replace=False)
    got = pk.stage_pooled_delta(*cols, pos, kpad, cap)
    want = ref_pk.stage_pooled_delta(*cols, pos, kpad, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert (got[1][k:] == cap).all()  # padding lands past the matrix


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_splice_drops_padding_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    cap, kpad, k = 512, 64, 29
    mat = _random_mat(rng, cap)
    delta = _random_mat(rng, kpad)
    pos = np.full(kpad, cap, np.int32)
    pos[:k] = rng.choice(cap, k, replace=False)
    pos[k + 3] = cap + 7   # past the end too
    port = _t(mat).clone()
    pk._pool_splice(port, _t(delta), _t(pos))
    with enable_x64(True):
        want = np.asarray(_j(mat).at[:, _j(pos)].set(_j(delta), mode="drop"))
    np.testing.assert_array_equal(port.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_functions_match_reference(seed):
    rng = np.random.default_rng(seed)
    cap = 1024
    mat = _random_mat(rng, cap)
    with enable_x64(True):
        # growth
        got = pk._pool_grow(_t(mat), 4096).numpy()
        want = np.asarray(ref_pk._pool_grow(_j(mat), new_cap=4096))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            pk.new_pool_mat(64, "cpu").numpy(),
            np.asarray(ref_pk._pool_grow(jnp.zeros((8, 0), jnp.int64),
                                         new_cap=64)))
        # kill and move at in-bounds windows (in place in the port)
        for off, width in ((0, 64), (256, 128), (cap - 128, 128)):
            port = _t(mat).clone()
            assert pk._pool_kill(port, off, width) is port
            want = np.asarray(ref_pk._pool_kill(_j(mat), jnp.int32(off),
                                                width=width))
            np.testing.assert_array_equal(port.numpy(), want)
        for src, dst, width in ((0, 512, 256), (128, 768, 256),
                                (512, 0, 128)):
            port = _t(mat).clone()
            pk._pool_move(port, src, dst, width)
            want = np.asarray(ref_pk._pool_move(
                _j(mat), jnp.int32(src), jnp.int32(dst), width=width))
            np.testing.assert_array_equal(port.numpy(), want)
        # per-doc relabel over [off, off + n)
        perm = rng.permutation(6).astype(np.int32)
        for off, n in ((0, 300), (100, 924), (700, 0)):
            port = _t(mat).clone()
            pk._pool_relabel_range(port, _t(perm), off, n)
            want = np.asarray(ref_pk._pool_relabel_range(
                _j(mat), _j(perm), jnp.int32(off), jnp.int32(n)))
            np.testing.assert_array_equal(port.numpy(), want)
        # compaction gather, with dead positions reset
        new_cap = 512
        src = rng.integers(0, cap, new_cap).astype(np.int32)
        keep = rng.random(new_cap) < 0.7
        got = pk._pool_compact(_t(mat), _t(src), _t(keep)).numpy()
        want = np.asarray(ref_pk._pool_compact(_j(mat), _j(src), _j(keep)))
        np.testing.assert_array_equal(got, want)


def test_windows_jax_would_clamp_raise_in_the_port():
    mat = pk.new_pool_mat(256, "cpu")
    with pytest.raises(ValueError, match="window"):
        pk._pool_kill(mat, 200, 128)
    with pytest.raises(ValueError, match="window"):
        pk._pool_move(mat, 0, 192, 128)
    with pytest.raises(ValueError, match="window"):
        pk._pool_move(mat, -1, 0, 8)


def test_octave8_matches_reference():
    for n in (0, 1, 16, 17, 1000, 8193, 1 << 20):
        for floor in (16, 1 << 6, 1 << 10, 1 << 13):
            assert _octave8(n, floor) == ref_resident._octave8(n, floor)


# ---------------------------------------------------------------------------
# the pool: a scripted life against the reference's
# ---------------------------------------------------------------------------


def _ext_state(pool, engs):
    out = []
    for e in engs:
        x = pool._ext.get(e)
        out.append(None if x is None else (x.off, x.cap, x.slot, x.n,
                                           x.move_from))
    return out


class _Pair:
    """One reference pool and one port pool driven in lockstep, with
    every reference kill and move window recorded."""

    def __init__(self, monkeypatch, **kw):
        self.ref = ref_resident.ResidentPool(**kw)
        self.port = ResidentPool(device="cpu", **kw)
        self.refs, self.ports = [], []
        self.windows = []
        for name in ("_pool_kill", "_pool_move"):
            real = getattr(ref_pk, name)

            def rec(mat, *args, _real=real, _name=name, **kw2):
                offs = [int(a) for a in args]
                self.windows.append((_name, offs, kw2["width"],
                                     int(mat.shape[1])))
                return _real(mat, *args, **kw2)

            monkeypatch.setattr(ref_pk, name, rec)

    def add(self, blobs):
        r = RefReplay(device_min_rows=1, pool=self.ref)
        p = IncrementalReplay(device_min_rows=1, pool=self.port,
                              device="cpu")
        self.refs.append(r)
        self.ports.append(p)
        self.apply(len(self.refs) - 1, blobs)

    def apply(self, i, blobs):
        self.refs[i].apply(blobs)
        self.ports[i].apply(blobs)

    def release(self, i):
        self.ref.release(self.refs[i])
        self.port.release(self.ports[i])

    def flush(self):
        assert self.port.flush() == self.ref.flush()
        self.check()

    def check(self):
        r, p = self.ref, self.port
        assert _ext_state(p, self.ports) == _ext_state(r, self.refs)
        for name in ("dispatches", "compactions", "peak_bytes",
                     "_next_slot"):
            assert getattr(p, name) == getattr(r, name), name
        assert p.device_bytes() == r.device_bytes()
        assert p._free_slots == r._free_slots
        assert p._dead == r._dead
        assert p.has_pending() == r.has_pending()
        if r._mat is None:
            assert p._mat is None
        else:
            np.testing.assert_array_equal(p._mat.numpy(), np.asarray(r._mat))
        for a, b in zip(self.refs, self.ports):
            assert b.n_dev == a.n_dev
            assert b.resident_bytes() == a.resident_bytes()

    def caches_equal(self):
        for a, b in zip(self.refs, self.ports):
            assert b.cache == a.cache
            assert b.state_vector().clocks == a.state_vector().clocks
        self.check()

    def windows_in_bounds(self):
        for name, offs, width, cap in self.windows:
            for off in offs:
                assert 0 <= off and off + width <= cap, (name, offs, width)


def test_scripted_pool_life_matches_reference(force_device, monkeypatch):
    # room for one 1024-row extent per doc of three, then growth
    pair = _Pair(monkeypatch, capacity=1 << 12)
    for i in range(3):
        pair.add(doc_blobs(i, K=20))        # register + defer
        pair.check()
    pair.flush()                            # first dispatch
    pair.caches_equal()
    # grow doc 1 past its extent: a relocation at the next flush
    pair.apply(1, doc_blobs(1, K=400))
    pair.check()
    assert pair.port._ext[pair.ports[1]].move_from is not None
    pair.flush()
    pair.caches_equal()
    # a release leaves a hole; a new doc reuses the freed slot
    pair.release(0)
    pair.check()
    pair.add(doc_blobs(7, K=15))
    pair.flush()
    pair.caches_equal()
    # more releases: holes past the live rows squeeze by a compaction
    pair.release(2)
    pair.release(3)
    pair.check()
    assert pair.port.compactions >= 1
    pair.apply(1, delta_blobs(1, 400))
    pair.flush()
    pair.caches_equal()
    pair.windows_in_bounds()


def test_pool_budget_refusal_and_lone_outgrowth_match_reference(
        force_device, monkeypatch):
    pair = _Pair(monkeypatch, max_bytes=2 * _EXT_FLOOR * _LANES * 8)
    pair.add(doc_blobs(0, K=12))
    pair.add(doc_blobs(1, K=12))
    pair.flush()
    # a third doc does not fit: refused, it falls back to a private
    # matrix on both sides
    pair.add(doc_blobs(2, K=12))
    assert pair.refs[2].pool is None and pair.ports[2].pool is None
    assert pair.ports[2].pool_refusals == 1
    pair.flush()
    pair.caches_equal()
    # a doc that alone outgrows the pool leaves it for good
    pair.apply(0, doc_blobs(0, K=500))
    assert pair.refs[0].pool is None and pair.ports[0].pool is None
    pair.flush()
    pair.caches_equal()
    pair.windows_in_bounds()


# ---------------------------------------------------------------------------
# servers: pooled against unpooled, and against the reference's
# ---------------------------------------------------------------------------


def _servers(**kw):
    return {
        "ref_pooled": RefServer(delta_ticks=True, pool=True, **kw),
        "pooled": MultiDocServer(delta_ticks=True, pool=True,
                                 device="cpu", **kw),
        "unpooled": MultiDocServer(delta_ticks=True, pool=False,
                                   device="cpu"),
    }


def _warm(srv, doc_sets):
    for d, blobs in doc_sets.items():
        srv.submit_many(d, blobs)
    srv.tick()
    srv.tick()
    for d, blobs in doc_sets.items():
        srv.submit_many(d, blobs)
    return srv.tick()


def _assert_equal(srvs, docs):
    ref = srvs["ref_pooled"]
    for name, srv in srvs.items():
        for d in docs:
            assert srv.digest(d) == ref.digest(d), (name, d)
            assert srv.cache(d) == ref.cache(d), (name, d)
            e, r = srv._docs[d].resident, ref._docs[d].resident
            if e is not None and r is not None:
                assert e.state_vector().clocks == r.state_vector().clocks
                assert e.encode_state_as_update() == \
                    r.encode_state_as_update(), (name, d)
    p, r = srvs["pooled"].pool, ref.pool
    assert (p.dispatches, p.compactions, p.peak_bytes, p.device_bytes(),
            p.doc_count()) == (r.dispatches, r.compactions, r.peak_bytes,
                               r.device_bytes(), r.doc_count())


def test_pooled_matches_unpooled_and_reference_mixed_docs(force_device):
    doc_sets = {i: doc_blobs(i, K=18 + 3 * (i % 3), rights=(i % 2 == 1),
                             deletes=True) for i in range(6)}
    srvs = _servers()
    reps = {n: _warm(s, doc_sets) for n, s in srvs.items()}
    assert tuple(reps["pooled"]) == tuple(reps["ref_pooled"])
    assert reps["pooled"].pool_dispatches <= 1
    _assert_equal(srvs, doc_sets)
    for rnd, deletes in ((0, False), (1, True)):
        for i in doc_sets:
            blobs = delta_blobs(i, 18 + 3 * (i % 3) + 6 * rnd,
                                deletes=deletes)
            for s in srvs.values():
                s.submit_many(i, blobs)
        reps = {n: s.tick() for n, s in srvs.items()}
        assert tuple(reps["pooled"]) == tuple(reps["ref_pooled"])
        assert reps["pooled"].pool_dispatches == 1
        assert reps["unpooled"].pool_dispatches == 0
        _assert_equal(srvs, doc_sets)


def test_redelivery_across_ticks(force_device):
    doc_sets = {i: doc_blobs(i, K=15) for i in range(4)}
    srvs = _servers()
    for s in srvs.values():
        _warm(s, doc_sets)
    deltas = {i: delta_blobs(i, 15) for i in doc_sets}
    for rnd in range(2):
        for s in srvs.values():
            for i, blobs in deltas.items():
                s.submit_many(i, blobs)
            if rnd:
                s.submit_many(0, delta_blobs(0, 21))
            s.tick()
        _assert_equal(srvs, doc_sets)


def test_eviction_then_resubmit(force_device):
    doc_sets = {i: doc_blobs(i, K=20) for i in range(3)}
    est = RefReplay.estimate_resident_bytes(60)
    budget = int(est * 2.5)
    srvs = {
        "ref_pooled": RefServer(delta_ticks=True, pool=True,
                                resident_max_bytes=budget),
        "pooled": MultiDocServer(delta_ticks=True, pool=True, device="cpu",
                                 resident_max_bytes=budget),
        "unpooled": MultiDocServer(delta_ticks=True, pool=False,
                                   device="cpu"),
    }
    for s in srvs.values():
        _warm(s, {i: doc_sets[i] for i in (0, 1)})
        _warm(s, {2: doc_sets[2]})
    sp = srvs["pooled"]
    assert sp.eviction_count == srvs["ref_pooled"].eviction_count > 0
    assert sp.pool.doc_count() == sp.resident_doc_count()
    _assert_equal(srvs, doc_sets)
    for s in srvs.values():
        for start in (20, 26):
            for i in doc_sets:
                s.submit_many(i, delta_blobs(i, start))
            s.tick()
    _assert_equal(srvs, doc_sets)


def test_doc_alone_outgrows_the_pool(force_device):
    pool_bytes = _EXT_FLOOR * _LANES * 8
    doc_sets = {"small": doc_blobs(0, K=12),
                "big": doc_blobs(1, K=400, deletes=False)}
    srvs = _servers(pool_max_bytes=pool_bytes)
    for s in srvs.values():
        _warm(s, doc_sets)
    sp = srvs["pooled"]
    assert sp._docs["big"].resident.pool is None
    assert sp._docs["big"].resident.pool_refusals == 1
    assert sp.pool.doc_count() == 1
    assert sp.pool.device_bytes() <= pool_bytes
    _assert_equal(srvs, doc_sets)
    for s in srvs.values():
        s.submit_many("small", delta_blobs(0, 12))
        s.submit_many("big", delta_blobs(1, 400, K=9))
        s.tick()
    _assert_equal(srvs, doc_sets)


def test_steady_tick_is_one_pool_dispatch(force_device):
    n = 8
    doc_sets = {i: doc_blobs(i, K=18) for i in range(n)}
    srvs = _servers()
    for s in srvs.values():
        _warm(s, doc_sets)
    disp = {}
    for name, s in srvs.items():
        for i in doc_sets:
            s.submit_many(i, delta_blobs(i, 18))
        counter = ref_pk if name == "ref_pooled" else pk
        c0 = counter.device_dispatch_count
        rep = s.tick()
        disp[name] = (rep.pool_dispatches,
                      counter.device_dispatch_count - c0)
    assert disp == {"ref_pooled": (1, 1), "pooled": (1, 1),
                    "unpooled": (0, n)}
    _assert_equal(srvs, doc_sets)


def test_pool_accounting_matches_reference(force_device):
    doc_sets = {i: doc_blobs(i, K=20) for i in range(3)}
    srvs = _servers()
    for s in srvs.values():
        _warm(s, doc_sets)
    pool = srvs["pooled"].pool
    assert pool.device_bytes() == pool._mat.numel() * 8
    for i in doc_sets:
        ep = srvs["pooled"]._docs[i].resident
        share = pool._ext[ep].cap * _LANES * 8
        assert pool.doc_device_bytes(ep) == share
        assert ep._mat is None
        assert ep.resident_bytes() == \
            share + ep.cols._cap * len(_Cols.INT_COLS) * 8
        assert ep.resident_bytes() == \
            srvs["ref_pooled"]._docs[i].resident.resident_bytes()
        assert IncrementalReplay.estimate_resident_bytes(ep.cols.n) >= \
            ep.resident_bytes()


def test_pool_peak_within_budget_mid_compaction(force_device):
    budget = 4 * _EXT_FLOOR * _LANES * 8
    pool = ResidentPool(max_bytes=budget, device="cpu")
    engs = []
    for i in range(3):
        eng = IncrementalReplay(device_min_rows=1, pool=pool, device="cpu")
        eng.apply(doc_blobs(i, K=20))
        engs.append(eng)
    pool.flush()
    full = pool.device_bytes()
    pool.release(engs[0])
    pool.release(engs[1])
    assert pool.compactions >= 1
    assert pool.device_bytes() < full
    assert pool.peak_bytes <= budget
    engs[2].apply(delta_blobs(2, 20))
    pool.flush()
    oracle = RefReplay(device_min_rows=1)
    oracle.apply(doc_blobs(2, K=20))
    oracle.apply(delta_blobs(2, 20))
    assert engs[2].cache == oracle.cache


def test_pool_disabled_by_env(force_device, monkeypatch):
    monkeypatch.setenv("CRDT_TPU_MT_POOL_BYTES", "0")
    assert MultiDocServer(device="cpu").pool is None
    monkeypatch.setenv("CRDT_TPU_MT_POOL_BYTES", "262144")
    srv = MultiDocServer(device="cpu")
    assert srv.pool.max_bytes == 262144 and srv.pool.device.type == "cpu"


# ---------------------------------------------------------------------------
# faults in a flush
# ---------------------------------------------------------------------------


def _faulted_servers(doc_sets):
    srvs = _servers()
    for s in srvs.values():
        _warm(s, doc_sets)
    for i in doc_sets:
        for s in srvs.values():
            s.submit_many(i, delta_blobs(i, 18))
    return srvs


def test_injected_fault_mid_flush_resets_the_pool(force_device):
    """Both guarded attempts fault: the round routes host-side, the pool
    drops its matrix (every engine back to n_dev = 0), and the next flush
    re-splices every doc from scratch — state intact throughout."""
    doc_sets = {i: doc_blobs(i, K=18) for i in range(4)}
    srvs = _faulted_servers(doc_sets)
    stages = []

    def hook(stage, attempt):
        stages.append(stage)
        if stage == "pool.converge":
            raise RuntimeError("injected device fault")

    old = dev_mod.set_device_fault_hook(hook)
    try:
        rep = srvs["pooled"].tick()
    finally:
        dev_mod.set_device_fault_hook(old)
    for name in ("ref_pooled", "unpooled"):
        srvs[name].tick()
    assert stages.count("pool.converge") == 2 and rep.pool_dispatches == 0
    pool = srvs["pooled"].pool
    assert pool._mat is None
    assert all(e.n_dev == 0 for e in pool._ext)
    ref = srvs["ref_pooled"]
    for i in doc_sets:
        assert srvs["pooled"].cache(i) == ref.cache(i)
    for i in doc_sets:
        for s in srvs.values():
            s.submit_many(i, delta_blobs(i, 24))
    rep = srvs["pooled"].tick()
    for name in ("ref_pooled", "unpooled"):
        srvs[name].tick()
    assert rep.pool_dispatches == 1
    assert all(e.n_dev == e.cols.n for e in pool._ext)
    for i in doc_sets:
        assert srvs["pooled"].digest(i) == ref.digest(i)
        assert srvs["pooled"].cache(i) == ref.cache(i)


def test_error_inside_a_flush_propagates_after_reset(force_device,
                                                     monkeypatch):
    """An error the ladder does not take (here a RuntimeError from the
    launch itself, after the kills, moves and interning ran in place)
    propagates; the pool is reset and the round queued again, so the
    next read converges every doc from scratch."""
    doc_sets = {i: doc_blobs(i, K=18) for i in range(4)}
    srvs = _faulted_servers(doc_sets)
    real = pk._pool_splice_select_converge
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("a kernel failed")
        return real(*a, **kw)

    monkeypatch.setattr(pk, "_pool_splice_select_converge", broken)
    with pytest.raises(RuntimeError, match="a kernel failed"):
        srvs["pooled"].tick()
    pool = srvs["pooled"].pool
    assert pool._mat is None and pool.has_pending()
    assert all(e.n_dev == 0 for e in pool._ext)
    srvs["ref_pooled"].tick()
    for i in doc_sets:
        assert srvs["pooled"].cache(i) == srvs["ref_pooled"].cache(i)
    assert not pool.has_pending() and len(calls) == 2


def test_compaction_before_a_flush_over_an_unflushed_extent(force_device,
                                                           monkeypatch):
    """A release compacts the pool while a new doc's extent, reserved at
    defer time, still lies past the matrix (its flush has not run): the
    port gathers nothing for it (the reference's clamped gather copies
    the last column, here the null pattern), and both pools agree on the
    matrix and every cache afterwards."""
    pair = _Pair(monkeypatch, capacity=1024)
    for i in range(4):
        pair.add(doc_blobs(i, K=20))
    pair.flush()
    assert pair.port._mat.shape[1] == 4 * _EXT_FLOOR
    pair.add(doc_blobs(9, K=20))            # reserved at 4096, unflushed
    assert pair.port._ext[pair.ports[4]].off == pair.port._mat.shape[1]
    for i in range(3):
        pair.release(i)
    assert pair.port.compactions == pair.ref.compactions == 1
    pair.check()
    pair.flush()
    for a, b in zip(pair.refs[3:], pair.ports[3:]):
        assert b.cache == a.cache
    pair.check()


def test_pool_splice_select_converge_matches_reference_on_a_flush(
        force_device, monkeypatch):
    """One real flush's operands (a live pooled matrix of three docs, a
    delta with padding at ``pool_cap``, composite bases) through the
    port's body and the reference's undonated twin: the spliced matrix
    and the packed result agree exactly, and the twin leaves its input
    matrix as it was."""
    seen = []
    real = pk._pool_splice_select_converge

    def record(mat, *args, **kw):
        seen.append((mat.clone(), [a.clone() for a in args], dict(kw)))
        return real(mat, *args, **kw)

    monkeypatch.setattr(pk, "_pool_splice_select_converge", record)
    pool = ResidentPool(device="cpu")
    engs = [IncrementalReplay(device_min_rows=1, pool=pool, device="cpu")
            for _ in range(3)]
    for i, eng in enumerate(engs):
        eng.apply(doc_blobs(i, K=20, rights=False))
    pool.flush()
    for i, eng in enumerate(engs):
        eng.apply(delta_blobs(i, 20, deletes=(i == 1)))
    pool.flush()
    monkeypatch.setattr(pk, "_pool_splice_select_converge", real)
    assert len(seen) == 2
    for mat, args, kw in seen:
        before = mat.clone()
        got_mat, got = pk._pool_splice_select_converge_nodonate(
            mat, *args, **kw)
        assert torch.equal(mat, before)
        with enable_x64(True):
            want_mat, want = ref_pk._pool_splice_select_converge_nodonate(
                _j(mat.numpy()), *[_j(a.numpy()) for a in args],
                mode="jnp", **kw)
        np.testing.assert_array_equal(got_mat.numpy(), np.asarray(want_mat))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
