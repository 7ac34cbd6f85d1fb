"""Every cell driven for a moment against the port on the CPU (the
run's own path, the card check skipped), its control, and the faults a
timed path can have: each of the latter must come out not correct."""

import time

import pytest

from benchmark import control, run
from benchmark.drivers import replay, server
from benchmark.tests.small import SMALL

ROOT = run.ROOT
CELLS = sorted(SMALL)


def _run(cell, trace=False, program=None, seed=20260101):
    return run.run_cell(ROOT, cell, seed, 1.5, trace, "cpu",
                        overrides=SMALL[cell], program=program,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, trace):
    res = _run(cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    if trace:
        assert names and all(not n.endswith("_s") for n in names)
        assert res["device"]["window_s"] > 0
        assert "breakdown" in res
    else:
        assert "setup_s" in names and len(names) >= 2
    assert list(res)[-2:] == ["checks", "_detail"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell):
    res = control.control(ROOT, cell, 31, 1.5, "cpu", SMALL[cell])
    assert not res["correct"], res["checks"]


def _bump(x):
    return x + "!" if isinstance(x, str) else x + 1


def _altered(cache: dict) -> dict:
    out = {k: (dict(v) if isinstance(v, dict) else list(v))
           for k, v in cache.items()}
    name = sorted(out)[0]
    v = out[name]
    if isinstance(v, dict):
        k = sorted(v)[0]
        v[k] = _bump(v[k])
    else:
        v[0] = _bump(v[0])
    return out


class _Replayed:
    def __init__(self, res, cache=None):
        self.cache = res.cache if cache is None else cache
        self.snapshot, self.n_ops = res.snapshot, res.n_ops


def _replay_fault(kind):
    def make(drv):
        real = replay.port(drv)
        if kind == "unchanged":
            empty = real([])
            return lambda blobs: empty
        if kind == "half":
            return lambda blobs: real(blobs[:len(blobs) // 2])
        return lambda blobs: _Replayed(real(blobs),
                                       _altered(real(blobs).cache))
    return make


class _ServerFault:
    """The server with a fault from the window's first tick on (set-up
    ticks once for the load and once for each warm batch)."""

    def __init__(self, drv, kind):
        self.real, self.kind, self.n = server.port(drv), kind, 0
        self.ticks, self.setup_ticks = 0, 1 + len(drv.warm)

    def _on(self):
        return self.ticks >= self.setup_ticks

    def submit(self, doc, blob):
        self.n += 1
        if self.kind == "half" and self._on() and self.n % 2:
            return 0
        return self.real.submit(doc, blob)

    def tick(self):
        on = self._on()
        self.ticks += 1
        if self.kind == "unchanged" and on:
            return _zero_tick()  # acknowledged, never applied
        return self.real.tick()

    def digest(self, doc):
        d = self.real.digest(doc)
        if self.kind == "altered" and self._on():
            return d[:-1] + ("0" if d[-1] != "0" else "1")
        return d

    def cache(self, doc):
        c = self.real.cache(doc)
        return _altered(c) if self.kind == "altered" else c


def _zero_tick():
    from benchmark.reference.controls import _Tick

    return _Tick()


FAULTS = {
    "fanin_1k.cold_replay": _replay_fault,
    "tenants_1k.ycsb_d": lambda k: (lambda drv: _ServerFault(drv, k)),
}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_comes_out_not_correct(cell, kind):
    res = _run(cell, program=FAULTS[cell](kind))
    assert not res["correct"], res["checks"]


WORKLOAD_A = {"config": {"recordcount": 60, "readproportion": 0.5,
                         "updateproportion": 0.5, "insertproportion": 0,
                         "requestdistribution": "zipfian"},
              "mix": {"rate": 40, "check_reads": 30}}


@pytest.mark.parametrize("side", ["port", "control"])
def test_server_driver_takes_workload_a_from_data_alone(side):
    # YCSB workload A's shares and zipfian targets, set only in the
    # configuration: the port comes out correct, the control not
    if side == "port":
        res = run.run_cell(ROOT, "tenants_1k.ycsb_d", 20260102, 1.5, False,
                           "cpu", overrides=WORKLOAD_A,
                           t_start=time.perf_counter())
        assert res["correct"], res["checks"]
    else:
        res = control.control(ROOT, "tenants_1k.ycsb_d", 32, 1.5, "cpu",
                              WORKLOAD_A)
        assert not res["correct"], res["checks"]
    assert res["attempted"] == 60 and res["failed"] == 0
