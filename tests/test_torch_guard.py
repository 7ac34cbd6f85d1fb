"""The port's guarded dispatch ladder (``crdt_tpu_torch.guard.device``)
against the reference's (``crdt_tpu.guard.device``).

Each scenario injects the same faults through each package's fault hook
and must give the same result, the same ``device.*`` counters and the
same flight-recorder events. The split rung, which no port caller uses
yet, is held here.
"""

import pytest
import torch

from crdt_tpu.guard.device import dispatch_guarded as ref_guarded
from crdt_tpu.obs import recorder as ref_recorder
from crdt_tpu.obs import tracer as ref_tracer
from crdt_tpu.ops import device as ref_device
from crdt_tpu_torch.guard.device import dispatch_guarded
from crdt_tpu_torch.obs import recorder, tracer
from crdt_tpu_torch.ops import device
from crdt_tpu_torch.ops._build import KernelError


def _hook(failing):
    """A fault hook that raises on the (stage, attempt) pairs it is
    given, in order of the calls it sees."""
    calls = []

    def hook(stage, attempt):
        calls.append((stage, attempt))
        if failing(len(calls) - 1, stage, attempt):
            raise RuntimeError(f"injected at call {len(calls) - 1}")

    return hook, calls


def _run(guarded, dev, trc, rec, failing, *, split, host):
    hook, calls = _hook(failing)
    t = trc.set_tracer(trc.Tracer(enabled=True))
    r = rec.set_recorder(rec.FlightRecorder(enabled=True))
    old = dev.set_device_fault_hook(hook)
    try:
        try:
            out = guarded("stage", lambda: "device", split=split, host=host)
        except RuntimeError as e:
            out = ("raised", str(e))
    finally:
        dev.set_device_fault_hook(old)
        trc.set_tracer(trc.Tracer(enabled=False))
        rec.set_recorder(rec.FlightRecorder(enabled=False))
    events = [(e["kind"], e["stage"], e["error"]) for e in r.events()]
    return out, calls, t.counters("device."), events


def _halves():
    return [(lambda: "half 0", lambda: "host 0"),
            (lambda: "half 1", lambda: "host 1")]


SCENARIOS = {
    "no fault": (lambda i, s, a: False, None, None),
    "one fault retries": (lambda i, s, a: i == 0, None, lambda: "host"),
    "two faults to host": (lambda i, s, a: i < 2, None, lambda: "host"),
    "two faults, no rung": (lambda i, s, a: i < 2, None, None),
    "split, halves on the device": (lambda i, s, a: i < 2, _halves,
                                    lambda: "host"),
    "split, every half to host": (lambda i, s, a: True, _halves,
                                  lambda: "host"),
    "split, second half to host": (lambda i, s, a: i < 2 or i >= 3,
                                   _halves, lambda: "host"),
    "split refused": (lambda i, s, a: i < 2, lambda: None, lambda: "host"),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ladder_matches_reference(name):
    failing, split, host = SCENARIOS[name]
    got = _run(dispatch_guarded, device, tracer, recorder, failing,
               split=split, host=host)
    want = _run(ref_guarded, ref_device, ref_tracer, ref_recorder, failing,
                split=split, host=host)
    assert got == want


@pytest.mark.parametrize("error", [
    KernelError("stream_scatter launch: CUDA error 700"),
    torch.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access"),
], ids=["kernel error", "out of memory", "CUDA error"])
def test_kernel_errors_skip_every_rung(error):
    # only the fault hook climbs the ladder: whatever the dispatch
    # itself raises propagates with no retry, split or host rung
    def run():
        raise error

    t = tracer.set_tracer(tracer.Tracer(enabled=True))
    try:
        with pytest.raises(type(error)):
            dispatch_guarded("stage", run, split=_halves,
                             host=lambda: "host")
    finally:
        tracer.set_tracer(tracer.Tracer(enabled=False))
    assert t.counters("device.") == {}
