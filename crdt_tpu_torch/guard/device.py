"""Device failure policy: the guarded converge-dispatch ladder.

The port's counterpart of ``crdt_tpu.guard.device``. A guarded dispatch
runs the ladder

    attempt → retry once → split the work in half → host route

where each rung is strictly cheaper in assumptions: the retry covers a
transient fault, the split a size-dependent one (an out-of-memory that a
half-size batch survives — offered only where the work genuinely
halves), and the host route a dead device (the host path is exact, so
the answer is bit-identical, just slower). Counters:
``device.retries``, ``device.fallback`` (+ ``device.fallback_by{route=
...}``), ``device.dispatch_errors``.

What triggers the ladder is narrower than in the reference, which takes
any ``RuntimeError``: in torch a failed build, a CUDA error, a missing
card and an out-of-memory are all ``RuntimeError`` too, and a ladder
that caught them would route every round quietly to the host while the
result stayed byte-identical. Here only a ``RuntimeError`` raised by the
fault hook (:func:`crdt_tpu_torch.ops.device.set_device_fault_hook`)
climbs the ladder; the hook fires BEFORE each attempt, so tests inject
device faults without a failing card.

Anything the dispatch itself raises — the kernel layer's
:class:`~crdt_tpu_torch.ops._build.KernelError`, a CUDA error, a
``torch.OutOfMemoryError``, a programming error — propagates at once:
work whose tensors live on the card never moves to the host unseen.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from crdt_tpu_torch.obs.recorder import get_recorder
from crdt_tpu_torch.obs.tracer import get_tracer
from crdt_tpu_torch.ops.device import device_fault_hook


class _Fault(Exception):
    """A fault the ladder handles, carrying the original error."""

    def __init__(self, err: BaseException):
        super().__init__(err)
        self.err = err


def _attempt(stage: str, run: Callable, attempt: int):
    hook = device_fault_hook()
    if hook is not None:
        try:
            hook(stage, attempt)
        except RuntimeError as e:  # an injected fault
            raise _Fault(e) from e
    return run()


def dispatch_guarded(
    stage: str,
    run: Callable[[], object],
    *,
    split: Optional[Callable[[], Optional[List[Tuple[Callable, Callable]]]]] = None,
    host: Optional[Callable[[], object]] = None,
):
    """Run ``run()`` (a device dispatch) under the failure ladder.

    ``split``, when given, returns a list of ``(run_half, host_half)``
    thunk pairs covering the same work in independent pieces (or
    ``None``/a single pair when the work cannot split); each piece is
    re-guarded individually. ``host`` recomputes the WHOLE result on
    host. With neither rung available the second fault re-raises — the
    caller opted out of degradation."""
    tracer = get_tracer()
    err: Optional[BaseException] = None
    for attempt in (0, 1):
        try:
            if attempt:
                tracer.count("device.retries")
            return _attempt(stage, run, attempt)
        except _Fault as f:
            err = f.err
            tracer.count("device.dispatch_errors")
    rec = get_recorder()
    if rec.enabled:
        rec.record("device.fault", stage=stage, error=repr(err)[:200])
    halves = split() if split is not None else None
    if halves and len(halves) > 1:
        tracer.count("device.fallback")
        tracer.count("device.fallback_by", labels={"route": "split"})
        return [
            dispatch_guarded(stage, run_half, host=host_half)
            for run_half, host_half in halves
        ]
    if host is not None:
        tracer.count("device.fallback")
        tracer.count("device.fallback_by", labels={"route": "host"})
        return host()
    raise err
