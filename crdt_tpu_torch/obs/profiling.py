"""Device-side profiling hooks: trace capture + dispatch annotations.

The port's counterpart of ``crdt_tpu.obs.profiling``:

- :func:`torch_profile` (the reference's ``jax_profile``) captures a
  ``torch.profiler`` trace of a block — the host ops and, on a card,
  its kernels — and writes it into a directory as Chrome trace-event
  JSON (open it at ui.perfetto.dev or in TensorBoard). A failure inside
  the block can never leave the profiler running, and a failing stop
  never masks the body's exception.
- Every tracer span is a range of the capture: while the profiler
  records, ``get_tracer().span(name)`` opens
  ``record_function(f"crdt.{name}")`` around its block, enabled tracer
  or not (:mod:`crdt_tpu_torch.obs.tracer`). So a capture shows the
  host's phases (``crdt.decode``, ``crdt.decode.parse``,
  ``crdt.columns``, ``crdt.pack``, ``crdt.pack.ids`` ...,
  ``crdt.converge.dispatch``, ``crdt.gather``, ``crdt.digest`` ...)
  nested on the profiler's own clock, each kernel linked to the range
  that launched it.
- :func:`device_annotation` names a range that is no span (each
  streaming shard's ``crdt.stream.shard<k>``): a
  ``torch.profiler.record_function`` range. Outside a profiling
  session it costs one small object.
"""

from __future__ import annotations

import os
import socket
import time
from contextlib import contextmanager
from typing import Iterator

import torch


def device_annotation(name: str):
    """Context manager annotating the enclosed launches in a
    ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)


@contextmanager
def torch_profile(log_dir: str) -> Iterator[object]:
    """Capture a trace around a block — e.g. one ``converge_maps``
    dispatch or one device round — into
    ``{log_dir}/{host}.{pid}.{ms}.pt.trace.json``. Traces the card too
    when one is present. Yields the ``torch.profiler.profile`` object
    (its ``key_averages()`` and ``events()`` stay readable after the
    block)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except Exception as exc:
        raise RuntimeError(
            f"torch profiler failed to start ({log_dir!r}): {exc!r}"
        ) from exc
    try:
        yield prof
    except BaseException:
        # the body failed: stop the profiler so it cannot leak into
        # (and corrupt) the next capture, but never mask the real
        # error with a stop failure
        try:
            prof.stop()
        except Exception:
            pass
        raise
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json"))
