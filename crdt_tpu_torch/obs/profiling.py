"""Device-side profiling hook: the per-dispatch annotation seam.

The port's counterpart of ``crdt_tpu.obs.profiling.device_annotation``:
a ``torch.profiler.record_function`` range, so a ``torch.profiler``
trace attributes each converge dispatch and each streaming shard to
its phase. Outside a profiling session it costs one small object.
"""

from __future__ import annotations

import torch


def device_annotation(name: str):
    """Context manager annotating the enclosed launches in a
    ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)
