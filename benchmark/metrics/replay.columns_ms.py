"""replay.columns_ms: the ``columns`` span (the decoded union turned
into the kernel-facing columns and the merged delete set, between
``decode`` and ``pack``), milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["columns"], "replays")
