"""nested.decode_ms: the codec's ``decode`` span (the native v1 decode
and de-duplication of every blob of the workspace's history),
milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["decode"], "replays")
