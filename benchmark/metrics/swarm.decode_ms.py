"""swarm.decode_ms: the codec's ``decode`` span (the native v1 decode and
de-duplication of every peer's blob into the union), milliseconds a
round. It reads the span ``replay.decode_ms`` reads in the fan-in's
cell, per round of the swarm."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["decode"], "replays")
