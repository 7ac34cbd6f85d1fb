"""swarm.decode_dedup_ms: the codec's ``decode.dedup`` span
(``dedup_columns``: the union's redelivered rows dropped, inside
``decode``), milliseconds a round."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["decode.dedup"], "replays")
