"""replay.decode_dedup_ms: the ``decode.dedup`` span (dropping the
duplicate ids of redelivered blobs from the parsed union, inside
``decode``), milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["decode.dedup"], "replays")
