"""replay.decode_parse_ms: the ``decode.parse`` span (the native v1
parse of every blob into one columnar union, inside ``decode``),
milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["decode.parse"], "replays")
