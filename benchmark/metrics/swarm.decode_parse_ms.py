"""swarm.decode_parse_ms: the codec's ``decode.parse`` span (the C parse
of every peer's blob into one columnar union, inside ``decode``, the
~9 rows decoded for each distinct one), milliseconds a round."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["decode.parse"], "replays")
