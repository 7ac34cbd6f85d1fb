"""replay.pack_siblings_ms: the ``pack.siblings`` span (staging's
sibling tables of the sequence forest, with their encode and upload,
inside ``pack``), milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["pack.siblings"], "replays")
