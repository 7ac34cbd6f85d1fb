"""replay.pack_rights_ms: the ``pack.rights`` span (staging's
right-origin ranks, inside ``pack``; absent for a union without right
origins), milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["pack.rights"], "replays")
