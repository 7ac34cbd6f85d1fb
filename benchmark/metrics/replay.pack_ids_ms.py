"""replay.pack_ids_ms: the ``pack.ids`` span (staging's id pass: client
and parent interning, the id sort and dedup, segments, origins and the
compact sequence block, inside ``pack``), milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["pack.ids"], "replays")
