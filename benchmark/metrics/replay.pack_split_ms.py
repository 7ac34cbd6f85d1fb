"""replay.pack_split_ms: the ``pack.split`` span (staging's subtree and
map-chain split, inside ``pack``; absent where the split is off),
milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["pack.split"], "replays")
