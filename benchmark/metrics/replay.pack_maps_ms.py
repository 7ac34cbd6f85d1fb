"""replay.pack_maps_ms: the ``pack.maps`` span (staging's map block,
grouped by chain parent, with its encode and upload, inside ``pack``),
milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["pack.maps"], "replays")
