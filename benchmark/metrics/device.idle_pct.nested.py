"""device.idle_pct.nested: share of the traced window of the workspace's
replays in which no kernel, copy or set ran on the card, percent."""

from benchmark.harness import readers


def read(r):
    return readers.idle_pct(r)
