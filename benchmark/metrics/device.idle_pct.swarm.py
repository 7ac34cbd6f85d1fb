"""device.idle_pct.swarm: share of the traced window in which no kernel,
copy or set ran on the card, percent."""

from benchmark.harness import readers


def read(r):
    return readers.idle_pct(r)
