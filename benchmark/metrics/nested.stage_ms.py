"""nested.stage_ms: the staging layer's ``pack`` span (the packed plan
of the workspace's union, its right-origin ranks included),
milliseconds a replay."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["pack"], "replays")
