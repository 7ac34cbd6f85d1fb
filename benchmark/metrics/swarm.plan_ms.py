"""swarm.plan_ms: the ``fleet.plan`` span (the round's anti-entropy plan
taken from the fetched step and mapped back to client ids),
milliseconds a round. Absent where the program returns no plan."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["fleet.plan"], "replays")
