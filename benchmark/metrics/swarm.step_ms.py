"""swarm.step_ms: the fleet round's ``fleet.step`` span (one upload of
the replica columns and the deletes, the handshake and the union's
converge on the device, one packed fetch), milliseconds a round."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["fleet.step"], "replays")
