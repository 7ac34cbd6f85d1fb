"""swarm.assemble_ms: the replay assembly's ``gather``, ``materialize``
and ``compact`` spans on the fleet route, milliseconds a round."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(
        r, ["gather", "materialize", "compact"], "replays")
