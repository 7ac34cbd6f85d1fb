"""swarm.load_ms: the fleet route's ``fleet.load`` span (``load_trace``:
each peer's blob decoded again alone, its rows found in the union and
laid out as the [R, N] replica columns), milliseconds a round."""

from benchmark.harness import readers


def read(r):
    return readers.span_ms_per(r, ["fleet.load"], "replays")
